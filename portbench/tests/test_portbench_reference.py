"""The plain reference held to cmf_tpu_torch at small widths on the CPU,
so that a fault in the reference shows before any chip time: the training
cells' first steps and the sampling cell's images, on the same weights."""

import pytest
import torch

from portbench.harness.cell import BENCH_DIR, load_module
from portbench.reference import flows
from portbench.tests import small


@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup"])
def test_training_steps_agree(workload):
    cell = small.cell(workload)
    driver = load_module(BENCH_DIR / "drivers" / "train_epochs.py", "train_driver")
    state = driver.setup(cell)
    numbers = driver.check(state)
    # Both fp32 on the CPU, from the same weights and rows: sums in other
    # orders, a tenth of the cells' limits at most.
    assert numbers["loss"] < 2e-6 and numbers["grad1"] < 1e-6 and numbers["change"] < 2e-6, numbers


def test_sampling_agrees():
    cell = small.cell("mnist-fid-sample")
    driver = load_module(BENCH_DIR / "drivers" / "fid_sampling.py", "sample_driver")
    state = driver.setup(cell)
    driver.window(state, 0.2)
    assert len(state.kept_states) == cell.traffic["check_chunks"]
    numbers = driver.check(state)
    # The pixels run over (0, 256); the coupler kernel's plain version sums its taps in another order.
    assert numbers["sample"] < 1e-3, numbers


def test_round_tf32():
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 4, -(one + 3 * ulp / 2), 3.0e-8])
    got = flows.round_tf32(x)
    # ties to even: 1 + ulp/2 → 1, 1 + 3ulp/2 → 1 + 2ulp; below half → down
    assert got.tolist() == [one, one + 2 * ulp, one, -(one + 2 * ulp), pytest.approx(3.0e-8, rel=2**-10)]
    assert (flows.round_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()


def test_tf32_matmul_gradient_rounds_its_operands():
    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    flows.TF32.mm(a, b).sum().backward()
    ones = torch.ones(5, 3)
    assert torch.equal(a.grad, ones @ flows.round_tf32(b).T)
    assert torch.equal(b.grad, flows.round_tf32(a).T @ ones)
