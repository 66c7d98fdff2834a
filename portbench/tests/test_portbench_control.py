"""The control: the plain reference in TF32, put in the program's place,
comes out not correct against the same reference in fp32, under the
cells' own limits. On the CPU at small widths; on the card at the cells'
own sizes (``card``)."""

import pytest
import torch

from portbench.harness import compare, data, weights
from portbench.harness.cell import load_cell
from portbench.reference import flows
from portbench.tests import small

SEEDS = [2**31 + 5, 2**31 + 6, 2**31 + 7]


def _training(cell, device):
    gen = torch.Generator(device).manual_seed(cell.seed)
    ref, cfg = cell.reference, cell.cfgfile["config"]
    init = weights.draw(ref.param_specs(cell.cfgfile), gen, device)
    perm = torch.randperm(ref.permutation_size(cell.cfgfile), generator=gen, device=device)
    rows = data.tabular_mixture(3 * cfg["train_batch_size"], perm.numel(), gen, device)
    batches = list(rows.split(cfg["train_batch_size"]))
    flags = {"skip_likelihood": cell.traffic["skip_likelihood"], "likelihood_wt": 0.0 if cell.traffic["skip_likelihood"] else 1.0}
    fp32 = ref.train_steps(cell.cfgfile, init, perm, batches, flags)
    tf32 = ref.train_steps(cell.cfgfile, init, perm, batches, flags, arith=flows.TF32)
    return compare.training(tf32, fp32, init)


def _sampling(cell, device):
    gen = torch.Generator(device).manual_seed(cell.seed)
    ref, cfg = cell.reference, cell.cfgfile["config"]
    init = weights.draw(ref.param_specs(cell.cfgfile), gen, device)
    perm = torch.randperm(ref.permutation_size(cell.cfgfile), generator=gen, device=device)
    eps = torch.randn((cfg["test_batch_size"], cfg["latent_dimension"]), generator=gen, device=device)
    with torch.no_grad():
        return compare.sampling([ref.sample(cell.cfgfile, init, perm, eps, arith=flows.TF32)],
                                [ref.sample(cell.cfgfile, init, perm, eps)])


def _fails(cell, device):
    fn = _sampling if cell.traffic["driver"] == "fid_sampling" else _training
    return not compare.correct(compare.judged(fn(cell, device), cell.limits))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup", "mnist-fid-sample"])
def test_control_fails_at_small_widths(workload, seed):
    cell = small.cell(workload, seed=seed)
    if workload == "mnist-fid-sample":
        cell.cfgfile["config"]["test_batch_size"] = 16
    assert _fails(cell, torch.device("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup", "mnist-fid-sample"])
def test_control_fails_at_the_cells_size(workload, seed, card):
    cell = load_cell(small.bench(), workload, seed, 1.0, False)
    assert _fails(cell, card)
