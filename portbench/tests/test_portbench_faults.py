"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on
the CPU at small widths, once sound and once for each fault a cell can
have (one chip: no exchange between chips to leave out)."""

import pytest
import torch

from portbench.harness.cell import run_cell
from portbench.tests import small


def _result(workload):
    result, _, _ = run_cell(small.bench(), small.cell(workload))
    return result


@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup", "mnist-fid-sample"])
def test_sound_run_is_correct(workload):
    result = _result(workload)
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == list(small.cell(workload).limits)


@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup"])
def test_step_that_leaves_the_state_unchanged(workload, monkeypatch):
    from cmf_tpu_torch.training import optim

    monkeypatch.setattr(optim.GroupOptimizer, "step", lambda self: None)
    assert not _result(workload)["correct"]


@pytest.mark.parametrize("workload", ["miniboone-train", "miniboone-warmup"])
def test_half_the_batch_left_out(workload, monkeypatch):
    from cmf_tpu_torch.training import trainer

    whole = trainer.elbo_loss
    monkeypatch.setattr(trainer, "elbo_loss", lambda density, x, *a, **k: whole(density, x[: x.shape[0] // 2], *a, **k))
    assert not _result(workload)["correct"]


def test_answer_altered_where_it_is_produced(monkeypatch):
    from cmf_tpu_torch.densities import base

    draw = base.Density.sample

    def swapped(self, num_samples, generator=None):
        x = draw(self, num_samples, generator)
        return x[torch.tensor([1, 0, *range(2, x.shape[0])], device=x.device)]

    monkeypatch.setattr(base.Density, "sample", swapped)
    assert not _result("mnist-fid-sample")["correct"]
