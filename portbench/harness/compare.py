"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to a limit of the cell's own
(``limits/<workload>.json``).

Training (the first steps of the object the window then drives):

* ``loss``: the largest relative gap of a step's loss;
* ``grad1``: the first step's gradient, as Adam's first moment holds it
  after that step (μ₁ = (1 − β₁)·g), by the worst leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change``: the same of each leaf's change over the steps, leaving out
  the elements whose first reference gradient is under a thousandth of the
  median leaf's RMS element: Adam moves those by round-off alone (a leaf
  all of whose elements are such, as the latent prior's in a warm-up step,
  goes out whole; so do the innermost coupling's shift and log-scale of
  the coordinates that the tail keeps and its passthrough reads back
  exactly, whose reconstruction gradient is nought).

Sampling: ``sample``, the largest absolute gap of a pixel over the checked
chunks, in the data's own units (0 to 256).
"""

import math

import torch


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def _median(values):
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def leaf_gap(program, reference, keep=None):
    """max over leaves of |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)."""
    p, r = _norms(program), _norms(reference)
    idx = [i for i in range(len(r)) if keep is None or keep[i]]
    floor = _median([r[i] for i in idx])
    gaps = [abs(p[i] - r[i]) / max(r[i], floor) for i in idx]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def training(program, reference, init):
    """{"loss", "grad1", "change"} of the program's first steps against the
    reference's from the same weights and batches."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    rms = [float(torch.sqrt((g.double() ** 2).mean())) for g in reference["grad1"]]
    floor = _median(rms)
    moved = [g.abs() >= 1e-3 * floor for g in reference["grad1"]]
    change_p = [(a - b)[m] for a, b, m in zip(program["params"], init, moved)]
    change_r = [(a - b)[m] for a, b, m in zip(reference["params"], init, moved)]
    return {
        "loss": max(losses) if all(math.isfinite(v) for v in losses) else math.inf,
        "grad1": leaf_gap(program["grad1"], reference["grad1"]),
        "change": leaf_gap(change_p, change_r, [bool(m.any()) for m in moved]),
    }


def sampling(program, reference):
    """{"sample"}: the largest absolute gap over the checked images."""
    gap = max(float((p.double() - r.double()).abs().max()) for p, r in zip(program, reference))
    return {"sample": gap if math.isfinite(gap) else math.inf}


def judged(numbers, limits):
    """[(name, value, limit)] in the limits' order; every number must have
    a limit, and a number passes only at or below it."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return [(name, numbers[name], limit) for name, limit in limits.items() if name in numbers]


def correct(checks):
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
