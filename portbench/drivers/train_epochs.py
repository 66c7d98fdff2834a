"""Traffic ``train_epochs``: the trainer's epoch loop over the shuffled
training set at the traffic file's ``epoch`` (which sets the objective's
flags: the likelihood's weight, or the warm-up's reconstruction alone), as
``Trainer.train`` calls ``Trainer._train_epoch``, validation, tests and
checkpoints off.

Set-up builds the trainer as the CLI does (``setup_experiment``), draws the
weights, the tail's permutation and the training rows from the seed, and
runs one epoch through ``Trainer.step`` on the trainer's own loader: its
first ``reference_steps`` steps are what the reference follows (the losses,
Adam's first moment after step 1, the parameters after the last), the rest
warm the replayed graph. One more ``_train_epoch`` warms the window's call.
The window runs whole epochs, each ending in the trainer's one host read,
until ``--seconds`` have passed. A traced run then profiles
``trace_steps`` steps and, where the step is captured, ``eager_guard_steps``
eager steps: the captured trace holds the graph's kernels only if it shows
at least half the eager step's device operations.
"""

import itertools
import math
import time
from dataclasses import dataclass

import torch

from portbench.harness import compare, data, weights
from portbench.harness import device as dev


@dataclass
class State:
    cell: object
    trainer: object
    device: object
    flags: dict
    epoch: int
    init: list
    perm: object
    batches: list
    program: dict
    phases: dict


def setup(cell):
    from cmf_tpu_torch.data.loaders import ArrayLoader
    from cmf_tpu_torch.training.experiment import setup_experiment

    cfg = cell.port_config()
    phases = {"imports": time.perf_counter()}
    built = setup_experiment(cfg, write_to_disk=False, device=cell.device_arg)
    phases["build"] = time.perf_counter()
    trainer, density, device = built["trainer"], built["density"], built["device"]
    gen = torch.Generator(device).manual_seed(cell.seed)
    specs = cell.reference.param_specs(cell.cfgfile)
    init = weights.draw(specs, gen, device)
    weights.load(density, specs, init)
    perm = torch.randperm(cell.reference.permutation_size(cell.cfgfile), generator=gen, device=device)
    weights.set_permutation(density, perm)
    dim = math.prod(cell.cfgfile["architecture"]["x_shape"])
    rows = data.tabular_mixture(cell.cfgfile["assumed"]["train_rows"], dim, gen, device)
    trainer.train_loader = ArrayLoader(rows, cfg["train_batch_size"], device, shuffle=True, drop_last=True,
                                       seed=cell.seed)

    phases["draws"] = time.perf_counter()
    epoch = cell.traffic["epoch"]
    flags = trainer.objective.for_epoch(epoch)
    if bool(flags["skip_likelihood"]) != cell.traffic["skip_likelihood"]:
        raise ValueError(f"epoch {epoch} does not give the traffic's skip_likelihood")
    trainer.epoch = epoch
    optimizer = trainer.optimizers[flags["optimizer_index"]]
    k = cell.traffic["reference_steps"]
    batches, losses, grad1, after = [], [], None, None
    for i, x in enumerate(trainer.train_loader):
        loss, _ = trainer.step(x, flags)
        if i < k:
            batches.append(x.clone())
            losses.append(loss)
        if i == 0:
            grad1 = [optimizer.state[p]["mu"] / (1 - cell.reference.ADAM_B1) for p in optimizer.params]
        if i == k - 1:
            after = [p.detach().clone() for p in optimizer.params]
    if after is None:
        raise ValueError(f"an epoch has fewer than the {k} steps the reference follows")
    program = {"losses": torch.stack(losses).tolist(), "grad1": grad1, "params": after}
    phases["first_epoch"] = time.perf_counter()
    trainer._train_epoch(epoch)
    dev.synchronize(device)
    phases["warm_epoch"] = time.perf_counter()
    return State(cell, trainer, device, flags, epoch, init, perm, batches, program, phases)


def window(state, seconds):
    """Whole epochs until ``seconds`` have passed: {"window_s", "units"
    (steps), "samples", "failed" (steps whose loss was not finite)}."""
    trainer = state.trainer
    start = len(trainer.history)
    epochs = 0
    t0 = time.perf_counter()
    while True:
        trainer._train_epoch(state.epoch)
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    losses = [loss for _, loss, _, _ in trainer.history[start:]]
    return {
        "setup_end": t0,
        "window_s": window_s,
        "units": len(losses),
        "samples": len(losses) * trainer.train_loader.batch_size,
        "failed": sum(not math.isfinite(v) for v in losses),
    }


def traced(state):
    """The summary of ``trace_steps`` profiled steps, with whether it holds
    the captured graph's kernels."""
    trainer, flags, traffic = state.trainer, state.flags, state.cell.traffic

    def steps(n, fn):
        def go():
            outs = [torch.stack(fn(x, flags)) for x in itertools.islice(iter(trainer.train_loader), n)]
            torch.stack(outs).tolist()
        return go

    n = traffic["trace_steps"]
    summary = dev.profiled(steps(n, trainer.step), n, state.device)
    if summary is None:
        return None
    summary["graph_kernels_seen"] = True
    if trainer.captured:
        m = traffic["eager_guard_steps"]
        eager = dev.profiled(steps(m, trainer.eager_step), m, state.device)
        summary["eager_device_ops"] = None if eager is None else eager["device_ops"] / m
        summary["graph_kernels_seen"] = (
            eager is not None and summary["device_ops"] / n >= 0.5 * eager["device_ops"] / m
        )
    return summary


def reference_flags(state):
    return {"skip_likelihood": bool(state.flags["skip_likelihood"]),
            "likelihood_wt": float(state.flags["likelihood_wt"])}


def release(state):
    """Free the program's state; what the reference needs stays."""
    state.trainer = None
    dev.release(state.device)


def check(state):
    ref = state.cell.reference.train_steps(state.cell.cfgfile, state.init, state.perm, state.batches,
                                           reference_flags(state))
    return compare.training(state.program, ref, state.init)


def run(cell):
    state = setup(cell)
    ctx = window(state, cell.seconds)
    ctx["setup_s"] = ctx.pop("setup_end") - cell.start
    ctx["setup_phases"] = state.phases
    peak = dev.memory_peak(state.device)
    ctx["trace"] = traced(state) if cell.trace else None
    ctx["device"] = dev.info(state.device, peak, ctx["trace"])
    ctx["attempted"] = ctx["units"]
    ctx["likelihood"] = not state.flags["skip_likelihood"]
    release(state)
    ctx["numbers"] = check(state)
    return ctx
