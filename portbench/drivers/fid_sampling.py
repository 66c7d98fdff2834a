"""Traffic ``fid_sampling``: the sampling of a FID pass as
``eval/fid.py::get_fid_function`` draws it, ``num_fid_samples`` samples in
chunks of ``test_batch_size`` through ``sample_batches`` →
``density.sample`` under inference mode, each chunk reduced on the device to
the pass's sums by ``activation_statistics``, whose mean and covariance are
the pass's one host read. The features and the host's matrix root of a FID
are left out: their cost is the FID pass's, not the sampler's.

Set-up builds the density as the CLI does (the schema, ``get_density``,
fp32 pinned), draws its weights and the tail's permutation from the seed
and warms ``warmup_chunks`` chunks. The window runs whole passes until
``--seconds`` have passed. ``check_chunks`` chunks of the window, a
reservoir drawn from the seed, keep their images and the sampling
generator's state before them; once the window has closed the reference
draws the same noise from that state and decodes it. A traced run times
each chunk's call on the host in its window (``sample_enqueue``) and then
profiles ``trace_passes`` passes.
"""

import math
import random
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import compare, weights
from portbench.harness import device as dev


@dataclass
class State:
    cell: object
    density: object
    device: object
    generator: object
    init: list
    perm: object
    chunk: int
    chunks_per_pass: int
    phases: dict = field(default_factory=dict)
    kept: object = None
    kept_states: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)


def setup(cell):
    from cmf_tpu_torch.config import get_schema
    from cmf_tpu_torch.device import pin_fp32, resolve_device
    from cmf_tpu_torch.models import get_density
    from cmf_tpu_torch.nets import set_compute_dtype

    cfg = cell.port_config()
    phases = {"imports": time.perf_counter()}
    device = resolve_device(cell.device_arg)
    pin_fp32()
    set_compute_dtype(cfg.get("compute_dtype", "float32"))
    density = get_density(get_schema(cfg), x_shape=tuple(cell.cfgfile["architecture"]["x_shape"]),
                          device=device, generator=torch.Generator().manual_seed(cell.seed))
    phases["build"] = time.perf_counter()
    gen = torch.Generator(device).manual_seed(cell.seed)
    specs = cell.reference.param_specs(cell.cfgfile)
    init = weights.draw(specs, gen, device)
    weights.load(density, specs, init)
    perm = torch.randperm(cell.reference.permutation_size(cell.cfgfile), generator=gen, device=device)
    weights.set_permutation(density, perm)
    chunk = cfg["test_batch_size"]
    state = State(cell, density, device, gen, init, perm, chunk, max(cfg["num_fid_samples"] // chunk, 1), phases)
    phases["draws"] = time.perf_counter()
    for _ in range(2):
        one_pass(state, cell.traffic["warmup_chunks"])
    phases["warm_chunks"] = time.perf_counter()
    with torch.inference_mode():
        state.kept = torch.empty((cell.traffic["check_chunks"], chunk, *cell.cfgfile["architecture"]["x_shape"]),
                                 device=device)
    dev.synchronize(device)
    return state


def one_pass(state, chunks, tap=None):
    """One pass of ``chunks`` chunks: (mean, covariance) on the host."""
    from cmf_tpu_torch.eval.fid import activation_statistics, sample_batches

    with torch.inference_mode():
        batches = sample_batches(state.density, state.generator, chunks * state.chunk, state.chunk)
        return activation_statistics(batches if tap is None else tap(batches))


class Reservoir:
    """Which chunks of the window keep their images: a uniform sample of
    ``size`` from the seed, decided before each chunk is drawn, with the
    sampling generator's state then; with ``spans``, each chunk's call
    timed on the host."""

    def __init__(self, state, seed, spans):
        self.state, self.rng, self.spans = state, random.Random(seed), spans
        self.seen = 0

    def __call__(self, batches):
        size = self.state.kept.shape[0]
        it = iter(batches)
        while True:
            slot = self.seen if self.seen < size else self.rng.randrange(self.seen + 1)
            keep = slot < size
            if keep:
                gen_state = self.state.generator.get_state()
            t0 = time.perf_counter()
            try:
                x = next(it)
            except StopIteration:
                return
            if self.spans is not None:
                self.spans.append(time.perf_counter() - t0)
            if keep:
                self.state.kept[slot].copy_(x)
                self.state.kept_states[slot] = gen_state
            self.seen += 1
            yield x


def window(state, seconds):
    tap = Reservoir(state, state.cell.seed, state.spans if state.cell.trace else None)
    passes, failed = 0, 0
    t0 = time.perf_counter()
    while True:
        mu, cov = one_pass(state, state.chunks_per_pass, tap)
        passes += 1
        if not (math.isfinite(float(mu.sum())) and math.isfinite(float(cov.sum()))):
            failed += state.chunks_per_pass * state.chunk
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    chunks = passes * state.chunks_per_pass
    return {"setup_end": t0, "window_s": window_s, "units": chunks, "samples": chunks * state.chunk,
            "failed": failed, "enqueue_s": list(state.spans)}


def traced(state):
    n = state.cell.traffic["trace_passes"]

    def passes():
        for _ in range(n):
            one_pass(state, state.chunks_per_pass)

    summary = dev.profiled(passes, n * state.chunks_per_pass, state.device)
    if summary is not None:
        summary["graph_kernels_seen"] = True
    return summary


def release(state):
    state.density = None
    dev.release(state.device)


def check(state):
    """The kept chunks against the reference's decode of the same noise."""
    d = state.cell.cfgfile["config"]["latent_dimension"]
    program, reference = [], []
    for slot in sorted(state.kept_states):
        gen = torch.Generator(state.device)
        gen.set_state(state.kept_states[slot])
        eps = torch.randn((state.chunk, d), generator=gen, device=state.device)
        with torch.no_grad():
            reference.append(state.cell.reference.sample(state.cell.cfgfile, state.init, state.perm, eps))
        program.append(state.kept[slot])
    return compare.sampling(program, reference)


def run(cell):
    state = setup(cell)
    ctx = window(state, cell.seconds)
    ctx["setup_s"] = ctx.pop("setup_end") - cell.start
    ctx["setup_phases"] = state.phases
    peak = dev.memory_peak(state.device)
    ctx["trace"] = traced(state) if cell.trace else None
    ctx["device"] = dev.info(state.device, peak, ctx["trace"])
    ctx["attempted"] = ctx["samples"]
    release(state)
    ctx["numbers"] = check(state)
    return ctx
