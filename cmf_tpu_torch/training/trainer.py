"""Training engine, the train-loop subset (``cmf_tpu/training/trainer.py``
in torch).

One step is the JAX package's ``_make_loss_step`` (trainer.py:128-176):
``-mean(elbo)`` under an epoch's objective flags, its gradient, the global
gradient norm and Adam. Where the loss or the norm is not finite, the
parameters, the optimizer state and the floating-point buffers keep what
they held before the step (``_keep``, trainer.py:160-173), by a select on the
device. The step reads nothing on the host: its losses stay on the device
until the epoch ends, when one read fills ``history`` and the epoch raises
``FloatingPointError`` if any loss was not finite (trainer.py:296-302).

Two routes run that one step function. On a CUDA device, where the density
says its step can run in a graph (``Density.step_capturable``: the exact,
Cholesky, log-det, no host read and no random draw), the step is captured in
a CUDA graph per flag key (``_get_step``, trainer.py:178-200), all graphs in
one memory pool: the counterpart of the jitted, scanned epoch. A key's first
step runs eagerly on the capture stream (it builds the kernels and warms
cuBLAS); its second is captured, then replayed; each later step copies the
batch into the graph's input and replays. A capture that fails
raises. The Hutchinson path, whose CG loop reads a flag on the host each
iteration, a dequantized (image) model, which draws its noise, and the CPU
run the step eagerly.

Waiting for a later slice, and refused by ``experiment.setup_experiment``
when a config asks for them: validation (FID-as-validation for tabular
non-square runs), early stopping, checkpoints and the writer. The per-epoch
test pass of a tabular non-square run without FID computes a constant zero
placeholder (experiment.py:213-215) whose only reader is the writer, which
``--nosave`` turns into a no-op; the port does not run it.
"""

import math
import time

import torch

from ..densities.nonsquare import logdet_fallbacks


def elbo_loss(density, x, flags, generator=None, **draws):
    """``-mean(elbo)`` of training batch ``x`` under an epoch's objective
    ``flags``. ``generator`` draws the dequantization noise and the
    Hutchinson probes; ``draws`` may pass them in instead
    (``dequantization_noise``, ``hutchinson_eps``)."""
    info = density.elbo(
        x,
        train=True,
        generator=generator,
        **draws,
        likelihood_wt=flags["likelihood_wt"],
        metric_wt=flags["metric_wt"],
        add_reconstruction=flags["add_reconstruction"],
        add_diagonal_metric_reg=flags["add_diagonal_metric_reg"],
        add_offdiagonal_metric_reg=flags["add_offdiagonal_metric_reg"],
        skip_likelihood=bool(flags["skip_likelihood"]),
    )
    return -info["elbo"].mean()


def _flag_key(flags):
    """The flags a step's program depends on (trainer.py:178-185); the
    weights are inputs."""
    return (
        flags["optimizer_index"],
        bool(flags["skip_likelihood"]),
        bool(flags["add_reconstruction"]),
        bool(flags["add_diagonal_metric_reg"]),
        bool(flags["add_offdiagonal_metric_reg"]),
    )


class _CapturedStep:
    """One flag key's step in a CUDA graph: its input batch and its output
    (loss, grad_norm)."""

    def __init__(self, graph, x, out):
        self.graph, self.x, self.out = graph, x, out

    def __call__(self, x):
        self.x.copy_(x)
        self.graph.replay()
        return self.out.clone().unbind()


def _init_adam_state(optimizer):
    """Adam's state as its first step would make it, made now: the freeze
    then sees the same tensors before and after every step, and a graph
    captures no allocation of it. The count is on the device where Adam
    keeps it there (capturable), else on the host, as torch makes it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                count_device = p.device if group["capturable"] else "cpu"
                state["step"] = torch.zeros((), dtype=torch.float32, device=count_device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


class Trainer:
    def __init__(self, density, objective, optimizer, train_loader, max_epochs, generator=None):
        self.density = density
        # Draws the dequantization noise and the Hutchinson probes; a
        # generator on the device the density lives on.
        self.generator = generator
        self.objective = objective
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.max_epochs = max_epochs
        self.params = [p for p in density.parameters() if p.requires_grad]
        _init_adam_state(optimizer)
        self.epoch = 0
        self.iteration = 0
        # One entry per step taken: (epoch, loss, grad_norm, skip_likelihood).
        self.history = []
        device = self.params[0].device
        # Every parameter's gradient, zero where the loss does not reach it
        # (the latent prior on a warmup step), as under jax.grad: Adam then
        # still decays its moments, where torch would skip the parameter.
        # Made once, so a graph keeps writing the same tensors.
        self._grads = [torch.zeros_like(p) for p in self.params]
        # The objective's weights, filled before each step: a graph reads
        # them, as the jitted epoch takes them as arguments (trainer.py:250).
        self._likelihood_wt = torch.zeros((), device=device)
        self._metric_wt = torch.zeros((), device=device)
        self.captured = device.type == "cuda" and density.step_capturable
        # flag key and batch shape → None after the key's eager first step,
        # then its _CapturedStep.
        self.graphs = {}
        if self.captured:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
            print("train step: captured, one CUDA graph replay a step (exact log-det on the card)",
                  flush=True)
        else:
            why = "the CPU" if device.type != "cuda" else "the step reads the host or draws noise"
            print(f"train step: eager ({why})", flush=True)

    def step(self, x, flags):
        """One optimizer step by this trainer's route. Returns (loss,
        grad_norm) as 0-dim device tensors; nothing is read on the host."""
        self._prepare(flags)
        if not self.captured:
            return self._step_fn(x, flags)
        key = _flag_key(flags) + (tuple(x.shape),)
        if key not in self.graphs:
            self.graphs[key] = None
            return self._on_capture_stream(x, flags)
        if self.graphs[key] is None:
            self.graphs[key] = self._capture(x, flags)
        return self.graphs[key](x)

    def eager_step(self, x, flags):
        """The same step, run eagerly whatever the route."""
        self._prepare(flags)
        return self._step_fn(x, flags)

    def _prepare(self, flags):
        self._likelihood_wt.fill_(flags["likelihood_wt"])
        self._metric_wt.fill_(flags["metric_wt"])
        for p, g in zip(self.params, self._grads):
            if p.grad is not g:
                p.grad = g

    def _frozen(self):
        """What a non-finite step leaves as it was: the parameters, the
        floating-point buffers, then the optimizer's state (made at init, so
        the same tensors before and after a step)."""
        buffers = [b for b in self.density.buffers() if b.is_floating_point()]
        state = [v for p in self.params for v in self.optimizer.state[p].values() if torch.is_tensor(v)]
        return self.params + buffers + state

    def _step_fn(self, x, flags):
        """The step itself: (loss, grad_norm), 0-dim, on the device."""
        torch._foreach_zero_(self._grads)
        step_flags = {**flags, "likelihood_wt": self._likelihood_wt, "metric_wt": self._metric_wt}
        loss = elbo_loss(self.density, x, step_flags, self.generator)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._grads)))
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            kept = torch.cat([t.reshape(-1) for t in self._frozen()])
        self.optimizer.step()
        with torch.no_grad():
            frozen = self._frozen()
            new = torch.cat([t.reshape(-1) for t in frozen])
            keep = torch.where(ok, new, kept).split([t.numel() for t in frozen])
            torch._foreach_copy_(frozen, [k.view_as(t) for k, t in zip(keep, frozen)])
        return loss, grad_norm

    def _on_capture_stream(self, x, flags):
        """A key's first step, eagerly, on the stream its graph is captured
        on, so what that stream makes lazily (cuBLAS's workspace) exists
        before the capture."""
        current = torch.cuda.current_stream(x.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self._step_fn(x, flags)
        current.wait_stream(self._stream)
        for t in out:
            t.record_stream(current)
        return out

    def _capture(self, x, flags):
        """The step in a CUDA graph. Capture runs nothing: the first replay
        takes the step."""
        static_x = x.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = torch.stack(self._step_fn(static_x, flags))
        return _CapturedStep(graph, static_x, out)

    def train(self):
        while self.epoch < self.max_epochs:
            self.epoch += 1
            self._train_epoch(self.epoch)

    def _train_epoch(self, epoch):
        flags = self.objective.for_epoch(epoch)
        if flags["skip_epoch"]:
            return
        if flags["optimizer_index"] != 0:
            raise NotImplementedError(
                "a second optimizer group (m-flow) waits for a later slice of the port"
            )
        start = time.perf_counter()
        steps = [torch.stack(self.step(x, flags)) for x in self.train_loader]
        # The epoch's host reads: its losses and grad norms, and the count
        # of log-det fallbacks.
        values = torch.stack(steps).tolist()
        fallbacks = logdet_fallbacks()
        skip = bool(flags["skip_likelihood"])
        self.history += [(epoch, loss, norm, skip) for loss, norm in values]
        self.iteration += len(values)
        print(
            f"epoch {epoch}: {len(values)} steps, last loss {values[-1][0]:.6g}, "
            f"likelihood_wt {flags['likelihood_wt']:.3g}, log-det fallbacks so far {fallbacks}, "
            f"{time.perf_counter() - start:.3f} s",
            flush=True,
        )
        if not all(math.isfinite(loss) for loss, _ in values):
            raise FloatingPointError(f"NaN/Inf loss during epoch {epoch}")
