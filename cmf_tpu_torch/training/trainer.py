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

Around the epochs, as the JAX trainer (trainer.py:230-241, 361-455): after
each epoch, validation when early stopping is on (from
``early_stopping_start_epoch``, every ``valid_frequency`` epochs; the FID
when there is a FID function, else the mean of ``valid_loss_fn`` over the
valid loader), with best/bad-epoch bookkeeping, a ``best_valid`` checkpoint
and ``EarlyStop`` after more than ``max_bad_valid_epochs`` bad epochs; then
the test pass every ``epochs_per_test`` epochs, counted so that it runs
after epochs 1, 1 + epochs_per_test, ..., each followed by the visualiser;
then a ``latest`` checkpoint.
Non-finite losses leave ``nan_during_training`` / ``_validation`` /
``_test`` checkpoints. Both passes run between epochs, outside the graphs;
each FID reads the host once, and so does a checkpoint's copy to the host.
The train telemetry (loss, grad norm, lr every 10 steps) is written from
the epoch's one read. At start-up the trainer restores ``latest``, else
``best_valid`` (``best_valid`` first when only testing), by copying into its
tensors, so the graphs it captures later train the restored state.
"""

import math
import sys
import time
from contextlib import contextmanager

import torch

from ..densities.nonsquare import logdet_fallbacks
from .checkpoint import make_checkpoint, restore_checkpoint
from .writer import DummyWriter

# Telemetry cadence of the train scalars (trainer.py:38-40).
_STEPS_PER_WRITE = 10


class EarlyStop(Exception):
    pass


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
    def __init__(
        self,
        density,
        objective,
        optimizer,
        train_loader,
        max_epochs,
        generator=None,
        valid_loader=None,
        test_loader=None,
        writer=None,
        visualizer=None,
        early_stopping=False,
        max_bad_valid_epochs=0,
        valid_frequency=1,
        epochs_per_test=1,
        valid_loss_fn=None,    # (density, x, generator) -> (B,) losses
        test_metrics_fn=None,  # (density, x, generator) -> {name: (B,) values}
        fid_function=None,     # (density, generator) -> float
        should_checkpoint_latest=True,
        should_checkpoint_best_valid=True,
        only_testing=False,
    ):
        self.density = density
        # Draws the dequantization noise, the Hutchinson probes, the FID
        # noise and the evaluation closures' elbo samples; a generator on the
        # device the density lives on.
        self.generator = generator
        self.objective = objective
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.test_loader = test_loader
        self.writer = writer if writer is not None else DummyWriter()
        self.visualizer = visualizer
        self.max_epochs = max_epochs
        self.early_stopping = early_stopping
        self.early_stopping_start_epoch = objective.early_stopping_start_epoch
        self.max_bad_valid_epochs = max_bad_valid_epochs
        self.valid_frequency = valid_frequency
        self.epochs_per_test = epochs_per_test
        self.valid_loss_fn = valid_loss_fn
        self.test_metrics_fn = test_metrics_fn
        self.fid_function = fid_function
        self.should_checkpoint_latest = should_checkpoint_latest
        self.should_checkpoint_best_valid = should_checkpoint_best_valid
        self.params = [p for p in density.parameters() if p.requires_grad]
        _init_adam_state(optimizer)
        self.best_valid_loss = float("inf")
        self.num_bad_valid_epochs = 0
        self.epoch = 0
        self.iteration = 0
        # One entry per step taken: (epoch, loss, grad_norm, skip_likelihood).
        self.history = []
        # Host-clock seconds by kind of work: name -> [calls, seconds].
        self.timings = {}
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

        # Start-up restore (trainer.py:118-125), before any graph exists.
        self.restored_from = None
        first, second = ("best_valid", "latest") if only_testing else ("latest", "best_valid")
        for tag in (first, second):
            try:
                self._load_checkpoint(tag)
                break
            except FileNotFoundError:
                print(f"Did not find `{tag}' checkpoint.", file=sys.stderr)

    @contextmanager
    def _timed(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            entry = self.timings.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - start

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
        try:
            while self.epoch < self.max_epochs:
                self.epoch += 1
                self._train_epoch(self.epoch)
                if self.early_stopping:
                    self._validate(self.epoch)
                self._test_and_log(self.epoch)
                if self.should_checkpoint_latest:
                    self._save_checkpoint("latest")
        except EarlyStop:
            pass

    def _train_epoch(self, epoch):
        flags = self.objective.for_epoch(epoch)
        if flags["skip_epoch"]:
            return
        if flags["optimizer_index"] != 0:
            raise NotImplementedError(
                "a second optimizer group (m-flow) waits for a later slice of the port"
            )
        with self._timed("train"):
            start = time.perf_counter()
            steps = [torch.stack(self.step(x, flags)) for x in self.train_loader]
            # The epoch's host reads: its losses and grad norms, and the count
            # of log-det fallbacks.
            values = torch.stack(steps).tolist()
            fallbacks = logdet_fallbacks()
        skip = bool(flags["skip_likelihood"])
        self.history += [(epoch, loss, norm, skip) for loss, norm in values]
        # The reference's every-10-steps scalars, from the epoch's one read
        # (trainer.py:282-296). The learning rate is constant.
        lr = self.optimizer.param_groups[0]["lr"]
        for j, (loss, norm) in enumerate(values):
            i = self.iteration + j + 1
            if i % _STEPS_PER_WRITE == 0:
                self.writer.write_scalar("train/loss", loss, global_step=i)
                self.writer.write_scalar("train/grad-norm", norm, global_step=i)
                self.writer.write_scalar("train/lr", lr, global_step=i)
        self.iteration += len(values)
        print(
            f"epoch {epoch}: {len(values)} steps, last loss {values[-1][0]:.6g}, "
            f"likelihood_wt {flags['likelihood_wt']:.3g}, log-det fallbacks so far {fallbacks}, "
            f"{time.perf_counter() - start:.3f} s",
            flush=True,
        )
        if not all(math.isfinite(loss) for loss, _ in values):
            # The freeze kept the last finite state: checkpoint it.
            self._save_checkpoint("nan_during_training")
            raise FloatingPointError(f"NaN/Inf loss during epoch {epoch}")

    # ------------------------------------------------------------ evaluation
    def _fid(self):
        with self._timed("fid"):
            return float(self.fid_function(self.density, self.generator))

    def _run_eval(self, fn, loader):
        """The mean of each of ``fn``'s per-example outputs over ``loader``:
        sums stay where ``fn`` puts them, then one read."""
        sums, counts = {}, {}
        with torch.no_grad():
            for x in loader:
                for k, v in fn(self.density, x, self.generator).items():
                    sums[k] = v.sum() if k not in sums else sums[k] + v.sum()
                    counts[k] = counts.get(k, 0) + v.numel()
        if not sums:
            return {}
        values = torch.stack(list(sums.values())).tolist()
        return {k: v / counts[k] for k, v in zip(sums, values)}

    def _validate(self, epoch):
        if epoch < self.early_stopping_start_epoch:
            return
        if epoch % self.valid_frequency != 0:
            return

        if self.fid_function is not None:
            # FID stands in for the validation loss (trainer.py:367-371).
            valid_loss = self._fid()
        else:
            valid_loss = self._run_eval(
                lambda d, x, g: {"loss": self.valid_loss_fn(d, x, g)}, self.valid_loader
            )["loss"]

        self.writer.write_scalar("valid/loss", valid_loss, global_step=epoch)

        if valid_loss < self.best_valid_loss:
            print(f"Best validation loss {valid_loss} after epoch {epoch}")
            self.num_bad_valid_epochs = 0
            self.best_valid_loss = valid_loss
            if self.should_checkpoint_best_valid:
                self._save_checkpoint("best_valid")
        else:
            if not math.isfinite(valid_loss):
                self._save_checkpoint("nan_during_validation")
            self.num_bad_valid_epochs += 1
            if self.num_bad_valid_epochs > self.max_bad_valid_epochs:
                print(
                    f"No validation improvement after {self.num_bad_valid_epochs} epochs. Terminating."
                )
                raise EarlyStop

    def test(self):
        """The test pass; with a FID function, its score, the feature
        extractor and any sqrtm jitter it needed (trainer.py:398-422)."""
        results = {}
        if self.test_metrics_fn is not None:
            results.update(self._run_eval(self.test_metrics_fn, self.test_loader))
        if self.fid_function is not None:
            results["fid"] = self._fid()
            results["feature_extractor"] = getattr(self.fid_function, "feature_extractor", "unknown")
            jitter = getattr(self.fid_function, "last_jitter", None)
            if jitter:
                results["fid_sqrtm_jitter"] = float(jitter)
        return results

    def _test_and_log(self, epoch):
        if (epoch - 1) % self.epochs_per_test != 0:
            return
        for k, v in self.test().items():
            if isinstance(v, str):  # provenance stamps are not scalars
                self.writer.write_textfile(f"test_{k}", v)
                continue
            self.writer.write_scalar(f"test/{k}", v, global_step=epoch)
            if not math.isfinite(v):
                self._save_checkpoint("nan_during_test")
        if self.visualizer is not None:
            self.visualizer.visualize(self.density, epoch)

    def test_ood(self, loader, write_tag):
        """The OOD pass (trainer.py:424-441): each example's likelihood term
        and reconstruction error, under ``torch.no_grad()`` (not inference
        mode: the exact log-det pushes JVP tangents through the decode,
        which the forward-only coupler kernel does not carry); one host read,
        then an (N, 2) ``.npy`` dump through the writer."""
        buffers = {}
        with torch.no_grad():
            for x in loader:
                for k, v in self.density.ood(x).items():
                    buffers.setdefault(k, []).append(v)
        likelihoods = torch.cat(buffers["likelihood"])
        recon = torch.cat(buffers["reconstruction-error"])
        arr = torch.stack([likelihoods, recon], dim=1).cpu().numpy()
        self.writer.write_numpy(write_tag, arr)
        return arr

    # ---------------------------------------------------------- checkpoints
    def _save_checkpoint(self, tag):
        if isinstance(self.writer, DummyWriter):
            return  # it would drop the copy
        with self._timed("checkpoint"):
            self.writer.write_checkpoint(tag, make_checkpoint(self))

    def _load_checkpoint(self, tag):
        ckpt = self.writer.load_checkpoint(tag)
        restore_checkpoint(self, ckpt)
        self.restored_from = tag
        print(f"Loaded checkpoint `{tag}' after epoch {ckpt['epoch']}", file=sys.stderr)
