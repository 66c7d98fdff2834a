"""Training engine, the train-loop subset (``cmf_tpu/training/trainer.py``
in torch).

One step is the JAX package's ``_make_loss_step`` (trainer.py:128-176):
``-mean(elbo)`` under an epoch's objective flags, its gradient, the global
gradient norm and the update of the epoch's optimizer,
``optimizers[flags["optimizer_index"]]`` (``training/optim.py``: one for a
CMF run, two under the M-flow split, the reconstruction group on even
engine epochs and the latent prior on odd ones). Where the loss or the norm
is not finite, the parameters, that optimizer's state and the
floating-point buffers (the batch-norm running statistics among them, which
the forward moves) keep what they held before the step (``_keep``,
trainer.py:160-173), by a select on the device. The step reads nothing on
the host: its losses stay on the device until the epoch ends, when one read
fills ``history`` and the epoch raises ``FloatingPointError`` if any loss
was not finite (trainer.py:296-302).

The root is a non-square chain under ``NonSquareObjective``, or a square
flow (``BijectionDensity``) or a CIF (``ELBODensity``) under
``SquareObjective``, whose flags never change: one optimizer, one key.

Two routes run that one step function. On a CUDA device, where the density
says its step can run in a graph (``Density.step_capturable``: the exact,
Cholesky, log-det, the exact-Gram Hutchinson estimate or the M-flow step's
none, a square flow, no host read; no random draw, or only the CIF's u or
the Hutchinson probes, drawn from the trainer's generator, which is then
registered with every graph the trainer captures, so each replay draws
afresh), the step is captured in a CUDA graph per flag key (``_get_step``,
trainer.py:178-200; the key holds the optimizer index), all graphs in one
memory pool: the counterpart of the jitted, scanned epoch. A key's first
step runs eagerly on the capture stream (it builds the kernels and warms
cuBLAS); its second is captured, then replayed; each later step copies the
batch into the graph's input and replays. A capture that fails
raises. The Hutchinson CG path, whose loop reads a flag on the host each
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
each FID reads the host once, and so does a checkpoint's copy to the host
(``timings["checkpoint"]``: that copy and the writer's call, which under
the asynchronous backend returns before the file is written).
Under the passthrough wrapper each evaluation (the validation, the test's
metrics and its FID, the visualiser, the OOD pass) first refreshes the
batch-norm statistics over the stored rows, then puts the training state
back (``evaluating``).
The train telemetry (loss, grad norm, lr every 10 steps) is written from
the epoch's one read; the lr is the epoch's optimizer's schedule on the
host at the global iteration, as the JAX trainer writes it
(trainer.py:292-295). At start-up the trainer restores ``latest``, else
``best_valid`` (``best_valid`` first when only testing), by copying into its
tensors, so the graphs it captures later train the restored state.

Under a mesh (``batch_sharding``, ``parallel.mesh.data_sharding``) every
rank walks the same batches and keeps its rows of each (``batch_split``),
inside which the draws and the batch-global reductions are global; after
``loss.backward()`` one all-reduce a dtype makes the gradients the mean over
the whole world (``all_reduce_gradients``), before the gradient norm, and
the loss is the data group's mean, so the freeze, the logged loss and the
history are global. The collectives are explicit, not
``DistributedDataParallel``: on the card they are NCCL's, enqueued on the
capture stream, so the step stays captured, its all-reduces inside the
replay. An evaluation's sums and counts go through ``psum_stats``; a batch
the data axis does not divide is computed whole on every rank and counted
once. The parameters and buffers are broadcast from rank 0 after the
start-up restore.

With a ``profile_dir``, the first epoch after the first that trains (epoch
2: its steps replay the graphs epoch 1 captured) runs under
``torch.profiler`` (CPU and, on the card, CUDA activities) and its Chrome
trace goes into that folder, once a trainer, as the JAX trainer traces its
first post-compile epoch with ``jax.profiler`` (trainer.py:113-116,255-259).
"""

import math
import os
import sys
import time
from contextlib import contextmanager

import torch

from ..densities import ELBODensity, NonSquareHeadDensity, PassthroughBeforeEvalDensity
from ..densities.nonsquare import logdet_fallbacks
from ..nets import batch_statistics
from ..parallel.mesh import all_reduce_gradients, batch_split, mean_over_data, psum_stats, replicate
from .checkpoint import make_checkpoint, restore_checkpoint
from .writer import DummyWriter

# Telemetry cadence of the train scalars (trainer.py:38-40).
_STEPS_PER_WRITE = 10


class EarlyStop(Exception):
    pass


def elbo_loss(density, x, flags, generator=None, **draws):
    """``-mean(elbo)`` of training batch ``x`` under an epoch's objective
    ``flags``, in training mode: the batch-norm layers normalise by the
    batch and move their running statistics (``batch_statistics``).
    ``generator`` draws the dequantization noise and the Hutchinson probes;
    ``draws`` may pass them in instead (``dequantization_noise``,
    ``hutchinson_eps``)."""
    with batch_statistics(density):
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


def _flat_by_dtype(tensors):
    """One flat copy of ``tensors`` per dtype: {dtype: (indices, flat)}."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return {dt: (idx, torch.cat([tensors[i].reshape(-1) for i in idx])) for dt, idx in groups.items()}


class Trainer:
    def __init__(
        self,
        density,
        objective,
        optimizers,
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
        profile_dir=None,
        batch_sharding=None,   # parallel.mesh.data_sharding(mesh), or None
    ):
        self.density = density
        self.batch_sharding = batch_sharding
        self.mesh = None if batch_sharding is None else batch_sharding.mesh
        # Draws the dequantization noise, the Hutchinson probes, the FID
        # noise and the evaluation closures' elbo samples; a generator on the
        # device the density lives on.
        self.generator = generator
        self.objective = objective
        # One optimizer a group (training/optim.py), its state made at
        # construction: the freeze sees the same tensors before and after
        # every step, and a graph captures no allocation of it.
        self.optimizers = list(optimizers)
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
        self.profile_dir = profile_dir
        # The Chrome trace written, once a trainer.
        self.profile_path = None
        self.params = [p for p in density.parameters() if p.requires_grad]
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
        # still decays its moments.
        # Made once, so a graph keeps writing the same tensors.
        self._grads = [torch.zeros_like(p) for p in self.params]
        # The objective's weights, filled before each step: a graph reads
        # them, as the jitted epoch takes them as arguments (trainer.py:250).
        self._likelihood_wt = torch.zeros((), device=device)
        self._metric_wt = torch.zeros((), device=device)
        self.captured = device.type == "cuda" and density.step_capturable
        # A captured step that draws (the CIF's u, the Hutchinson probes)
        # draws from this generator.
        self._graph_generator = any(
            isinstance(m, ELBODensity)
            or (isinstance(m, NonSquareHeadDensity) and m.log_jacobian_method == "hutch_with_cg")
            for m in density.modules()
        )
        # flag key and batch shape → None after the key's eager first step,
        # then its _CapturedStep.
        self.graphs = {}
        if self.captured:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
            print("train step: captured, one CUDA graph replay a step", flush=True)
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
        if self.mesh is not None:
            replicate(self.mesh, self.density)

    @contextmanager
    def _timed(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            entry = self.timings.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - start

    @contextmanager
    def _profiled(self, epoch):
        """A ``torch.profiler`` trace of this epoch into ``profile_dir``,
        where it is the first traced and not epoch 1."""
        if self.profile_dir is None or self.profile_path is not None or epoch <= 1:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.params[0].is_cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        os.makedirs(self.profile_dir, exist_ok=True)
        self.profile_path = os.path.join(self.profile_dir, f"trace_epoch{epoch}.json")
        prof.export_chrome_trace(self.profile_path)
        print(f"torch.profiler trace of epoch {epoch}: {self.profile_path}", flush=True)

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

    def _frozen(self, optimizer):
        """What a non-finite step of ``optimizer`` leaves as it was: the
        parameters, the floating-point buffers (not the passthrough
        wrapper's rows, which are no buffer and which a step never writes),
        then that optimizer's state (made at init, so the same tensors
        before and after a step)."""
        return self.params + self._state() + optimizer.tensors()

    def _state(self):
        """The density's floating-point buffers: the batch-norm statistics
        among them."""
        return [b for b in self.density.buffers() if b.is_floating_point()]

    def _step_fn(self, x, flags):
        """The step itself: (loss, grad_norm), 0-dim, on the device."""
        optimizer = self.optimizers[flags["optimizer_index"]]
        torch._foreach_zero_(self._grads)
        # Kept before the forward, which moves the batch-norm statistics.
        frozen = self._frozen(optimizer)
        with torch.no_grad():
            kept = _flat_by_dtype(frozen)
        step_flags = {**flags, "likelihood_wt": self._likelihood_wt, "metric_wt": self._metric_wt}
        with batch_split(self.batch_sharding, x) as rows:
            loss = elbo_loss(self.density, rows, step_flags, self.generator)
            loss.backward()
            loss = mean_over_data(loss.detach())
        if self.mesh is not None:
            all_reduce_gradients(self.mesh, self._grads)
        with torch.no_grad():
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._grads)))
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
        optimizer.step()
        with torch.no_grad():
            for idx, new in _flat_by_dtype(frozen).values():
                keep = torch.where(ok, new, kept[new.dtype][1]).split([frozen[i].numel() for i in idx])
                torch._foreach_copy_([frozen[i] for i in idx], [k.view_as(frozen[i]) for k, i in zip(keep, idx)])
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
        if self._graph_generator:
            graph.register_generator_state(self.generator)
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
        with self._timed("train"), self._profiled(epoch):
            start = time.perf_counter()
            steps = [torch.stack(self.step(x, flags)) for x in self.train_loader]
            # The epoch's host reads: its losses and grad norms, and the count
            # of log-det fallbacks.
            values = torch.stack(steps).tolist()
            fallbacks = logdet_fallbacks()
        skip = bool(flags["skip_likelihood"])
        self.history += [(epoch, loss, norm, skip) for loss, norm in values]
        # The reference's every-10-steps scalars, from the epoch's one read
        # (trainer.py:282-296).
        optimizer = self.optimizers[flags["optimizer_index"]]
        for j, (loss, norm) in enumerate(values):
            i = self.iteration + j + 1
            if i % _STEPS_PER_WRITE == 0:
                self.writer.write_scalar("train/loss", loss, global_step=i)
                self.writer.write_scalar("train/grad-norm", norm, global_step=i)
                self.writer.write_scalar("train/lr", float(optimizer.host_rate(i)), global_step=i)
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
    @contextmanager
    def evaluating(self):
        """The state an evaluation sees (``_eval_variables``,
        trainer.py:308-316): under the passthrough wrapper, its refresh over
        the stored rows, with a u drawn from the trainer's generator where
        the model is a CIF; after the block the floating-point buffers (the
        batch-norm statistics) hold the training state again, as the JAX
        package refreshes a copy of its state."""
        if not isinstance(self.density, PassthroughBeforeEvalDensity):
            yield
            return
        state = self._state()
        saved = [b.clone() for b in state]
        with self._timed("refresh"):
            self.density.refresh_state(self.generator)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(state, saved)

    def _fid(self):
        with self._timed("fid"):
            return float(self.fid_function(self.density, self.generator))

    def _run_eval(self, fn, loader):
        """The mean of each of ``fn``'s per-example outputs over ``loader``:
        sums stay where ``fn`` puts them, then one read. Under a mesh the
        sums and counts of the batches split over the data axis go through
        ``psum_stats``; a batch computed whole on every rank counts once."""
        sharding = self.batch_sharding
        # Whether the batch was split → (sums, counts).
        acc = {True: ({}, {}), False: ({}, {})}
        with torch.no_grad():
            for x in loader:
                sums, counts = acc[sharding is not None and sharding.rows(x.shape[0]) is not None]
                with batch_split(sharding, x) as rows:
                    for k, v in fn(self.density, rows, self.generator).items():
                        sums[k] = v.sum() if k not in sums else sums[k] + v.sum()
                        counts[k] = counts.get(k, 0) + v.numel()
        (sums, counts), (whole_sums, whole_counts) = acc[True], acc[False]
        if sums:
            keys = list(sums)
            stacked = torch.stack([sums[k] for k in keys])
            counted = torch.tensor([counts[k] for k in keys], device=stacked.device)
            psum_stats(stacked, counted, self.mesh)
            sums, counts = dict(zip(keys, stacked.unbind())), dict(zip(keys, counted.tolist()))
        for k, v in whole_sums.items():
            sums[k] = v if k not in sums else sums[k] + v
            counts[k] = counts.get(k, 0) + whole_counts[k]
        if not sums:
            return {}
        values = torch.stack(list(sums.values())).tolist()
        return {k: v / counts[k] for k, v in zip(sums, values)}

    def _validate(self, epoch):
        if epoch < self.early_stopping_start_epoch:
            return
        if epoch % self.valid_frequency != 0:
            return

        with self.evaluating():
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
            with self.evaluating():
                results.update(self._run_eval(self.test_metrics_fn, self.test_loader))
        if self.fid_function is not None:
            with self.evaluating():
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
            with self.evaluating():
                self.visualizer.visualize(self.density, epoch)

    def test_ood(self, loader, write_tag):
        """The OOD pass (trainer.py:424-441): each example's likelihood term
        and reconstruction error, under ``torch.no_grad()`` (not inference
        mode: the exact log-det pushes JVP tangents through the decode,
        which the forward-only coupler kernel does not carry); one host read,
        then an (N, 2) ``.npy`` dump through the writer."""
        buffers = {}
        with self.evaluating(), torch.no_grad():
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
