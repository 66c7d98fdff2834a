"""Run-dir writer (``cmf_tpu/training/writer.py`` in torch): scalars,
json/text/numpy artifacts, atomic checkpoints.

As the JAX package's writer: timestamped run dirs, with a numbered suffix
for launches in the same second; ``<group>/<tag>`` scalars, one JSON line
each in ``scalars.jsonl`` (the same bytes for the same calls), and to
TensorBoard if ``torch.utils.tensorboard`` imports; images to TensorBoard
only, figures to ``<tag>.pdf`` and TensorBoard; stdout and stderr teed
into the run dir; a ``DummyWriter`` that writes nothing but still loads
checkpoints from ``logdir``.

Checkpoints are torch-native: ``torch.save`` of a dict whose tensors all lie
on the CPU, so a checkpoint loads on any device, written to a tmp file and
then moved into place with ``os.replace``. Both of the JAX package's
backends write this one file, ``<tag>.pt``, so a run written under either
resumes under the other:

* ``pickle`` writes it before ``write_checkpoint`` returns;
* ``orbax`` (the JAX package's asynchronous backend) hands it to one worker
  thread and returns, so training goes on while the file is written. The
  payload is already a host copy (``checkpoint.make_checkpoint``), so the
  worker only serialises. One save is in flight per process: the next save,
  every load and the interpreter's exit wait for it first, and a save that
  failed on the worker raises there. A single file replaced atomically
  cannot be torn, so the JAX package's token over its two artifacts has no
  counterpart.

A writer's ``timings["write"]`` is [saves, seconds] of the writes
themselves, on the worker under ``orbax``; the trainer's
``timings["checkpoint"]`` is the part that blocks training (the copy to the
host, and under ``pickle`` the write).
"""

import json
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

CHECKPOINT_BACKENDS = ("pickle", "orbax")


def check_checkpoint_backend(backend):
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"unknown checkpoint_backend `{backend}': one of {', '.join(CHECKPOINT_BACKENDS)}")


class _BackgroundSaves:
    """The process's asynchronous checkpoint writes (``_OrbaxIO``,
    ``cmf_tpu/training/writer.py:20-146``): one worker thread, one save in
    flight. ``wait`` returns once the pending save is on disk, or raises
    its error; the worker and the exit hook start with the first save."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executor = None
        self._pending = None

    def submit(self, job):
        with self._lock:
            self._wait()
            if self._executor is None:
                self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cmf-ckpt")
                # The threading module runs these in reverse order of
                # registration at shutdown, so this drain runs before the
                # executor's own hook (registered when concurrent.futures
                # imported) stops taking work.
                threading._register_atexit(_drain_at_exit)
            self._pending = self._executor.submit(job)

    def wait(self):
        with self._lock:
            self._wait()

    def _wait(self):
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()  # a failed save raises here


_SAVES = _BackgroundSaves()


def _drain_at_exit():
    """The pending save, at the interpreter's exit. A failed one ends the
    process with status 1: raised from this hook, Python would print it
    and exit 0, as if the checkpoint were on disk."""
    try:
        _SAVES.wait()
    except Exception:
        traceback.print_exc()
        print("a checkpoint save failed on the worker thread; exiting with status 1", file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def wait_for_checkpoints():
    """Block until the pending asynchronous save is on disk; raise its
    error if it failed."""
    _SAVES.wait()


def _checkpoint_path(checkpoints_dir, tag):
    return os.path.join(checkpoints_dir, f"{tag}.pt")


def _load_checkpoint_from(checkpoints_dir, tag):
    _SAVES.wait()
    path = _checkpoint_path(checkpoints_dir, tag)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=True)


class Tee:
    """Duplicate a stream into a file."""

    def __init__(self, primary, secondary_path):
        self._primary = primary
        self._secondary = open(secondary_path, "a", buffering=1)

    def write(self, data):
        self._primary.write(data)
        self._secondary.write(data)

    def flush(self):
        self._primary.flush()
        self._secondary.flush()

    def __getattr__(self, name):
        return getattr(self._primary, name)


class Writer:
    def __init__(
        self,
        logdir,
        make_subdir=True,
        tag_group="",
        rundir_tail="",
        tee=True,
        checkpoint_backend="pickle",
    ):
        check_checkpoint_backend(checkpoint_backend)
        self._ckpt_backend = checkpoint_backend
        self.timings = {"write": [0, 0.0]}
        if make_subdir:
            os.makedirs(logdir, exist_ok=True)
            timestamp = time.strftime("%b%d_%H-%M-%S")
            candidate = os.path.join(logdir, timestamp + rundir_tail)
            suffix = 0
            logdir = candidate
            while os.path.exists(logdir):
                suffix += 1
                logdir = f"{candidate}_{suffix}"
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._tag_group = tag_group
        self._scalar_file = open(os.path.join(logdir, "scalars.jsonl"), "a", buffering=1)

        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=logdir)
        except Exception:
            pass

        if tee:
            sys.stdout = Tee(sys.stdout, os.path.join(logdir, "stdout"))
            sys.stderr = Tee(sys.stderr, os.path.join(logdir, "stderr"))

    def _tag(self, tag):
        return f"{self._tag_group}/{tag}" if self._tag_group else tag

    def write_scalar(self, tag, value, global_step=None):
        value = float(value)
        self._scalar_file.write(
            json.dumps({"tag": self._tag(tag), "value": value, "step": global_step}) + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(self._tag(tag), value, global_step=global_step)

    def write_image(self, tag, image_chw, global_step=None):
        if self._tb is not None:
            self._tb.add_image(self._tag(tag), image_chw, global_step=global_step)

    def write_figure(self, tag, figure, global_step=None):
        """A matplotlib figure to ``<tag>.pdf`` in the run dir."""
        figure.savefig(os.path.join(self.logdir, f"{tag.replace('/', '_')}.pdf"))
        if self._tb is not None:
            self._tb.add_figure(self._tag(tag), figure, global_step=global_step)

    def write_json(self, tag, data):
        with open(os.path.join(self.logdir, f"{tag}.json"), "w") as f:
            json.dump(data, f, indent=4)
        if self._tb is not None:
            self._tb.add_text(self._tag(tag), f"```\n{json.dumps(data, indent=4)}\n```")

    def write_textfile(self, tag, text):
        with open(os.path.join(self.logdir, f"{tag}.txt"), "w") as f:
            f.write(text)

    def write_numpy(self, tag, array):
        import numpy as np

        np.save(os.path.join(self.logdir, f"{tag}.npy"), array)

    def write_checkpoint(self, tag, data):
        """Atomic: a tmp file, then ``os.replace``; under ``orbax`` on the
        worker thread, after the pending save. ``data`` must not share
        memory with live state: the worker reads it after this returns."""
        os.makedirs(self._checkpoints_dir, exist_ok=True)
        final_path = _checkpoint_path(self._checkpoints_dir, tag)
        if self._ckpt_backend == "orbax":
            _SAVES.submit(lambda: self._write(final_path, data))
        else:
            self._write(final_path, data)

    def _write(self, final_path, data):
        start = time.perf_counter()
        tmp_path = final_path + ".tmp"
        torch.save(data, tmp_path)
        os.replace(tmp_path, final_path)
        entry = self.timings["write"]
        entry[0] += 1
        entry[1] += time.perf_counter() - start

    def load_checkpoint(self, tag):
        return _load_checkpoint_from(self._checkpoints_dir, tag)

    @property
    def _checkpoints_dir(self):
        return os.path.join(self.logdir, "checkpoints")


class DummyWriter:
    """No-op writes; checkpoint loads still work from ``logdir``."""

    def __init__(self, logdir=None):
        self.logdir = logdir

    def write_scalar(self, tag, value, global_step=None):
        pass

    def write_image(self, tag, image_chw, global_step=None):
        pass

    def write_figure(self, tag, figure, global_step=None):
        pass

    def write_json(self, tag, data):
        pass

    def write_textfile(self, tag, text):
        pass

    def write_numpy(self, tag, array):
        pass

    def write_checkpoint(self, tag, data):
        pass

    def load_checkpoint(self, tag):
        if self.logdir is None:
            raise FileNotFoundError("DummyWriter has no logdir")
        return _load_checkpoint_from(os.path.join(self.logdir, "checkpoints"), tag)
