"""Run-dir writer (``cmf_tpu/training/writer.py`` in torch): scalars,
json/text/numpy artifacts, atomic checkpoints.

As the JAX package's writer: timestamped run dirs, with a numbered suffix
for launches in the same second; ``<group>/<tag>`` scalars, one JSON line
each in ``scalars.jsonl`` (the same bytes for the same calls), and to
TensorBoard if ``torch.utils.tensorboard`` imports; stdout and stderr teed
into the run dir; a ``DummyWriter`` that writes nothing but still loads
checkpoints from ``logdir``.

Checkpoints are torch-native: ``torch.save`` of a dict whose tensors all lie
on the CPU, so a checkpoint loads on any device, written to a tmp file and
then moved into place with ``os.replace``. The JAX package's ``pickle``
backend maps to this format; its ``orbax`` backend has no counterpart.
"""

import json
import os
import sys
import time

import torch


def check_checkpoint_backend(backend):
    if backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend `orbax' is the JAX package's backend (orbax); the port writes "
            "torch-native checkpoints: use `pickle', its default"
        )
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint_backend `{backend}'")


def _checkpoint_path(checkpoints_dir, tag):
    return os.path.join(checkpoints_dir, f"{tag}.pt")


def _load_checkpoint_from(checkpoints_dir, tag):
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
        """Atomic: a tmp file, then ``os.replace``."""
        os.makedirs(self._checkpoints_dir, exist_ok=True)
        final_path = _checkpoint_path(self._checkpoints_dir, tag)
        tmp_path = final_path + ".tmp"
        torch.save(data, tmp_path)
        os.replace(tmp_path, final_path)

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
