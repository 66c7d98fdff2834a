"""The port's run-dir writer (``cmf_tpu_torch/training/writer.py``) against
the JAX package's (``cmf_tpu/training/writer.py``), and the trainer's
checkpoint round trip (``cmf_tpu_torch/training/checkpoint.py``).

TensorBoard is blocked in these tests (importing it pulls in TensorFlow where
that is installed, tens of seconds); a stand-in module checks that the
writer uses it when it imports.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cmf_tpu.training.writer import Writer as JaxWriter
from cmf_tpu_torch.training import DummyWriter, Trainer, Writer, get_objective, make_optimizer
from cmf_tpu_torch.training import writer as writer_module
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.training.checkpoint import make_checkpoint

from _torch_parity import DIM, batch, small_config, small_schema, t


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # A writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def _same_calls(w):
    w.write_scalar("train/loss", 2076.419921875, global_step=10)
    w.write_scalar("train/lr", 1e-4, global_step=10)
    w.write_scalar("valid/loss", np.float32(45.341129), global_step=4)
    w.write_scalar("test/fid", float("inf"), global_step=1)
    w.write_scalar("test/loss", 0, global_step=None)
    w.write_json("config", {"seed": 1, "lr": 1e-4, "hidden": [128, 128], "data_root": None})
    w.write_textfile("test_feature_extractor", "raw-features")
    w.write_numpy("ood", np.arange(6, dtype=np.float32).reshape(3, 2))


def test_artifacts_byte_equal_to_cmf_tpu(tmp_path):
    ours = Writer(str(tmp_path / "ours"), make_subdir=False, tag_group="miniboone", tee=False)
    theirs = JaxWriter(str(tmp_path / "theirs"), make_subdir=False, tag_group="miniboone", tee=False)
    for w in (ours, theirs):
        _same_calls(w)
        w._scalar_file.flush()
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert names == sorted(os.listdir(tmp_path / "ours"))
    assert names == ["config.json", "ood.npy", "scalars.jsonl", "test_feature_extractor.txt"]
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes(), name
    first = (tmp_path / "ours" / "scalars.jsonl").read_text().splitlines()[0]
    assert json.loads(first) == {"tag": "miniboone/train/loss", "value": 2076.419921875, "step": 10}


def test_run_dirs_of_one_second_do_not_collide(tmp_path, monkeypatch):
    monkeypatch.setattr(writer_module.time, "strftime", lambda fmt: "Oct17_04-15-45")
    dirs = [Writer(str(tmp_path), rundir_tail="_x", tee=False).logdir for _ in range(3)]
    assert [os.path.basename(d) for d in dirs] == ["Oct17_04-15-45_x", "Oct17_04-15-45_x_1", "Oct17_04-15-45_x_2"]
    assert all(os.path.isdir(d) for d in dirs)


def test_tee_duplicates_stdout_into_the_run_dir(tmp_path, capsys):
    w = Writer(str(tmp_path), make_subdir=False)
    print("to both")
    print("err too", file=sys.stderr)
    sys.stdout.flush()
    assert (tmp_path / "stdout").read_text() == "to both\n"
    assert (tmp_path / "stderr").read_text() == "err too\n"
    assert w.logdir == str(tmp_path)


def test_tensorboard_used_when_it_imports(tmp_path, monkeypatch):
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, tag, value, global_step=None):
            calls.append((tag, value, global_step))

        def add_text(self, tag, text):
            calls.append((tag, "text"))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=SummaryWriter))
    w = Writer(str(tmp_path), make_subdir=False, tag_group="g", tee=False)
    w.write_scalar("a/b", 3, global_step=7)
    w.write_json("model", {"num_params": 1})
    assert calls == [("init", str(tmp_path)), ("g/a/b", 3.0, 7), ("g/model", "text")]


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    w = Writer(str(tmp_path), make_subdir=False, tee=False)
    w.write_checkpoint("latest", {"epoch": 1, "w": torch.arange(3.0)})
    w.write_checkpoint("latest", {"epoch": 2, "w": torch.arange(4.0)})
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["latest.pt"]  # no .tmp left
    ckpt = w.load_checkpoint("latest")
    assert ckpt["epoch"] == 2 and torch.equal(ckpt["w"], torch.arange(4.0))

    def dies(data, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(writer_module.torch, "save", dies)
    with pytest.raises(OSError):
        w.write_checkpoint("latest", {"epoch": 3})
    assert w.load_checkpoint("latest")["epoch"] == 2  # the last whole one stands
    with pytest.raises(FileNotFoundError):
        w.load_checkpoint("best_valid")


def test_dummy_writer_writes_nothing_but_loads(tmp_path):
    Writer(str(tmp_path), make_subdir=False, tee=False).write_checkpoint("best_valid", {"epoch": 5})
    before = sorted(p.name for p in tmp_path.rglob("*"))
    d = DummyWriter(logdir=str(tmp_path))
    _same_calls(d)
    d.write_checkpoint("latest", {"epoch": 6})
    assert sorted(p.name for p in tmp_path.rglob("*")) == before
    assert d.load_checkpoint("best_valid") == {"epoch": 5}
    with pytest.raises(FileNotFoundError):
        d.load_checkpoint("latest")
    with pytest.raises(FileNotFoundError):
        DummyWriter().load_checkpoint("latest")


def test_orbax_backend_names_the_jax_package(tmp_path):
    """The JAX package's asynchronous backend by its name: the writer saves
    on its worker and reloads the same ``<tag>.pt``; an unknown backend
    raises."""
    w = Writer(str(tmp_path), make_subdir=False, tee=False, checkpoint_backend="orbax")
    w.write_checkpoint("latest", {"epoch": 1, "w": torch.arange(3.0)})
    ckpt = w.load_checkpoint("latest")
    assert ckpt["epoch"] == 1 and torch.equal(ckpt["w"], torch.arange(3.0))
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["latest.pt"]
    with pytest.raises(ValueError, match="unknown checkpoint_backend `zarr'"):
        Writer(str(tmp_path), make_subdir=False, tee=False, checkpoint_backend="zarr")


def _density():
    """The small model, port-only: these tests need no JAX weights."""
    return get_density(small_schema(), x_shape=(DIM,), device="cpu", generator=torch.Generator().manual_seed(3))


def _trainer(density, writer=None, seed=0):
    objective = get_objective(small_config(likelihood_warmup=False))
    return Trainer(density, objective, [make_optimizer({"lr": 1e-3}, density.parameters())], None,
                   max_epochs=1, generator=torch.Generator().manual_seed(seed), writer=writer)


def _all_tensors(trainer):
    state = [v for opt in trainer.optimizers for v in opt.tensors()]
    return list(trainer.density.parameters()) + list(trainer.density.buffers()) + state


def test_checkpoint_round_trip_is_bit_equal_and_in_place(tmp_path):
    """Save after two steps, scramble every tensor, restore: the same bits
    in the same tensors (a CUDA graph holds their addresses)."""
    td = _density()
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    trainer = _trainer(td, writer)
    flags = trainer.objective.for_epoch(1)
    for i in range(2):
        trainer.step(t(batch(16, seed=60 + i)), flags)
    trainer.epoch, trainer.iteration = 4, 2
    trainer.best_valid_loss, trainer.num_bad_valid_epochs = 12.5, 3
    torch.randn(5, generator=trainer.generator)
    saved = [x.detach().clone() for x in _all_tensors(trainer)]
    rng = trainer.generator.get_state()
    trainer._save_checkpoint("latest")

    ckpt = torch.load(tmp_path / "checkpoints" / "latest.pt", weights_only=True)
    assert all(v.device.type == "cpu" for k in ("params", "model_state", "opt_states") for v in ckpt[k].values())
    assert len(ckpt["params"]) + len(ckpt["model_state"]) + len(ckpt["opt_states"]) == len(saved)

    ptrs = [x.data_ptr() for x in _all_tensors(trainer)]
    with torch.no_grad():
        for x in _all_tensors(trainer):
            x.copy_(torch.randint_like(x, 0, 7) if not x.is_floating_point() else torch.randn_like(x))
    trainer.epoch, trainer.iteration, trainer.best_valid_loss, trainer.num_bad_valid_epochs = 0, 0, 1.0, 0
    torch.randn(3, generator=trainer.generator)

    trainer._load_checkpoint("latest")
    assert [x.data_ptr() for x in _all_tensors(trainer)] == ptrs
    for got, want in zip(_all_tensors(trainer), saved):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert (trainer.epoch, trainer.iteration, trainer.best_valid_loss, trainer.num_bad_valid_epochs) == (4, 2, 12.5, 3)
    assert torch.equal(trainer.generator.get_state(), rng)
    assert trainer.restored_from == "latest"


def test_startup_restore_order(tmp_path, capsys):
    """``latest`` first when training, ``best_valid`` first when testing;
    the other one where the first is missing."""
    td = _density()
    writer = Writer(str(tmp_path), make_subdir=False, tee=False)
    trainer = _trainer(td, writer)
    for tag, epoch in (("latest", 7), ("best_valid", 5)):
        trainer.epoch = epoch
        writer.write_checkpoint(tag, make_checkpoint(trainer))
    objective = trainer.objective
    optimizer = lambda: [make_optimizer({"lr": 1e-3}, td.parameters())]  # noqa: E731
    train = Trainer(td, objective, optimizer(), None, 1, writer=writer)
    test = Trainer(td, objective, optimizer(), None, 1, writer=writer, only_testing=True)
    assert (train.restored_from, train.epoch) == ("latest", 7)
    assert (test.restored_from, test.epoch) == ("best_valid", 5)
    os.remove(tmp_path / "checkpoints" / "best_valid.pt")
    fallback = Trainer(td, objective, optimizer(), None, 1, writer=DummyWriter(str(tmp_path)), only_testing=True)
    assert (fallback.restored_from, fallback.epoch) == ("latest", 7)
    assert "Did not find `best_valid' checkpoint." in capsys.readouterr().err
    fresh = Trainer(td, objective, optimizer(), None, 1)
    assert (fresh.restored_from, fresh.epoch) == (None, 0)
