"""The writer's asynchronous checkpoint backend (``checkpoint_backend =
"orbax"``, ``cmf_tpu_torch/training/writer.py``): the same file as the
``pickle`` backend, written on a worker thread after ``write_checkpoint``
returns; one save in flight, drained before every load and at exit; a save
that failed on the worker raises at the next save, at the next load and at
exit. The CLI's run and resume under it end bit-equal to the ``pickle``
backend's, which ``tests/test_torch_default_run.py`` holds to cmf_tpu.

TensorBoard is blocked (importing it pulls in TensorFlow where that is
installed, tens of seconds).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

from cmf_tpu_torch.main import main
from cmf_tpu_torch.training import DummyWriter, Trainer, Writer, get_objective, make_optimizer
from cmf_tpu_torch.training import writer as writer_module
from cmf_tpu_torch.models import get_density
from cmf_tpu_torch.training.checkpoint import make_checkpoint

from _torch_parity import DIM, batch, small_config, small_schema, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30  # every wait on the worker is bounded: a hang fails the test


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # A writer tees stdout and stderr: put them back after each test.
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    yield
    writer_module.wait_for_checkpoints()


def _trainer(seed=0):
    density = get_density(small_schema(), x_shape=(DIM,), device="cpu", generator=torch.Generator().manual_seed(3))
    objective = get_objective(small_config(likelihood_warmup=False))
    trainer = Trainer(density, objective, [make_optimizer({"lr": 1e-3}, density.parameters())], None,
                      max_epochs=1, generator=torch.Generator().manual_seed(seed))
    flags = objective.for_epoch(1)
    for i in range(2):
        trainer.step(t(batch(16, seed=60 + i)), flags)
    trainer.epoch, trainer.iteration = 1, 2
    return trainer


def _live_tensors(trainer):
    state = [v for opt in trainer.optimizers for v in opt.tensors()]
    return list(trainer.density.parameters()) + list(trainer.density.buffers()) + state


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same(got[k], v)
        elif isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def _held_save(monkeypatch):
    """``torch.save`` held until the returned event is set; it records the
    thread it ran on."""
    release, threads = threading.Event(), []
    real = torch.save

    def save(data, path):
        threads.append(threading.current_thread().name)
        assert release.wait(WAIT_S)
        real(data, path)

    monkeypatch.setattr(writer_module.torch, "save", save)
    return release, threads


def test_orbax_file_is_the_pickle_file(tmp_path):
    """The same trainer saved by both backends: both load to the same
    checkpoint, tensor for tensor, and the writer times each write."""
    trainer = _trainer()
    data = make_checkpoint(trainer)
    writers = {b: Writer(str(tmp_path / b), make_subdir=False, tee=False, checkpoint_backend=b)
               for b in ("pickle", "orbax")}
    for w in writers.values():
        w.write_checkpoint("latest", data)
    loaded = {b: w.load_checkpoint("latest") for b, w in writers.items()}
    _assert_same(loaded["orbax"], loaded["pickle"])
    _assert_same(loaded["orbax"], data)
    assert sorted(os.listdir(tmp_path / "orbax" / "checkpoints")) == ["latest.pt"]
    assert [w.timings["write"][0] for w in writers.values()] == [1, 1]


def test_write_returns_before_the_file_and_keeps_the_state_it_was_given(tmp_path, monkeypatch):
    """``write_checkpoint`` returns while the worker is held; the trainer
    then moves every tensor and its generator, and the file written after
    that holds the state from before. No tensor of the payload shares
    memory with live state."""
    trainer = _trainer()
    data = make_checkpoint(trainer)
    live = {x.untyped_storage().data_ptr() for x in _live_tensors(trainer)}
    live.add(trainer.generator.get_state().untyped_storage().data_ptr())
    payload = [v for k in ("params", "model_state", "opt_states") for v in data[k].values()] + [data["rng"]]
    assert not live & {v.untyped_storage().data_ptr() for v in payload}
    want = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in data.items() if k not in
            ("params", "model_state", "opt_states")}
    want.update({k: {n: v.clone() for n, v in data[k].items()} for k in ("params", "model_state", "opt_states")})

    release, threads = _held_save(monkeypatch)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False, checkpoint_backend="orbax")
    writer.write_checkpoint("latest", data)
    assert not os.path.exists(tmp_path / "checkpoints" / "latest.pt")
    with torch.no_grad():
        for x in _live_tensors(trainer):
            x.add_(1)
    torch.randn(4, generator=trainer.generator)
    release.set()
    writer_module.wait_for_checkpoints()
    assert threads and all(name.startswith("cmf-ckpt") for name in threads)
    _assert_same(torch.load(tmp_path / "checkpoints" / "latest.pt", weights_only=True), want)


def test_a_load_drains_the_pending_save(tmp_path, monkeypatch):
    """A load while the worker holds the only save of ``latest`` waits for
    it, through the writer and through a ``DummyWriter``."""
    release, _ = _held_save(monkeypatch)
    writer = Writer(str(tmp_path), make_subdir=False, tee=False, checkpoint_backend="orbax")
    for epoch, load in ((1, writer.load_checkpoint), (2, DummyWriter(str(tmp_path)).load_checkpoint)):
        release.clear()
        writer.write_checkpoint("latest", {"epoch": epoch, "w": torch.arange(3.0) + epoch})
        timer = threading.Timer(0.2, release.set)
        timer.start()
        got = load("latest")
        timer.join(WAIT_S)
        assert got["epoch"] == epoch and torch.equal(got["w"], torch.arange(3.0) + epoch)


def test_a_failed_save_raises_at_the_next_save_and_at_the_load(tmp_path, monkeypatch):
    """The worker's error comes back at the next ``write_checkpoint`` (which
    then writes nothing) and at the next load; the last whole checkpoint
    stands and loads."""
    writer = Writer(str(tmp_path), make_subdir=False, tee=False, checkpoint_backend="orbax")
    writer.write_checkpoint("latest", {"epoch": 1})
    assert writer.load_checkpoint("latest") == {"epoch": 1}

    def dies(data, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(writer_module.torch, "save", dies)
    writer.write_checkpoint("latest", {"epoch": 2})  # returns: the worker fails later
    with pytest.raises(OSError, match="disk full"):
        writer.write_checkpoint("best_valid", {"epoch": 2})
    writer.write_checkpoint("latest", {"epoch": 3})
    with pytest.raises(OSError, match="disk full"):
        writer.load_checkpoint("latest")
    assert writer.load_checkpoint("latest") == {"epoch": 1}
    assert not os.path.exists(tmp_path / "checkpoints" / "best_valid.pt")


def test_concurrent_saves_lose_no_failure(tmp_path, monkeypatch):
    """More threads than cores save through their own writers at once, every
    save failing on the worker: each failure is raised exactly once, at a
    later save of some thread or at the final drain (a save whose pending
    slot another thread overwrote would never raise)."""
    def dies(data, path):
        raise OSError("disk full")

    monkeypatch.setattr(writer_module.torch, "save", dies)
    counts, lock = {"submitted": 0, "raised": 0}, threading.Lock()

    def saves(i):
        w = Writer(str(tmp_path / str(i)), make_subdir=False, tee=False, checkpoint_backend="orbax")
        for k in range(20):
            try:
                w.write_checkpoint("latest", {"k": k})
                outcome = "submitted"
            except OSError:
                outcome = "raised"
            with lock:
                counts[outcome] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saves, args=(i,)) for i in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        writer_module.wait_for_checkpoints()
    except OSError:
        counts["raised"] += 1
    assert counts["raised"] == counts["submitted"] > 1


_EXITS_AT_ONCE = """
    import sys
    sys.modules["torch.utils.tensorboard"] = None
    import torch
    from cmf_tpu_torch.training import writer
    if sys.argv[2] == "fails":
        def dies(data, path):
            raise OSError("disk full")
        torch.save = dies
    w = writer.Writer(sys.argv[1], make_subdir=False, tee=False, checkpoint_backend="orbax")
    w.write_checkpoint("latest", {"epoch": 4, "w": torch.arange(4_000_000, dtype=torch.float32)})
"""


@pytest.mark.parametrize("outcome", ["written", "fails"])
def test_exit_drains_the_pending_save(tmp_path, outcome):
    """A process that saves and exits at once leaves the whole file; where
    the worker's save fails, the process exits with status 1 and says
    so."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(_EXITS_AT_ONCE), str(tmp_path), outcome],
                          env=env, capture_output=True, text=True, timeout=120)
    if outcome == "written":
        assert done.returncode == 0, done.stderr
        got = torch.load(tmp_path / "checkpoints" / "latest.pt", weights_only=True)
        assert got["epoch"] == 4 and torch.equal(got["w"], torch.arange(4_000_000, dtype=torch.float32))
    else:
        assert done.returncode == 1
        assert "OSError: disk full" in done.stderr and "exiting with status 1" in done.stderr
        assert not os.path.exists(tmp_path / "checkpoints" / "latest.pt")


CLI = ["--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--device", "cpu",
       "--config", "max_epochs=2", "--config", "max_dataset_size=120", "--config", "train_batch_size=40",
       "--config", "likelihood_warmup=False", "--config", "num_fid_samples=100", "--config", "test_batch_size=500",
       "--config", "seed=1", "--config", "num_density_layers=2", "--config", "coupler_hidden_channels=[16]",
       "--config", "prior_num_density_layers=2", "--config", "prior_hidden_channels=[8]",
       "--config", "latent_dimension=5"]


def test_cli_run_and_resume_under_orbax_equal_pickle(tmp_path):
    """The same small CLI run under each backend, then ``--resume`` for one
    more epoch: ``latest`` and ``best_valid`` equal tensor for tensor after
    each."""
    run_dirs = {}
    for backend in ("pickle", "orbax"):
        (setup,) = main(CLI + ["--logdir-root", str(tmp_path / backend), "--config", f"checkpoint_backend={backend}"])
        run_dirs[backend] = setup["writer"].logdir
    for resume in (False, True):
        if resume:
            for run_dir in run_dirs.values():
                with open(os.path.join(run_dir, "config.json")) as f:
                    config = json.load(f)
                config["max_epochs"] = 3
                with open(os.path.join(run_dir, "config.json"), "w") as f:
                    json.dump(config, f)
                (resumed,) = main(["--resume", run_dir, "--device", "cpu"])
                assert resumed["trainer"].restored_from == "latest" and resumed["trainer"].epoch == 3
        writer_module.wait_for_checkpoints()
        for tag in ("latest", "best_valid"):
            got, want = (torch.load(os.path.join(run_dirs[b], "checkpoints", f"{tag}.pt"), weights_only=True)
                         for b in ("orbax", "pickle"))
            if tag == "latest":
                assert got["epoch"] == (3 if resume else 2)
            _assert_same(got, want)
