"""Import hygiene of the port: ``cmf_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``cmf_tpu``, and importing them builds
no kernel (nor pandas, h5py or matplotlib: the raw loaders, the run
aggregation and the visualisers import them inside their calls); the CLI
without ``--device cpu`` refuses to run where there is no
CUDA device, for the miniboone and the mnist models; and ``chip_smoke.py``
exits non-zero with no result there."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import cmf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cmf_tpu_torch.__path__, "cmf_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from cmf_tpu_torch.ops import cuda_build
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cmf_tpu", "optax"))
built = sorted(cuda_build._LIBS) + sorted(cuda_build.BUILD_LOGS)
print(len(names), "triton" in sys.modules, built, bad)
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMF_TPU")}
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, **kw
    )


def test_port_imports_no_jax_and_no_cmf_tpu():
    proc = _run(["-c", _PROBE])
    assert proc.returncode == 0, proc.stderr
    n, triton, built, bad = proc.stdout.strip().splitlines()[-1].split(" ", 3)
    assert int(n) >= 34  # every module of the package was imported
    assert bad == "[]"
    assert (triton, built) == ("False", "[]")  # nothing built or compiled at import


_PROBE_NEW = """
import importlib, sys
for name in ("cmf_tpu_torch.data.gaussian", "cmf_tpu_torch.data.tabular", "cmf_tpu_torch.parallel",
             "cmf_tpu_torch.parallel.grid", "cmf_tpu_torch.analysis", "cmf_tpu_torch.analysis.collect",
             "cmf_tpu_torch.analysis.__main__"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cmf_tpu", "optax"))
lazy = sorted(m for m in ("pandas", "h5py", "matplotlib") if m in sys.modules)
print(bad, lazy)
"""


def test_loaders_grid_and_aggregation_import_no_jax_pandas_or_h5py():
    """The raw loaders, ``data/gaussian.py``, the grid shard and the run
    aggregation with its command line: no JAX, no ``cmf_tpu``, and pandas,
    h5py and matplotlib only inside the calls that need them."""
    proc = _run(["-c", _PROBE_NEW])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] []"


def _cli_raises_without_a_card(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    from cmf_tpu_torch.main import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "non-square", "--dataset", dataset, "--synthetic-data", "--nosave",
              "--config", "early_stopping=False", "--config", "use_fid=False"])


def test_cli_without_device_cpu_raises_without_a_card():
    _cli_raises_without_a_card("miniboone")


def test_mnist_cli_without_device_cpu_raises_without_a_card():
    _cli_raises_without_a_card("mnist")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run on it")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert proc.stdout == ""
