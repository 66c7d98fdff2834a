"""Import hygiene of the port: ``cmf_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``cmf_tpu``; the CLI without
``--device cpu`` refuses to run where there is no CUDA device; and
``chip_smoke.py`` exits non-zero with no result there."""

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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cmf_tpu", "optax"))
print(len(names), bad)
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMF_TPU")}
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, **kw
    )


def test_port_imports_no_jax_and_no_cmf_tpu():
    proc = _run(["-c", _PROBE])
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 25  # every module of the package was imported
    assert bad == "[]"


def test_cli_without_device_cpu_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    from cmf_tpu_torch.main import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "non-square", "--dataset", "miniboone", "--synthetic-data", "--nosave",
              "--config", "early_stopping=False", "--config", "use_fid=False"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run on it")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert proc.stdout == ""
