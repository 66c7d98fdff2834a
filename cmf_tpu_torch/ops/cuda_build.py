"""Build and load the port's CUDA kernels: ``nvcc`` by hand into shared
libraries with a plain C interface, loaded with ``ctypes``.

Each ``cmf_tpu_torch/csrc/<name>.cu`` becomes ``_build/lib<name>_<hash>.so``,
where the hash is of the source, so an edited source is rebuilt and never
served stale. The build happens at first use, from the checkout's sources
only; ``build`` compiles several sources in parallel, one ``nvcc`` each.
Nothing here runs at import: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS = {}
# name → the compiler's `-Xptxas -v` report (registers, shared memory,
# spills) from the build made by this process, for chip_smoke.py to print.
BUILD_LOGS = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build(names):
    """Compile every stale library among ``names``, all ``nvcc``s at once.
    Raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        # --split-compile=0: the device code's optimisation and ptxas run on
        # every core, so a source of many template instances builds in a
        # third of the time.
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "--split-compile=0", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load_library(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _, out = _target(name)
        if not out.exists():
            build([name])
        _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]
