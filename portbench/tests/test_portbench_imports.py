"""Nothing the benchmark loads is JAX or the JAX package, and the plain
references load nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.cell import BENCH_DIR, FORBIDDEN, ROOT, forbidden_modules

REFERENCE_DIR = BENCH_DIR / "reference"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules({"cmf_tpu_torch", "cmf_tpu_torch.ops.gram_logdet", "jaxtyping"}) == []
    assert forbidden_modules({"cmf_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"}) == sorted(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(REFERENCE_DIR.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "cmf_tpu_torch" not in _top_level_imports(path)


PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench.harness.cell import BENCH_DIR, load_module, forbidden_modules
refs = sorted(BENCH_DIR.glob("reference/*.py"))
for p in refs:
    load_module(p, "ref_" + p.stem.replace("-", "_"))
program = sorted({{m.split(".")[0] for m in sys.modules}} & {{"cmf_tpu_torch"}})
for p in sorted(BENCH_DIR.glob("drivers/*.py")) + sorted(BENCH_DIR.glob("metrics/*.py")):
    load_module(p, "mod_" + p.stem.replace("-", "_").replace(".", "_"))
import cmf_tpu_torch.training.experiment, cmf_tpu_torch.eval.fid, cmf_tpu_torch.data.loaders
print(json.dumps({{"program_after_references": program, "forbidden": forbidden_modules()}}))
"""


def test_harness_and_program_load_no_jax():
    """In a fresh process: the references load without the program, and
    the harness with the program's entries loads nothing forbidden."""
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {"program_after_references": [], "forbidden": []}
