"""Both CLIs on the four published image square-flow and image-CIF
commands: ``--print-num-params``, ``--print-config`` and ``--print-schema``
byte for byte (no training; the parameter counts at the published widths),
and ``--dataset mnist --model glow --baseline``, which fails in both."""

import contextlib
import io
import sys

import pytest

import main as jax_main
from cmf_tpu_torch.main import main

from _torch_image_square import COMMANDS


@pytest.fixture
def _quiet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)


def _stdout(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


PUBLISHED_PARAMS = {
    "realnvp-mnist-baseline": 5_932_070,
    "realnvp-mnist": 5_988_872,
    "glow-cifar10-baseline": 44_312_832,
    "glow-mnist": 9_731_584,
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_cli_introspection_matches_main_py(name, monkeypatch, _quiet):
    """``--print-num-params``, ``--print-config`` and ``--print-schema`` of
    each published command, byte for byte on stdout against ``main.py``;
    the counts at the published widths."""
    monkeypatch.setenv("CMF_TPU_SYNTHETIC_DATA", "1")
    dataset, model, baseline, _ = COMMANDS[name]
    argv = ["--dataset", dataset, "--model", model] + (["--baseline"] if baseline else [])
    argv += ["--print-num-params", "--print-config", "--print-schema"]
    got = _stdout(main, argv + ["--device", "cpu"])
    assert got == _stdout(jax_main.main, argv)
    assert f"Number of parameters: {PUBLISHED_PARAMS[name]}\n" in got


def test_glow_baseline_on_mnist_fails_as_main_py_does(monkeypatch, _quiet):
    """Three squeezes of 28 pixels: the third asserts 7 % 2 == 0 in both
    packages."""
    monkeypatch.setenv("CMF_TPU_SYNTHETIC_DATA", "1")
    argv = ["--dataset", "mnist", "--model", "glow", "--baseline", "--print-num-params"]
    with pytest.raises(AssertionError):
        main(argv + ["--device", "cpu"])
    with pytest.raises(AssertionError):
        jax_main.main(argv)
