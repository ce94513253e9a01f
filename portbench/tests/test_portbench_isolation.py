"""What a run may load and where it may run: no JAX and no JAX package,
compared by whole top-level names, and no run without a card."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness


@pytest.mark.parametrize("modules, found", [
    (["llcomp_tpu_torch", "llcomp_tpu_torch.api", "torch"], []),
    (["llcomp_tpu", "llcomp_tpu.oracle"], ["llcomp_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_ish", "llcomp_tpu_tools", "flaxen"], []),
])
def test_whole_name_check(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'portbench/tests');"
        "from conftest import tiny_spec; from portbench import harness;"
        "r, c = harness.measure(tiny_spec('kodak24.restore'), 3, 0.0, False,"
        " 'cpu', log=lambda m: None);"
        "import llcomp_tpu_torch.api, llcomp_tpu_torch.corpus;"
        "assert r['correct'], c;"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("argv", [
    ["portbench/run.py", "--workload", "kodak24.ingest", "--seed",
     "3000000000", "--seconds", "1", "--trace", "0"],
    ["portbench/control.py", "--workload", "kodak24.ingest", "--seed",
     "3000000000"],
], ids=["run", "control"])
def test_refused_without_a_card(argv):
    out = subprocess.run([sys.executable, *argv], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_refused_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.finish({"correct": True}, {}) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jaxlib" in err
