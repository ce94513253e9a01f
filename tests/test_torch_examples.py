"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at a few dozen pixels a side: each asserts its own round trip and returns
0.  They run the kernels' plain versions here; on a GPU, with their
default ``--device cuda``, the kernels."""
from __future__ import annotations

import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
RUNS = {
    "torch_basic_roundtrip": ["--size", "16"],
    "torch_corpus_pipeline": ["--size", "8", "--images", "3"],
    "torch_fault_tolerance": ["--size", "32"],
    "torch_ultrawide_tiling": ["--height", "8", "--width", "48"],
}


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_the_cpu(name, capsys):
    assert load(name).main(["--device", "cpu", *RUNS[name]]) == 0
    assert "exact" in capsys.readouterr().out


def test_examples_default_to_cuda(monkeypatch):
    """Without --device an example asks for CUDA, and without CUDA it
    raises rather than running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in RUNS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load(name).main(RUNS[name])
