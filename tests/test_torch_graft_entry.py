"""llcomp_tpu_torch.graft_entry: entry()'s streams against llcomp_tpu.oracle,
dryrun_multichip on lists of CPU entries, and no CPU fallback without a
GPU.  Tolerance: exact."""
from __future__ import annotations

import pytest
import torch

from llcomp_tpu import oracle
from llcomp_tpu_torch import graft_entry, parallel


def test_entry_streams_equal_the_oracle():
    fn, args = graft_entry.entry(device="cpu")
    (lanes,) = args
    assert lanes.shape == (8, 16, 16, 3) and lanes.dtype == torch.uint8
    out, lens = fn(*args)
    assert out.shape[0] == lens.shape[0] == 8
    for s in range(8):
        want = oracle.encode(lanes[s].numpy())[6:]
        assert out[s, : lens[s]].numpy().tobytes() == want


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_cpu_entries(n, capsys):
    graft_entry.dryrun_multichip(n, mesh=["cpu"] * n)
    assert f"dryrun_multichip({n})" in capsys.readouterr().out


def test_dryrun_multichip_refuses_a_mesh_of_another_size():
    with pytest.raises(ValueError, match="mesh of 3 devices, want 2"):
        graft_entry.dryrun_multichip(2, mesh=["cpu"] * 3)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_no_cpu_fallback_with_too_few_gpus(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n - 1)
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA device"):
        parallel.make_mesh(n)
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA device"):
        graft_entry.dryrun_multichip(n)


def test_entry_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
