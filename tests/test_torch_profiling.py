"""llcomp_tpu_torch.profiling against llcomp_tpu.profiling: the phase
timer's report on the same calls, labels in torch.profiler sessions and in
trace_to's file, LLCT_PROFILE read on every call, and the lane loops'
stage labels on the CPU."""
from __future__ import annotations

import itertools
import json
import time

import numpy as np
import pytest
import torch

from llcomp_tpu import profiling as jprof
from llcomp_tpu_torch import decode, encode, profiling
from tests.conftest import make_photo

FUSED = ["encode/download", "encode/fused_kernel", "encode/precompute",
         "encode/upload"]
SORT = ["encode/coder", "encode/compact_sort", "encode/download",
        "encode/finish", "encode/precompute", "encode/sym_sort",
        "encode/upload", "encode/walk"]
DECODE = ["decode/download", "decode/kernel", "decode/upload"]


def _empty(timer: profiling.PhaseTimer) -> profiling.PhaseTimer:
    timer.totals.clear()
    timer.counts.clear()
    return timer


@pytest.fixture
def stages():
    """The process's stage timer, emptied before and after the test."""
    yield _empty(profiling.stages)
    _empty(profiling.stages)


def test_phase_timer_report_equals_the_jax_timer(monkeypatch):
    """The same calls on a clock that steps 0.00123 s a reading."""
    reports = []
    for timer in (profiling.PhaseTimer(), jprof.PhaseTimer()):
        clock = itertools.count()
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(clock) * 0.00123)
        for phase in ("enc", "dec", "enc", "crc", "enc"):
            with timer(phase):
                pass
        with pytest.raises(KeyError), timer("dec"):
            raise KeyError("a phase that raises is still timed")
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert reports[0]["enc"] == {"total_s": 0.0037, "calls": 3}


def test_annotate_names_a_region_in_a_cpu_profiler_session():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("encode-step"):
            torch.ones(4).sum()
    assert "encode-step" in {e.key for e in prof.key_averages()}


def test_trace_to_writes_a_chrome_trace_with_the_labels(tmp_path,
                                                        monkeypatch):
    monkeypatch.delenv("LLCT_PROFILE", raising=False)
    with profiling.trace_to(tmp_path / "trace") as path:
        with profiling.annotate("outer-label"):
            profiling.timed("stage/inner", torch.ones(8).cumsum, 0)
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"outer-label", "stage/inner"} <= names
    assert path.parent == tmp_path / "trace"


def test_timed_records_only_with_llct_profile(monkeypatch, stages):
    monkeypatch.delenv("LLCT_PROFILE", raising=False)
    assert not profiling.enabled()
    assert profiling.timed("a/b", max, 3, 7) == 7
    assert stages.report() == {}
    monkeypatch.setenv("LLCT_PROFILE", "1")        # read on every call
    assert profiling.enabled()
    assert profiling.timed("a/b", max, 3, 7) == 7
    assert profiling.marked("a/c", min, 3, 7) == 3    # named, not timed
    assert list(stages.report()) == ["a/b"]
    assert stages.report()["a/b"]["calls"] == 1
    monkeypatch.setenv("LLCT_PROFILE", "0")
    profiling.timed("a/b", max, 3, 7)
    assert stages.counts["a/b"] == 1


@pytest.mark.parametrize("engine,labels", [("fused", FUSED),
                                           ("sort", SORT)])
def test_encode_lanes_names_its_stages(monkeypatch, stages, engine,
                                       labels):
    monkeypatch.setenv("LLCT_PROFILE", "1")
    lanes = np.stack([make_photo(2, 8, seed=i) for i in range(3)])
    streams = encode.encode_lanes(lanes, device="cpu", engine=engine)
    assert sorted(stages.report()) == labels
    assert all(v["calls"] == 1 for v in stages.report().values())
    monkeypatch.delenv("LLCT_PROFILE")
    assert encode.encode_lanes(lanes, device="cpu", engine=engine) == streams


def test_decode_lanes_names_its_stages(monkeypatch, stages):
    lanes = np.stack([make_photo(2, 8, seed=i) for i in range(3)])
    streams = encode.encode_lanes(lanes, device="cpu")
    monkeypatch.setenv("LLCT_PROFILE", "1")
    out = decode.decode_lanes(streams, (2, 8, 3), device="cpu")
    np.testing.assert_array_equal(out, lanes)
    assert sorted(stages.report()) == DECODE
