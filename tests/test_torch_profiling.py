"""llcomp_tpu_torch.profiling against llcomp_tpu.profiling: the phase
timer's report on the same calls, labels in torch.profiler sessions and in
trace_to's file, LLCT_PROFILE read on every call, the lane loops' stage
labels on the CPU, and the host-only spans of the corpus entry points:
named inside the call in a profiler session, timed under LLCT_PROFILE=1,
never opened with both off, and the same bytes either way."""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import time

import numpy as np
import pytest
import torch

from llcomp_tpu import profiling as jprof
from llcomp_tpu_torch import corpus, decode, encode, profiling
from tests.conftest import make_photo

FUSED = ["encode/download", "encode/fused_kernel", "encode/precompute",
         "encode/streams", "encode/upload", "encode/wait"]
SORT = ["encode/coder", "encode/compact_sort", "encode/download",
        "encode/finish", "encode/precompute", "encode/streams",
        "encode/sym_sort", "encode/upload", "encode/walk"]
DECODE = ["decode/concat", "decode/download", "decode/kernel", "decode/pack",
          "decode/upload"]
# the host-only spans (``profiling.span``) of the two corpus entry points
# and their lane loops, by the path that opens them
COMPRESS = {"corpus/plan", "corpus/stack", "corpus/lanes", "corpus/pack",
            "encode/wait", "encode/streams"}
DECOMPRESS = {"corpus/parse", "corpus/plan", "corpus/lanes",
              "corpus/assemble", "decode/pack", "decode/concat"}
POLICY = {"corpus/policy", "corpus/seed"}
SPANS = COMPRESS | DECOMPRESS | POLICY


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


# (primed, seeded): the benchmark's start, and the automatic policy with a
# pooled seed, which opens corpus/policy and corpus/seed too
STARTS = [(True, False), (None, True)]


def _corpus():
    # two stripe shapes, few symbols: a profiler session records every op
    # of the kernels' plain versions
    return [make_photo(8, 4, seed=1), make_photo(11, 4, seed=2),
            make_photo(8, 4, seed=3)]


def _round_trip(primed, seeded):
    """-> (containers, decoded images) of the corpus on the CPU."""
    blobs, _ = corpus.compress_corpus(_corpus(), slice_h=8, primed=primed,
                                      seeded=seeded, device="cpu")
    return blobs, corpus.decompress_corpus(blobs, device="cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("record_function called with tracing off")


@pytest.fixture(scope="module", params=STARTS, ids=["primed", "auto-seeded"])
def untraced(request):
    """The round trip with LLCT_PROFILE unset, no profiler session and
    ``torch.profiler.record_function`` raising if anything calls it."""
    primed, seeded = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("LLCT_PROFILE", raising=False)
        mp.setattr(torch.profiler, "record_function", _refuse)
        blobs, outs = _round_trip(primed, seeded)
    return primed, seeded, blobs, outs


def _expected(primed, seeded) -> set:
    return COMPRESS | DECOMPRESS | (POLICY if primed is None else set())


def test_corpus_spans_do_nothing_with_tracing_off(untraced, stages):
    primed, seeded, blobs, outs = untraced
    for got, want in zip(outs, _corpus()):
        np.testing.assert_array_equal(got, want)
    flags = corpus.container.unpack_sliced(blobs[0])[5]
    assert bool(flags & corpus.container.FLAG_SEEDED) == seeded
    assert stages.report() == {}


def test_corpus_spans_lie_inside_the_call_in_a_profiler_session(
        untraced, tmp_path, monkeypatch):
    monkeypatch.delenv("LLCT_PROFILE", raising=False)
    primed, seeded, blobs, outs = untraced
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test/call"):
            got = _round_trip(primed, seeded)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    call, = [e for e in events if e["name"] == "test/call"]
    spans = [e for e in events if e["name"] in SPANS]
    assert {e["name"] for e in spans} == _expected(primed, seeded)
    for e in spans:
        assert call["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= call["ts"] + call["dur"]
    assert got[0] == blobs
    for a, b in zip(got[1], outs):
        np.testing.assert_array_equal(a, b)


def test_corpus_stages_under_llct_profile(untraced, monkeypatch, stages):
    monkeypatch.setenv("LLCT_PROFILE", "1")
    primed, seeded, blobs, outs = untraced
    got = _round_trip(primed, seeded)
    assert set(stages.report()) & SPANS == _expected(primed, seeded)
    assert got[0] == blobs
    for a, b in zip(got[1], outs):
        np.testing.assert_array_equal(a, b)


# (LLCT_PROFILE, profiler session) -> (named, timed in ``stages``)
SPAN_MODES = [("1", False, True, True), (None, True, True, False),
              (None, False, False, False)]


@pytest.mark.parametrize("env,session,named,in_stages", SPAN_MODES,
                         ids=["llct-profile", "profiler", "off"])
def test_span_is_timed_and_named_only_when_asked(monkeypatch, stages, env,
                                                 session, named, in_stages):
    if env is None:
        monkeypatch.delenv("LLCT_PROFILE", raising=False)
    else:
        monkeypatch.setenv("LLCT_PROFILE", env)
    if not named:
        monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with (torch.profiler.profile(activities=cpu) if session
          else contextlib.nullcontext()) as prof:
        with pytest.raises(KeyError), profiling.span("a/span"):
            raise KeyError("a span that raises still closes")
    assert ("a/span" in stages.report()) == in_stages
    if prof is not None:
        assert "a/span" in {e.key for e in prof.key_averages()}


def _spans_a_call(entry: str, count: int, tmp_path) -> dict:
    """The program's spans one call of ``entry`` opens, by name, on
    ``count`` copies of the corpus."""
    images = _corpus() * count
    blobs = None
    if entry == "decompress":
        blobs, _ = corpus.compress_corpus(images, slice_h=8, primed=True,
                                          device="cpu")
    path = tmp_path / f"{entry}_{count}.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if blobs is None:
            corpus.compress_corpus(images, slice_h=8, primed=True,
                                   device="cpu")
        else:
            corpus.decompress_corpus(blobs, device="cpu")
    prof.export_chrome_trace(str(path))
    return collections.Counter(
        e["name"] for e in json.loads(path.read_text())["traceEvents"]
        if e.get("ph") == "X" and e["name"] in SPANS | set(FUSED + DECODE))


@pytest.mark.parametrize("entry", ["compress", "decompress"])
def test_corpus_spans_a_call_do_not_grow_with_the_images(entry, tmp_path,
                                                          monkeypatch):
    """No span a lane or an image: three times the images open the same
    spans."""
    monkeypatch.delenv("LLCT_PROFILE", raising=False)
    once = _spans_a_call(entry, 1, tmp_path)
    assert set(once) >= (COMPRESS if entry == "compress" else DECOMPRESS)
    assert _spans_a_call(entry, 3, tmp_path) == once
