"""portbench/spans.py: the split of a traced window by the program's host
spans, on a synthetic event list (by hand, and against ``devtrace.read``
of the same events) and on tiny traced runs of both entries on the CPU."""
from __future__ import annotations

import pytest

from conftest import tiny_spec
from portbench import devtrace, harness, spans


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """A window of 100 us over two calls: the first plans, runs its lanes
    (a stage inside) and packs; the second plans and leaves the rest of the
    call in no span of the program."""
    return [
        _x("user_annotation", devtrace.WINDOW, 0, 100),
        _x("user_annotation", devtrace.CALL, 0, 50),
        _x("user_annotation", "corpus/plan", 0, 5),
        _x("user_annotation", "corpus/lanes", 5, 35),
        _x("user_annotation", "encode/upload", 5, 10),
        _x("user_annotation", "corpus/pack", 40, 8),
        _x("user_annotation", devtrace.CALL, 50, 45),
        _x("user_annotation", "corpus/plan", 52, 6),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10),
        _x("kernel", "encode_fused_kernel(int const*)", 20, 30),
        _x("kernel", "late(int)", 120, 5),                 # past the window
        {"ph": "i", "cat": "user_annotation", "name": "corpus/pack",
         "ts": 60},                                        # no duration
    ]


# innermost host span, us: plan [0, 5), upload [5, 15), lanes [15, 40),
# pack [40, 48), call [48, 52) and [58, 95), plan [52, 58), window [95, 100)
HOST_US = {"corpus/plan": 11, "corpus/lanes": 25, "encode/upload": 10,
           "corpus/pack": 8, devtrace.CALL: 41, devtrace.WINDOW: 5}
# the card busy over [10, 50)
IDLE_US = {"corpus/plan": 11, "encode/upload": 5, devtrace.CALL: 39,
           devtrace.WINDOW: 5}


def test_split_by_hand():
    s = spans.split(_events())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["host_s"] == pytest.approx({k: v * 1e-6
                                         for k, v in HOST_US.items()})
    assert s["idle_s"] == pytest.approx({k: v * 1e-6
                                         for k, v in IDLE_US.items()})
    assert sum(s["host_s"].values()) == pytest.approx(s["window_s"])
    assert s["opened"] == {"corpus/plan": 2, "corpus/lanes": 1,
                           "encode/upload": 1, "corpus/pack": 1}


def test_split_reads_what_the_benchmark_reads():
    """The idle part of the split is ``devtrace.read``'s ``idle_gaps`` of
    the same events, whole and not only its ten largest entries; the busy
    rest is its ``busy_s``."""
    s = spans.split(_events())
    t = devtrace.read(_events())
    assert s["window_s"] == pytest.approx(t.window_s)
    assert dict(t.idle_gaps) == pytest.approx(s["idle_s"])
    busy = s["window_s"] - sum(s["idle_s"].values())
    assert busy == pytest.approx(t.busy_s)


def test_summary_is_a_call():
    line = spans.summary({"attempted": 2}, _events())
    assert line["host_ms"] == pytest.approx({k: v / 2e3
                                             for k, v in HOST_US.items()})
    assert list(line["idle_ms"])[0] == devtrace.CALL      # largest first
    assert line["unlabelled_idle_pct"] == pytest.approx(39.0)
    assert line["spans_a_call"] == pytest.approx(2.5)
    assert line["opened_a_call"]["corpus/plan"] == pytest.approx(1.0)


def test_kept_events_takes_its_hook_off():
    read = devtrace.read
    with pytest.raises(ValueError), spans.kept_events() as kept:
        devtrace.read([])                   # no window: read raises
    assert devtrace.read is read and kept == [[]]


# the program's host spans each entry opens on the benchmark's path
# (primed, not seeded)
SPANS = {
    "ingest": {"corpus/plan", "corpus/stack", "corpus/lanes", "corpus/pack",
               "encode/wait", "encode/streams"},
    "restore": {"corpus/parse", "corpus/plan", "corpus/lanes",
                "corpus/assemble", "decode/pack", "decode/concat"},
}


def _tiny_run(traffic: str, count: int) -> dict:
    """The split of one traced call of ``kodak24.<traffic>`` on the CPU,
    on a corpus of ``count`` images of each of two shapes (two stripe
    shapes at 8 rows)."""
    spec = tiny_spec(f"kodak24.{traffic}")
    spec.config = {"images": [{"shape": [8, 4, 3], "count": count},
                              {"shape": [11, 4, 3], "count": count}]}
    spec.work = dict(spec.work, pool=1)
    with spans.kept_events() as kept:
        result, _ = harness.measure(spec, 2 ** 31 + 23, 0.0, True, "cpu",
                                    log=lambda msg: None)
    assert result["correct"] and result["attempted"] == 1
    return spans.summary(result, kept[0])


@pytest.mark.parametrize("traffic", sorted(SPANS))
def test_a_tiny_traced_run_is_split_by_the_programs_spans(traffic):
    line = _tiny_run(traffic, 1)
    assert SPANS[traffic] <= set(line["opened_a_call"])
    assert {devtrace.CALL, devtrace.WINDOW}.isdisjoint(line["opened_a_call"])
    # no device activity on the CPU: the whole window is idle
    assert line["idle_ms"] == pytest.approx(line["host_ms"])
    assert (sum(line["host_ms"].values()) * line["calls"] / 1e3
            == pytest.approx(line["window_s"]))
    # no span a lane or an image: three times the images, the same spans
    assert _tiny_run(traffic, 3)["opened_a_call"] == line["opened_a_call"]
