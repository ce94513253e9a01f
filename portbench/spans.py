"""A traced window split by the program's host spans.

``devtrace.read`` keeps, of the host spans, the ten largest idle sums
(``Trace.idle_gaps``).  ``split`` reads the same window of the same events
with ``devtrace``'s helpers and keeps every span name: the seconds in
which it is the innermost open host span (``host_s``), the part of those
in which no kernel, copy or fill runs on the card (``idle_s``), and the
spans the program opened.  ``devtrace.CALL`` innermost is the host inside
a call but in no span of the program; ``devtrace.WINDOW``, between calls.

    python3 portbench/spans.py --workload kodak24.ingest --seed 7 \\
        [--seconds 30]

runs one cell traced on the card, as ``portbench/run.py --trace 1`` does,
and prints one JSON line: the split a call, and the run's result line
under ``result``.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of this script's folder, as run.py
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import devtrace  # noqa: E402


def _window(events: list[dict]):
    """-> (lo, hi, device intervals, host spans) of the window, chosen as
    ``devtrace.read`` chooses them."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == devtrace.WINDOW]
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        if e.get("cat") in devtrace.DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi)))
        elif (e.get("cat") == "user_annotation"
              and e["name"] != devtrace.WINDOW):
            host.append((a, b, e["name"]))
    return lo, hi, dev, host


def split(events: list[dict]) -> dict:
    """Chrome-trace events -> {"window_s", "host_s", "idle_s", "opened"}:
    seconds by innermost host span, in all and with the card idle, and the
    program's spans opened in the window, by name."""
    lo, hi, dev, host = _window(events)
    busy = devtrace._union(dev)
    host_s: dict = collections.Counter()
    idle_s: dict = collections.Counter()
    j = 0
    for a, b, name in devtrace._innermost(host, lo, hi):
        host_s[name] += (b - a) / 1e6
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        if b - a > covered:
            idle_s[name] += (b - a - covered) / 1e6
    opened = collections.Counter(name for _, _, name in host
                                 if name != devtrace.CALL)
    return {"window_s": (hi - lo) / 1e6, "host_s": dict(host_s),
            "idle_s": dict(idle_s), "opened": dict(opened)}


@contextlib.contextmanager
def kept_events():
    """Keep the events of every trace ``devtrace.read`` reads inside the
    block: yields the list they are appended to."""
    kept: list = []
    read = devtrace.read

    def keep(events):
        kept.append(events)
        return read(events)

    devtrace.read = keep
    try:
        yield kept
    finally:
        devtrace.read = read


def summary(result: dict, events: list[dict]) -> dict:
    """The split of a traced run's window, a call: ms by innermost span
    (largest first), the unlabelled idle share of the window, spans
    opened."""
    s = split(events)
    calls = result["attempted"]

    def a_call_ms(sums):
        return {k: v / calls * 1e3
                for k, v in sorted(sums.items(), key=lambda p: -p[1])}

    return {
        "calls": calls, "window_s": s["window_s"],
        "host_ms": a_call_ms(s["host_s"]), "idle_ms": a_call_ms(s["idle_s"]),
        "unlabelled_idle_pct": 100.0 * s["idle_s"].get(devtrace.CALL, 0.0)
        / s["window_s"],
        "spans_a_call": sum(s["opened"].values()) / calls,
        "opened_a_call": {k: v / calls for k, v in sorted(s["opened"].items())},
        "result": result}


def main(argv: list[str]) -> int:
    import argparse

    from portbench import harness

    p = argparse.ArgumentParser(prog="portbench/spans.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    with kept_events() as kept:
        result, _checks = harness.measure(
            harness.Spec.load(args.workload), args.seed, args.seconds, True,
            "cuda", T_PROCESS)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **summary(result, kept[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
