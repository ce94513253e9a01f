"""What a ``torch.profiler`` trace of the measured window says.

The window is traced as one ``torch.profiler`` session with the host's
``record_function`` spans: the benchmark's own (``WINDOW``, and ``CALL`` a
call) and the program's stage labels (``encode/upload``, ``decode/kernel``,
...).  Device activity is every kernel, copy and fill the trace puts on the
card.  ``Trace`` keeps the sums the metric readers take and the breakdown.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile

WINDOW = "portbench/window"
CALL = "portbench/call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_id(name: str) -> str:
    """A kernel's function name as the trace spells it, without return
    type, namespaces, template arguments or parameters: 'void (anonymous
    namespace)::decode_kernel<3>(...)' -> 'decode_kernel'."""
    name = name.replace("(anonymous namespace)", "anonymous")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(spans: list[tuple[float, float, str]], lo: float, hi: float
               ) -> list[tuple[float, float, str]]:
    """Host spans (properly nested, one thread) -> the flat segments of
    [lo, hi] labelled by the innermost span open there (WINDOW where no
    span of the program or the benchmark is)."""
    marks = []
    for a, b, name in spans:
        marks.append((max(a, lo), 1, -(b - a), name))
        marks.append((min(b, hi), 0, 0.0, name))
    marks.sort()
    out, stack, t = [], [WINDOW], lo
    for when, is_start, _, name in marks:
        if when > t:
            out.append((t, when, stack[-1]))
            t = when
        if is_start:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if hi > t:
        out.append((t, hi, stack[-1]))
    return out


@dataclasses.dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = dataclasses.field(default_factory=dict)  # kernel_id -> s
    copy_s: dict = dataclasses.field(default_factory=dict)    # HtoD/DtoH -> s
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)

    def device_s(self, exclude: set[str]) -> float:
        """Seconds of every kernel whose id is not in ``exclude``."""
        return sum(s for k, s in self.kernel_s.items() if k not in exclude)


def read(events: list[dict]) -> Trace:
    """Chrome-trace events -> the window's ``Trace``."""
    win = [e for e in events
           if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, host = [], []
    kernel_s: dict = collections.Counter()
    copy_s: dict = collections.Counter()
    by_name: dict = collections.Counter()
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        b = a + d
        if b <= lo or a >= hi:
            continue
        if cat in DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi)))
            by_name[e["name"]] += d / 1e6
            if cat == "kernel":
                kernel_s[kernel_id(e["name"])] += d / 1e6
            elif cat == "gpu_memcpy":
                for way in ("HtoD", "DtoH", "DtoD"):
                    if way in e["name"]:
                        copy_s[way] += d / 1e6
        elif cat == "user_annotation" and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union(dev)
    idle: dict = collections.Counter()
    segs = _innermost(host, lo, hi)
    edges = [lo] + [t for span in busy for t in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            idle[segs[k][2]] += (min(b, segs[k][1]) - max(a, segs[k][0])) / 1e6
            k += 1
    top = sorted(by_name.items(), key=lambda p: -p[1])[:10]
    return Trace(window_s=(hi - lo) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 kernel_s=dict(kernel_s), copy_s=dict(copy_s),
                 device_ops=[[n[:160], s] for n, s in top],
                 idle_gaps=[[n, s] for n, s in sorted(
                     idle.items(), key=lambda p: -p[1])[:10]])


def copy_ms(run) -> float | None:
    """Device ms a call of host-to-device and device-to-host copies in the
    trace of ``run``'s window; None without a trace, a call or a copy."""
    if run.trace is None or not run.calls:
        return None
    s = run.trace.copy_s.get("HtoD", 0.0) + run.trace.copy_s.get("DtoH", 0.0)
    return s / len(run.calls) * 1e3 if s > 0 else None


def torch_ops_ms(run) -> float | None:
    """Device ms a call of every kernel in the trace of ``run``'s window
    that is not one of the program's own; None without a trace, a call or
    such a kernel."""
    if run.trace is None or not run.calls:
        return None
    s = run.trace.device_s(run.program_kernels)
    return s / len(run.calls) * 1e3 if s > 0 else None


def idle_pct(run) -> float | None:
    """The share of ``run``'s traced window in which no kernel, copy or
    fill runs on the card, %; None without a trace or device activity."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def read_profile(prof) -> Trace:
    """A finished ``torch.profiler.profile`` -> its ``Trace``, through a
    Chrome trace in a temporary file (removed again)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read(events)


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def program_kernels(csrc_dir: str) -> set[str]:
    """The names of the ``__global__`` functions in the program's CUDA
    sources: the port's own kernels, told apart from PyTorch's."""
    names: set[str] = set()
    for entry in sorted(os.listdir(csrc_dir)):
        if entry.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, entry), encoding="utf-8") as f:
                names.update(_GLOBAL.findall(f.read()))
    return names
