"""One run of one cell: set-up, a closed-loop window, the check, the metrics.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its traffic in ``workloads/<cell>.json``, its
configuration in the file the manifest names, the entry point it drives in
``entries/<entry>.py`` and each metric's reader in ``metrics/<metric>.py``.
The program under test is ``llcomp_tpu_torch``, imported by the entries
only; nothing here imports the JAX package or JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import random
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import devtrace, generate

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM_CSRC = ROOT / "llcomp_tpu_torch" / "csrc"
# top-level module names that may not be loaded in a run, compared whole:
# the program's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "llcomp_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The names of ``FORBIDDEN`` among the top-level names of the loaded
    modules (``sys.modules`` by default)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """What a run of one cell needs to know."""

    cell: dict                # the cell's entry in BENCHMARK.json
    config: dict              # its configuration file
    work: dict                # its traffic file
    end_to_end: list          # the manifest's metrics of each kind
    per_layer: list

    @classmethod
    def load(cls, name: str) -> "Spec":
        manifest = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        config = load_json(ROOT / configs[cell["config"]]["file"])
        work = load_json(HERE / "workloads" / f"{name}.json")
        return cls(cell, config, work, manifest["end_to_end"],
                   manifest["per_layer"])

    def metrics(self, traced: bool) -> list[str]:
        """The names of the metrics this cell reports in a run with or
        without the trace."""
        listed = self.per_layer if traced else self.end_to_end
        return [m["name"] for m in listed
                if self.cell["name"] in m.get("workloads", [self.cell["name"]])]


@dataclasses.dataclass
class Run:
    """What the metric readers read: one run's calls, set-up and trace."""

    spec: Spec
    corpora: list             # the pool: lists of host u8 images
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    trace: devtrace.Trace | None = None
    program_kernels: set = dataclasses.field(default_factory=set)
    _decisions: dict = dataclasses.field(default_factory=dict)

    def mps(self) -> float | None:
        """Megapixels of every call that answered in the window over the
        window's host seconds."""
        if not self.calls:
            return None
        mp = sum(self.item_facts(c["item"])["mp"] for c in self.calls
                 if c["ok"])
        return mp / self.window_s

    def p95_ms(self) -> float | None:
        """The 95th percentile of every call's host time in the window
        (linear between order statistics), ms."""
        if not self.calls:
            return None
        return float(np.percentile([c["s"] for c in self.calls], 95)) * 1e3

    def item_facts(self, item: int) -> dict:
        """Lanes, symbols and megapixels of pool item ``item``'s corpus at
        the traffic's stripe height."""
        sh = self.spec.work["slice_h"]
        lanes = symbols = pixels = 0
        for img in self.corpora[item]:
            H, W, C = img.shape
            lanes += math.ceil(H / sh)
            symbols += H * W * C
            pixels += H * W
        return {"lanes": lanes, "symbols": symbols, "mp": pixels / 1e6}

    def decisions(self, item: int) -> int:
        """The decisions pool item ``item`` takes, counted from the
        reference's residuals, a stripe height's rows of an image at once,
        on the run's device."""
        from . import reference

        if item not in self._decisions:
            sh, n = self.spec.work["slice_h"], 0
            for img in self.corpora[item]:
                H = img.shape[0]
                x = torch.from_numpy(img).to(self.device)
                full = H - H % sh
                if full:
                    n += reference.decisions(reference.residuals(
                        x[:full].reshape(full // sh, sh, *x.shape[1:]))[1])
                if H % sh:
                    n += reference.decisions(reference.residuals(
                        x[full:][None])[1])
            self._decisions[item] = n
        return self._decisions[item]


def load_metric(name: str):
    """The reader ``metrics/<name>.py``: a module with ``read(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def gpu_clocks() -> dict | None:
    """The card's SM clock, its maximum, its power draw and limit and its
    temperature as ``nvidia-smi`` reads them now; None where it cannot."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return dict(zip(keys, (float(v) for v in out.split(","))))
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(spec: Spec, seed: int, seconds: float, traced: bool,
            device: str = "cuda", t_process: float | None = None,
            log=None) -> tuple[dict, dict]:
    """One run -> (result line, checks).  ``t_process``: the host clock
    (``time.perf_counter``) at the process's start."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    work, entry = spec.work, entry_module(spec.work["entry"])
    marks = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("device", time.perf_counter()))
    corpora = generate.pool(spec.config["images"], work["pool"], seed, dev)
    _sync(dev)
    marks.append(("pool", time.perf_counter()))
    inputs = entry.prepare(corpora, work, dev)
    marks.append(("prepare", time.perf_counter()))
    for k in range(work["warm_calls"]):
        entry.call(inputs[k % len(inputs)], work, dev)
    _sync(dev)
    marks.append(("warm", time.perf_counter()))
    log("setup: " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), prev
        in zip(marks, [t_process] + [t for _, t in marks])))
    clocks = {"before": gpu_clocks() if dev.type == "cuda" else None}

    run = Run(spec, corpora, dev)
    keep = random.Random(seed * 7919 + 17)
    kept: dict[int, tuple[int, object]] = {}
    failed = 0
    profile = contextlib.nullcontext()
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=acts)
    with profile as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            t_start = time.perf_counter()
            run.setup_s = t_start - t_process
            while True:
                i = len(run.calls)
                item = (work["warm_calls"] + i) % len(inputs)
                hold = i == 0 or keep.random() < work["keep_share"]
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(devtrace.CALL):
                        out, info = entry.call(inputs[item], work, dev)
                except Exception:       # a failed call counts, the run goes on
                    failed += 1
                    if failed == 1:
                        log(traceback.format_exc())
                    out, info = None, {}
                t_end = time.perf_counter()
                run.calls.append({"item": item, "s": t_end - t0,
                                  "ok": out is not None, **info})
                if hold:
                    kept[i] = (item, out)
                del out
                if t_end - t_start >= seconds:
                    break
            run.window_s = t_end - t_start
    if dev.type == "cuda":
        clocks["after"] = gpu_clocks()
        log(f"gpu: before the window {clocks['before']}, after "
            f"{clocks['after']}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if traced:
        t_trace = time.perf_counter()
        run.trace = devtrace.read_profile(prof)
        run.program_kernels = devtrace.program_kernels(str(PROGRAM_CSRC))
        log(f"trace: read in {time.perf_counter() - t_trace:.1f} s")
    del prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    secs = sorted(c["s"] for c in run.calls)
    log("calls: %d in %.2f s, seconds a call min %.4f q1 %.4f median %.4f "
        "q3 %.4f max %.4f" % (len(secs), run.window_s, secs[0],
                              secs[len(secs) // 4], secs[len(secs) // 2],
                              secs[3 * len(secs) // 4], secs[-1]))
    t_ref = time.perf_counter()
    checks = entry.judge(corpora, inputs, kept, work,
                         np.random.default_rng([seed, 0x5EED]))
    log(f"reference: {time.perf_counter() - t_ref:.1f} s over "
        f"{len(kept)} of {len(run.calls)} calls")

    metrics = {}
    listed = {m["name"]: m for m in spec.per_layer + spec.end_to_end}
    for name in spec.metrics(traced):
        value = load_metric(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": listed[name]["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": spec.cell["chips"], "memory_peak_bytes": peak}
    # a call that raised gave no answer: the run is not correct
    result = {"correct": failed == 0 and all(v <= lim for v, lim
                                             in checks.values()),
              "attempted": len(run.calls), "failed": failed,
              "metrics": metrics, "device": device_info, "gpu": clocks}
    if traced:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    return result, checks


def finish(result: dict, checks: dict) -> int:
    """Refuse a run that loaded JAX or the JAX package; else print the
    checks (last on standard error) and the result line (last on standard
    output).  -> the exit code."""
    found = forbidden_modules()
    if found:
        print(f"refused: loaded {', '.join(found)}", file=sys.stderr,
              flush=True)
        return 3
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list[str], t_process: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec.load(args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = measure(spec, args.seed, args.seconds, bool(args.trace),
                             "cuda", t_process)
    return finish(result, checks)
