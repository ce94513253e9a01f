"""Tracing and stage timing: codec stages named in ``torch.profiler`` traces.

Port of ``llcomp_tpu/profiling.py``.  ``annotate`` names a region in traces
(``torch.profiler.record_function``, and an NVTX range once CUDA is up);
``trace_to`` records a CPU and CUDA trace of a block into a Chrome trace
file; ``PhaseTimer`` accumulates wall time by phase; ``timed`` runs one
pipeline stage of the lane loops (``encode``, ``decode``) under its label
(``encode/upload``, ``encode/precompute``, ``encode/fused_kernel``,
``decode/kernel``, ...).  ``LLCT_PROFILE=1`` (read on every call) turns on
the stage timer ``stages``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pathlib
import time

import torch


@contextlib.contextmanager
def annotate(label: str):
    """Name the enclosed region ``label`` in traces: a
    ``record_function`` range, and an NVTX range once CUDA is initialised
    in this process."""
    with torch.profiler.record_function(label):
        if not torch.cuda.is_initialized():
            yield
            return
        torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


_trace_ids = itertools.count()


@contextlib.contextmanager
def trace_to(logdir):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU
    activity, and CUDA activity where CUDA is available) and write it as a
    Chrome trace into ``logdir``; yields the file's path, which exists once
    the block has left."""
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"llct_trace_{os.getpid()}_{next(_trace_ids)}.json"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


class PhaseTimer:
    """Accumulating wall-clock timer: ``with timer('encode'): ...``."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }


def enabled() -> bool:
    """Stage timing is on when LLCT_PROFILE=1 (read on every call, so that
    tests can toggle it)."""
    return os.environ.get("LLCT_PROFILE") == "1"


#: the process's stage timer, which ``timed`` fills when LLCT_PROFILE=1
stages = PhaseTimer()


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or tuples,
    lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (tuple, list)):
        return set()
    return set().union(*(_cuda_devices(o) for o in out))


def timed(label: str, fn, *args, **kwargs):
    """Run one pipeline stage, ``fn(*args, **kwargs)``, under ``label``.

    With profiling off it is ``fn(*args, **kwargs)``, with no sync; inside
    a ``torch.profiler`` session it is named ``label`` in the trace.  With
    LLCT_PROFILE=1 it also synchronises the CUDA devices of the stage's
    outputs and adds the wall time to ``stages``.  Those syncs serialise
    the queued stages, so profile-mode throughput is NOT representative: it
    attributes time, it does not measure end-to-end speed.
    """
    if enabled():
        with stages(label), annotate(label):
            out = fn(*args, **kwargs)
            for dev in _cuda_devices(out):
                torch.cuda.synchronize(dev)
        return out
    if torch.autograd._profiler_enabled():
        with annotate(label):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


def marked(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` named ``label`` in traces, with no sync and
    no stage time: for stages queued on a side stream, whose end the host
    does not see (the pipelined and sharded encodes)."""
    if enabled() or torch.autograd._profiler_enabled():
        with annotate(label):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)
