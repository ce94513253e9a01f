"""Probes of per-lane model access on the GPU: what one lane's read, write
or read-modify-write of its model row costs, what one symbol step costs
(staging the row in and out against 24 stand-in decisions), and what a
reduction over all lanes costs as a branch predicate.

These are the questions that shaped the walk and coder kernels; the
modules keep the probe names and the ``[rows, lanes]`` int32 layout (lanes
minor) of the TPU probes they replace:

- ``mosaic``: p0-p11 (``csrc/probe_mosaic.cu``);
- ``mosaic2``: pA-pF (``csrc/probe_mosaic2.cu``);
- ``mosaic3``: pG, pH (``csrc/probe_mosaic3.cu``);
- ``reduce``: the fill-and-flush reduction (``csrc/probe_reduce.cu``).

Each probe is one function taking tensors: a CUDA tensor launches its
kernel (counted in the function's ``launches``) or raises; a CPU tensor
runs the plain PyTorch version (``<name>_plain``, vectorised over lanes,
Python loops over steps), which also runs on CUDA tensors to check the
kernel.  A probe's model plane is ``[rows, lanes]`` int32 and is updated in
place; by default the function makes it with ``torch.zeros`` (the TPU
probes leave some of it uninitialised).  Each module runs as a script:

    python -m llcomp_tpu_torch.probes.mosaic [p0 p7 ...] [--device cpu]

printing one line a probe: PASS or FAIL (on CUDA: the kernel equals the
plain version exactly, on planes of random words), the first outputs, and
on CUDA the time a launch (CUDA events, median over fresh inputs; through
the Python wrapper, so host-bound for a probe without steps) and a symbol
step.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import device as _device
from ..kernels import build

LANES = 128
ROWS = 15872     # the model plane: 7,926 hashes, two int32 words each
LAUNCHES = 100   # launches a timed repeat of a probe without steps

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclass(frozen=True)
class Probe:
    """One probe: its wrapper ``fn`` and plain version ``plain`` (same
    keyword arguments), ``make(seed, lanes, rows, device)`` -> those
    arguments (fresh inputs, model planes zeroed), and ``T`` symbol steps a
    launch (0 for a probe without steps)."""
    name: str
    label: str
    fn: Callable
    plain: Callable
    make: Callable
    T: int = 0


# --- shared pieces of the wrappers and plain versions -----------------------


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    another device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"probe tensors must share one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"probes take CPU or CUDA tensors, got {dev}")
    return dev.type == "cuda"


def check_i32(name: str, t: torch.Tensor, lanes: int | None = None,
              dim: int = 2) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor of ``dim`` dimensions with
    ``lanes`` lanes (its last dimension); raises ValueError otherwise."""
    if t.dtype != torch.int32 or t.dim() != dim or (
            lanes is not None and t.shape[-1] != lanes):
        want = f"{dim}-d int32" + (f" with {lanes} lanes" if lanes else "")
        raise ValueError(f"{name} must be {want}, got {tuple(t.shape)} "
                         f"{t.dtype}")
    return t.contiguous()


def check_steps(name: str, T: int, model_rows: int = 0, min_rows: int = 0
                ) -> None:
    """Raise ValueError for a negative T or a plane of too few rows."""
    if T < 0:
        raise ValueError(f"{name}: T must be >= 0, got {T}")
    if model_rows < min_rows:
        raise ValueError(f"{name}: the model plane needs at least {min_rows} "
                         f"rows, got {model_rows}")


def plane(model, lanes: int, dev, planes: int = 0) -> torch.Tensor:
    """The model plane a probe updates: ``model`` checked, or zeros
    ``[ROWS, lanes]`` (``[planes, ROWS, lanes]`` where ``planes``) int32."""
    shape = (planes, ROWS, lanes) if planes else (ROWS, lanes)
    if model is None:
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    model = check_i32("model", model, lanes, len(shape))
    if planes and model.shape[0] != planes:
        raise ValueError(f"model must hold {planes} planes, got "
                         f"{model.shape[0]}")
    return model


def launch(source: str, entry: str, *args) -> None:
    """Launch ``entry`` of ``csrc/<source>.cu`` on the current stream of
    the first tensor's device, with that device current (the launch runs on
    the host thread's current device): tensors pass as pointers, ints as C
    ints; raises on a launch error."""
    fn = build.load(source, entry,
                    [_P if isinstance(a, torch.Tensor) else _I for a in args]
                    + [_P])
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                  for a in args), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, entry)


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` wrapped to int32, as 32-bit arithmetic wraps."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def step_row(x: torch.Tensor, s: int, m: int) -> torch.Tensor:
    """The staging probes' row at step s: (x*(s+1) + s*40503) mod m, in
    32-bit arithmetic; int64."""
    return i32(x * (s + 1) + s * 40503).long() % m


def floor_mod_magic(m: int) -> tuple[int, int, int, int]:
    """The constants with which a kernel takes v mod m (floor) of every
    int32 v with no division, 1 <= m < 2^31 (``FloorMod``,
    ``csrc/probe_mosaic.cu``): for u = v + 2^31 (mod 2^32), Granlund and
    Montgomery's round-up quotient of u by m, exact for every 32-bit u, is
    q = (hi + ((u - hi) >> sh1)) >> sh2 with hi the high word of u * mul;
    then (u - q*m + mc), mc = m - (2^31 mod m), lies in [1, 2m) and is
    v mod m or that plus m.  -> (mul, sh1, sh2, mc), each below 2^32."""
    if not 1 <= m < 2**31:
        raise ValueError(f"floor_mod_magic takes 1 <= m < 2^31, got {m}")
    l = (m - 1).bit_length()                  # ceil(log2 m)
    mul = (2**32 * (2**l - m)) // m + 1
    return mul, min(l, 1), max(l - 1, 0), m - 2**31 % m


def window_plain(idx: torch.Tensor, src: torch.Tensor, win: int, m: int
                 ) -> torch.Tensor:
    """out[i, l] = src[r + i, l] for i < win, r = idx[0, l] mod m (m > 0)
    or idx[0, l], clamped into [0, rows - win]."""
    r = idx[0].long()
    if m:
        r = r % m
    r = r.clamp(0, src.shape[0] - win)
    lane = torch.arange(idx.shape[1], device=idx.device)
    rows = r[None] + torch.arange(win, device=idx.device)[:, None]
    return src[rows, lane[None]].clone()


def window(wrapper, source: str, entry: str, idx: torch.Tensor,
           src: torch.Tensor, win: int, m: int, *extra: int) -> torch.Tensor:
    """The window probes' wrapper body: checks, then ``window_plain`` on
    the CPU, or the kernel ``entry`` on CUDA, counted on ``wrapper``."""
    idx = check_i32("idx", idx)
    src = check_i32("src", src, idx.shape[1])
    if src.shape[0] < max(win, m):
        raise ValueError(f"{wrapper.__name__}: src needs at least "
                         f"{max(win, m)} rows")
    if not is_cuda(idx, src):
        return window_plain(idx, src, win, m)
    out = torch.empty((win, idx.shape[1]), dtype=torch.int32,
                      device=idx.device)
    launch(source, entry, idx, src, out, idx.shape[1], src.shape[0], *extra)
    wrapper.launches += 1
    return out


def row_store_plain(idx: torch.Tensor, val: torch.Tensor, model=None
                    ) -> torch.Tensor:
    """model[idx[0, l] mod 8, l] = val[0, l]; returns model[0:8]."""
    model = plane(model, idx.shape[1], idx.device)
    lane = torch.arange(idx.shape[1], device=idx.device)
    model[idx[0].long() % 8, lane] = val[0]
    return model[:8].clone()


def row_store(wrapper, source: str, entry: str, idx: torch.Tensor,
              val: torch.Tensor, model) -> torch.Tensor:
    """The row read-modify-write probes' wrapper body: checks, then
    ``row_store_plain`` on the CPU, or the kernel ``entry`` on CUDA, counted
    on ``wrapper``."""
    idx = check_i32("idx", idx)
    val = check_i32("val", val, idx.shape[1])
    model = plane(model, idx.shape[1], idx.device)
    if model.shape[0] < 8:
        raise ValueError(f"{wrapper.__name__}: the model plane needs at "
                         f"least 8 rows")
    if not is_cuda(idx, val, model):
        return row_store_plain(idx, val, model)
    out = torch.empty((8, idx.shape[1]), dtype=torch.int32, device=idx.device)
    launch(source, entry, idx, val, model, out, idx.shape[1])
    wrapper.launches += 1
    return out


def row_bytes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int32 words a lane -> their 8 bytes [8, lanes] int64, bytes 0-3
    from ``lo`` and 4-7 from ``hi``."""
    sh = torch.arange(0, 32, 8, device=lo.device)[:, None]
    return torch.cat([(lo.long()[None] >> sh) & 0xFF,
                      (hi.long()[None] >> sh) & 0xFF])


def row_words(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``row_bytes``: (lo, hi) int32."""
    sh = torch.arange(0, 32, 8, device=b.device)[:, None]
    return i32((b[:4] << sh).sum(0)), i32((b[4:] << sh).sum(0))


def decide24_plain(b: torch.Tensor, acc: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """24 stand-in decisions on bytes ``b`` [8, lanes] and ``acc`` [lanes]
    (int64): ctx = (acc + d) & 7 picks byte ctx, acc = (acc*5 + byte + 1) &
    0x7FFF, the byte steps to (byte + 1) & 0xFF."""
    for d in range(24):
        ctx = ((acc + d) & 7)[None]
        pick = b.gather(0, ctx)
        acc = (acc * 5 + pick[0] + 1) & 0x7FFF
        b = b.scatter(0, ctx, (pick + 1) & 0xFF)
    return b, acc


# --- inputs, as the TPU probes made them ------------------------------------


def ints(seed: int, high: int, shape, dev) -> torch.Tensor:
    """Uniform int32 in [0, high) from numpy's generator ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, high, size=shape, dtype=np.int32)
                            ).to(dev)


def zeros(shape, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=dev)


def words(seed: int, shape, dev) -> torch.Tensor:
    """Uniform int32 over the whole range, from torch's generator ``seed``
    on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev,
                         generator=g)


def telling(out: torch.Tensor, before: dict, after: dict) -> bool:
    """Whether a check of a probe on this output and these planes can tell
    a wrong kernel from a right one: the output differs across lanes, or a
    plane changed (``before`` and ``after``: name -> plane)."""
    return bool((out != out[..., :1]).any()) or any(
        not torch.equal(before[k], after[k]) for k in before)


# --- running and timing -----------------------------------------------------


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def run_probe(probe: Probe, device="cuda", lanes: int = LANES,
              T: int | None = None, reps: int = 3, check: bool = True
              ) -> dict:
    """Run ``probe`` once on inputs from seed 0 and, on CUDA, time ``reps``
    repeats on fresh inputs (seeds 1..reps, planes zeroed), median of the
    CUDA-event times (one launch a repeat for a probe with steps,
    ``LAUNCHES`` back to back through the wrapper otherwise).

    On CUDA with ``check``, the first run's model planes hold random words
    (from a zero plane p8, p11 and pH give the same output in every lane,
    which a wrong kernel could match) and the plain version runs on the
    same inputs.  Returns {"out", "host_s" (the first call, build included),
    "T", "err" (the largest difference from the plain version, over the
    output and every tensor argument after the call), "plain_ms" (the plain
    version's host milliseconds), "telling" (``telling`` of the plain
    version's output and planes), "ms" (a launch) and "ns_step" (a symbol
    step), None where not measured}.
    """
    dev = _device.resolve(device)
    T = probe.T if T is None else T

    def inputs(seed: int) -> dict:
        kw = probe.make(seed, lanes, ROWS, dev)
        if probe.T:
            kw["T"] = T
        return kw

    kw = inputs(0)
    cuda = dev.type == "cuda"
    check = check and cuda
    if check and "model" in kw:
        kw["model"] = words(0, kw["model"].shape, dev)
    ref = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()} if check else None
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = probe.fn(**kw)
    if cuda:
        torch.cuda.synchronize(dev)
    res = {"out": out, "host_s": time.perf_counter() - t0, "T": T,
           "err": None, "plain_ms": None, "telling": None, "ms": None,
           "ns_step": None}
    if ref is not None:
        before = {k: v.clone() for k, v in ref.items() if k == "model"}
        t0 = time.perf_counter()
        want = probe.plain(**ref)
        torch.cuda.synchronize(dev)
        res["plain_ms"] = (time.perf_counter() - t0) * 1e3
        res["err"] = max([_max_err(out, want)] + [
            _max_err(v, ref[k]) for k, v in kw.items()
            if isinstance(v, torch.Tensor)])
        res["telling"] = telling(want, before, ref)
    if cuda and reps:
        n = 1 if probe.T else LAUNCHES
        times = []
        for seed in range(1, reps + 1):
            kw = inputs(seed)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(n):
                probe.fn(**kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        res["ms"] = statistics.median(times)
        if T:
            res["ns_step"] = res["ms"] * 1e6 / T
    return res


def main(probes: dict[str, Probe], argv=None, prog: str | None = None) -> int:
    """Command line of a probe module: run the named probes (default: all)
    and print one line each; 0 if every probe passed."""
    p = argparse.ArgumentParser(prog=prog, description=(
        "Run probes on the GPU (kernel against plain version, timed) or on "
        "the CPU (plain versions)."))
    p.add_argument("names", nargs="*", metavar="probe",
                   help=f"probes to run (default all): {' '.join(probes)}")
    p.add_argument("--device", default="cuda")
    p.add_argument("--lanes", type=int, default=LANES)
    p.add_argument("--steps", type=int, default=None,
                   help="symbol steps T (default: each probe's own)")
    a = p.parse_args(argv)
    for name in a.names:
        if name not in probes:
            p.error(f"unknown probe {name!r}; choose from {' '.join(probes)}")
    dev = _device.resolve(a.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions, host clock)")
    print(f"device: {where}", flush=True)
    ok = True
    for name in a.names or list(probes):
        probe = probes[name]
        r = run_probe(probe, dev, a.lanes, a.steps)
        passed = r["err"] in (None, 0) and r["telling"] is not False
        ok &= passed
        line = (f"{'PASS' if passed else 'FAIL'} {name} {probe.label}: first "
                f"run {r['host_s']:.3f} s out[:4]="
                f"{r['out'].flatten()[:4].tolist()}")
        if r["err"] is not None:
            line += f", kernel - plain max_abs_err {r['err']}"
        if r["telling"] is False:
            line += " (the same output in every lane and no plane changed)"
        if r["ms"] is not None:
            line += f"; {r['ms']:.5f} ms a launch (CUDA events, median of 3"
            line += ")" if r["T"] else (
                f", {LAUNCHES} launches through the wrapper: host-bound)")
        if r["ns_step"] is not None:
            line += f", {r['ns_step']:.1f} ns a step (T {r['T']})"
        print(line, flush=True)
    print("done", flush=True)
    return 0 if ok else 1
