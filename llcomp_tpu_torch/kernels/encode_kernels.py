"""Kernels 3 and 4: the sort chain's symbol walk and quad range coder (CUDA),
and their plain versions.

Replace ``llcomp_tpu/pallas/encode_kernels.py::_make_symwalk_kernel``
(``walk_symbols``, `encode_kernels.py:175`) and ``::_coder_kernel_off_q``
(``coder_scan_off_q``, `encode_kernels.py:574`).  Both are serial recurrences
per lane: on the GPU one thread owns one lane, and arrays are lane-minor
``[T, S]`` (step-major) so that a warp's 32 lanes read and write one line per
step.  The TPU's [G, T, 8, 128] lane groups, grid chunks and scratch carries
have no counterpart.  The source notes in ``csrc/walk_symbols.cu`` and
``csrc/coder_scan.cu`` say what bounds each kernel on the H100.

A CUDA tensor launches the kernel (and counts the launch on the wrapper); a
CPU tensor runs the plain version.  Records are 10 bits,
``valid<<9 | bit<<8 | prob``, pair-packed: quad q's records 4q, 4q+1 sit in
``lo`` (``rec_{4q+1}<<10 | rec_{4q}``) and 4q+2, 4q+3 in ``hi``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import coder
from ..core import tables, transform
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
RESET_ROWS = 128        # 121 prior/seed buckets, padded as the 7-bit field


def _check_i32(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.dtype != torch.int32:
        raise ValueError(f"{what} must be [T, S] int32, got {tuple(t.shape)} "
                         f"{t.dtype}")


def reset_rows(init, device) -> torch.Tensor:
    """[128] int64 model rows a context run starts from, substate k in byte
    k (``tables.pack_u64``): ``init[b]`` for bucket b < 121 and zeros beyond;
    all zeros when ``init`` is None (unprimed)."""
    rows = np.zeros(RESET_ROWS, dtype=np.int64)
    if init is not None:
        rows[: tables.PRIOR_BUCKETS] = tables.pack_u64(init)
    return torch.from_numpy(rows).to(device)


def walk_symbols_plain(xs: torch.Tensor, K: int, init
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk in plain torch, vectorised over lanes, with Python loops over
    symbols and decisions.  The model row is kept as two 32-bit halves
    (substates 0-3 and 4-7), as the kernel keeps it."""
    n, S = xs.shape
    dev = xs.device
    x = xs.to(torch.int64)
    seg = ((x >> 12) & 1).to(torch.bool)
    bucket = (x >> 14) & 0x7F
    d = (x & 0xFFF) - 1274
    ad = d.abs()
    e = transform.ilog2(ad.clamp(min=1), max_bits=12)
    live = (x >> 13) & 1
    nb = (torch.where(ad != 0, 2 * e + 3, 1) * live).clamp(max=K)
    steps = nb.amax(dim=1).tolist() if S else [0] * n
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    rows = reset_rows(init, dev)
    half = (rows & 0xFFFFFFFF, (rows >> 32) & 0xFFFFFFFF)
    row = [torch.zeros(S, dtype=torch.int64, device=dev) for _ in range(2)]
    qs = K // 4
    lo = torch.zeros((n * qs, S), dtype=torch.int32, device=dev)
    hi = torch.zeros_like(lo)
    for j in range(n):
        for w in range(2):
            row[w] = torch.where(seg[j], half[w][bucket[j]], row[w])
        for k in range(steps[j]):
            ctx, bit = transform.decision(k, d[j], ad[j], e[j])
            valid = nb[j] > k
            sh = (ctx & 3) * 8
            upper = ctx >= 4
            word = torch.where(upper, row[1], row[0])
            f = fused[(word >> sh) & 0xFF]
            ns = torch.where(bit == 1, f >> 16, f >> 8) & 0xFF
            new = (word & ~(0xFF << sh)) | (ns << sh)
            row[0] = torch.where(valid & ~upper, new, row[0])
            row[1] = torch.where(valid & upper, new, row[1])
            rec = torch.where(valid, (1 << 9) | (bit << 8) | (f & 0xFF), 0)
            out = lo if k % 4 < 2 else hi
            out[j * qs + k // 4] |= (rec << (10 * (k % 2))).to(torch.int32)
    return lo, hi


def walk_symbols(xs: torch.Tensor, K: int = 24, init=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk each lane's context-sorted symbols: ``xs`` [n, S] int32
    (``bucket<<14 | live<<13 | seg<<12 | diff+1274``, ``encode.stage_sym_sort``)
    -> pair-packed coder records (lo, hi), each [n*K/4, S] int32, K/4 quads
    per symbol.

    A context run (``seg``) starts from zeros, or from ``init[bucket]`` when
    ``init`` (a [121, 8] u8 prior or seed table) is given.  At most K
    decisions of a symbol are walked; records past its last decision are 0.
    A CUDA ``xs`` launches kernel 3 (counted in ``walk_symbols.launches``);
    a CPU ``xs`` runs ``walk_symbols_plain``.
    """
    _check_i32(xs, "xs")
    if K < 4 or K % 4:
        raise ValueError(f"K must be a positive multiple of 4, got {K}")
    if not xs.is_cuda:
        return walk_symbols_plain(xs, K, init)
    xs = xs.contiguous()
    n, S = xs.shape
    dev = xs.device
    fused = torch.from_numpy(tables.FUSED).to(dev)
    rows = reset_rows(init, dev)
    lo = torch.empty((n * K // 4, S), dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    fn = build.load("walk_symbols", "llct_walk_symbols",
                    [_P] * 5 + [_I] * 3 + [_P])
    rc = fn(xs.data_ptr(), fused.data_ptr(), rows.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), n, S, K, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "walk_symbols")
    walk_symbols.launches += 1
    return lo, hi


walk_symbols.launches = 0


def coder_scan_off_q_plain(qlo: torch.Tensor, qhi: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The quad coder in plain torch, vectorised over lanes, with a Python
    loop over decisions (``coder.shift_step`` for each renormalisation)."""
    Tq, S = qlo.shape
    dev = qlo.device
    z = torch.zeros(S, dtype=torch.int64, device=dev)
    low, rng, pend, run, off = z, z + 0xFF00, z - 1, z, z
    bad = torch.zeros(S, dtype=torch.bool, device=dev)
    kp = torch.empty((4 * Tq, S), dtype=torch.int32, device=dev)
    words = (qlo.to(torch.int64), qhi.to(torch.int64))
    for t in range(4 * Tq):
        x = (words[(t >> 1) & 1][t >> 2] >> (10 * (t & 1))) & 0x3FF
        prob, one, valid = x & 0xFF, (x & 0x100) != 0, (x & 0x200) != 0
        range1 = (rng * prob) >> 8
        low = torch.where(one & valid, low + rng - range1, low)
        rng = torch.where(valid, torch.where(one, range1, rng - range1), rng)
        (low, rng, pend, run), (emit, carry, head, flushed) = (
            coder.shift_step(low, rng, pend, run, valid & (rng < 0x100)))
        kp[t] = coder.kp_record(emit, carry, head, off)
        bad |= emit & (off >= coder.OFF_LIMIT)
        off = torch.where(emit, off + 1 + flushed, off)
    if bool(bad.any()):
        raise RuntimeError("coder_scan_off_q: a byte offset reached 2^22")
    return kp, torch.stack([low, rng, pend, run, off]).to(torch.int32)


def coder_scan_off_q(qlo: torch.Tensor, qhi: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Range-code each lane's records in stream order: qlo, qhi [Tq, S]
    int32 pair-packed quads (dead quads 0) -> (kp [4*Tq, S] int32, one
    offset-packed record per decision, ``off<<9 | carry<<8 | head`` where
    a shift flushes a byte and ``coder.KP_SILENT`` elsewhere; fin [5, S]
    int32, the final low, rng, pend, run and byte offset).

    Raises if a byte offset reaches 2^22, where ``off<<9`` would leave
    int32.  A CUDA ``qlo`` launches kernel 4 (counted in
    ``coder_scan_off_q.launches``); a CPU ``qlo`` runs
    ``coder_scan_off_q_plain``.
    """
    _check_i32(qlo, "qlo")
    _check_i32(qhi, "qhi")
    if qlo.shape != qhi.shape or qlo.device != qhi.device:
        raise ValueError("qlo and qhi must match in shape and device")
    if not qlo.is_cuda:
        return coder_scan_off_q_plain(qlo, qhi)
    qlo, qhi = qlo.contiguous(), qhi.contiguous()
    Tq, S = qlo.shape
    dev = qlo.device
    kp = torch.empty((4 * Tq, S), dtype=torch.int32, device=dev)
    fin = torch.empty((5, S), dtype=torch.int32, device=dev)
    bad = torch.empty(S, dtype=torch.int32, device=dev)
    fn = build.load("coder_scan", "llct_coder_scan_off_q",
                    [_P] * 5 + [_I] * 2 + [_P])
    rc = fn(qlo.data_ptr(), qhi.data_ptr(), kp.data_ptr(), fin.data_ptr(),
            bad.data_ptr(), Tq, S, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "coder_scan_off_q")
    coder_scan_off_q.launches += 1
    if bool(bad.any()):
        raise RuntimeError("coder_scan_off_q: a byte offset reached 2^22")
    return kp, fin


coder_scan_off_q.launches = 0
