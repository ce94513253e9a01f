"""Kernels 3-8: the sort chain's walks, stream builder and range coders
(CUDA), and their plain versions.

Replace, in ``llcomp_tpu/pallas/encode_kernels.py``: the symbol variant's
``_make_symwalk_kernel`` (``walk_symbols``, `encode_kernels.py:175`) and
``_coder_kernel_off_q`` (``coder_scan_off_q``, `:574`), kernels 3 and 4; the
decision variant's ``_make_build_kernel`` (``build_stream``, `:74`),
``_walk_kernel`` (``walk_probs``, `:356`) and ``_coder_kernel_off``
(``coder_scan_off``, `:475`), kernels 5, 6 and 7; and the slot-record coder
``_coder_kernel`` (``coder_scan``, `:416`), kernel 8.  The walks and coders
are serial recurrences per lane.  A coder's thread owns one lane; a walk's
model resets at every context run, so kernels 3 and 6 cut each lane there
into chunks (``chunk_bounds``) walked by one thread each, and their plain
versions walk the same partition.  Arrays are lane-minor ``[T, S]``
(step-major) so that a warp's 32 lanes read and write one line per step.
The stream builder is elementwise, one thread per slot, and writes
lane-major ``[S, n*K]`` for the forward sort.  The TPU's [G, T, 8, 128]
lane groups, grid chunks and scratch carries have no counterpart.  The
source notes in ``csrc/`` say what bounds each kernel on the H100.

Kernels 3 and 5 read the codec configuration (its contexts, and its
substates a context hash): they are built once a cfg (``config.defines``,
``csrc/codec_cfg.cuh``), each build's launches counted in the wrapper's
``by_cfg``.  Kernels 4, 6, 7 and 8 read records, sorted bits or states,
which no cfg changes: one build each.  The JAX package's two kernels
hard-code rev 2's contexts and 8 substates; these do not.

A CUDA tensor launches the kernel on its device, made current for the launch
(a kernel runs on the host thread's current device), and counts the launch
on the wrapper; a CPU tensor runs the plain version.  Coder records are 10 bits,
``valid<<9 | bit<<8 | prob``; kernels 3 and 4 pair-pack them: quad q's
records 4q, 4q+1 sit in ``lo`` (``rec_{4q+1}<<10 | rec_{4q}``) and 4q+2,
4q+3 in ``hi``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import coder
from ..core import config, tables, transform
from ..core.config import REV2, CodecConfig
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
RESET_ROWS = 128        # 121 prior/seed buckets, padded as the 7-bit field


def _check_i32(t: torch.Tensor, what: str, layout: str = "[T, S]") -> None:
    if t.dim() != 2 or t.dtype != torch.int32:
        raise ValueError(f"{what} must be {layout} int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fused_table(dev) -> torch.Tensor:
    """tables.FUSED (``prob | next0<<8 | next1<<16``) as int32 on ``dev``."""
    return torch.from_numpy(tables.FUSED).to(dev)


def reset_rows(init, device) -> torch.Tensor:
    """[128] int64 model rows a context run starts from, substate k in byte
    k (``tables.pack_u64``): ``init[b]`` for bucket b < 121 and zeros beyond;
    all zeros when ``init`` is None (unprimed).  A table holds 8 substates a
    bucket: ``config.check_start`` refuses one under any other cfg."""
    rows = np.zeros(RESET_ROWS, dtype=np.int64)
    if init is not None:
        rows[: tables.PRIOR_BUCKETS] = tables.pack_u64(init)
    return torch.from_numpy(rows).to(device)


def _count(wrapper, defines: tuple[str, ...]) -> None:
    """One launch of ``wrapper``'s kernel built with ``defines``."""
    wrapper.launches += 1
    wrapper.by_cfg[defines] = wrapper.by_cfg.get(defines, 0) + 1


def chunk_bounds(seg: torch.Tensor, chunks: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walks' partition of each lane at its context runs: ``seg`` [T, S]
    bool (a run starts) -> (start, end), each [chunks, S] int64.  Chunk c
    of a lane covers entries [c*L, (c+1)*L), L = ceil(T / chunks); its walk
    starts at the first seg at or after c*L (chunk 0 at entry 0) and ends
    at the first seg at or after (c+1)*L, or at T.  So chunk c ends where
    chunk c + 1 starts, and every entry is walked by exactly one chunk."""
    T, S = seg.shape
    L = -(-T // chunks)
    t = torch.arange(T, device=seg.device)[:, None]
    nxt = torch.where(seg, t, T)          # first seg at or after t: the
    nxt = nxt.flip(0).cummin(0).values.flip(0)        # least from the end
    nxt = torch.cat([nxt, torch.full((1, S), T, device=seg.device)])
    firsts = (torch.arange(chunks, device=seg.device) * L).clamp(max=T)
    start = nxt[firsts]
    start[0] = 0
    end = torch.cat([start[1:], torch.full((1, S), T, device=seg.device)])
    return start, end


def _threads(start: torch.Tensor, end: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, list]:
    """The plain walks' threads: the (chunk, lane) pairs of ``chunk_bounds``
    with entries to walk, flat, longest walk first -> (first entry, lane,
    walk lengths), so that the threads still walking at any step are a
    prefix."""
    S = start.shape[1]
    length = (end - start).flatten()
    order = torch.argsort(length, descending=True)
    order = order[: int((length > 0).sum())]
    return start.flatten()[order], order % S, length[order].tolist()


def walk_symbols_plain(xs: torch.Tensor, K: int, init,
                       chunks: int | None = None, cfg: CodecConfig = REV2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk in plain torch over kernel 3's partition (``chunk_bounds``,
    ``chunks`` defaulting to the kernel's kChunks): vectorised over (chunk,
    lane) pairs, with Python loops over a chunk's symbols and their decisions.
    A thread's model row is ``cfg.substates`` states; each decision reads
    the state of its context (``transform.decision`` under ``cfg``) and
    writes the next, in order, as the kernel's row in registers does."""
    config.check(cfg)
    config.check_start(cfg, init is not None)
    n, S = xs.shape
    dev = xs.device
    chunks = chunks or build.constant("walk_symbols", "kChunks")
    x = xs.to(torch.int64)
    start, lane, length = _threads(
        *chunk_bounds(((x >> 12) & 1).to(torch.bool), chunks))
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    rows = torch.zeros((RESET_ROWS, cfg.substates), dtype=torch.int64,
                       device=dev)
    if init is not None:
        rows[: tables.PRIOR_BUCKETS] = torch.from_numpy(
            np.asarray(init, dtype=np.int64)).to(dev)
    row = torch.zeros((len(length), cfg.substates), dtype=torch.int64,
                      device=dev)
    qs = K // 4
    lo = torch.zeros((n * qs, S), dtype=torch.int32, device=dev)
    hi = torch.zeros_like(lo)
    r = len(length)
    for i in range(length[0] if r else 0):
        while length[r - 1] <= i:         # threads past r have ended
            r -= 1
        t = start[:r] + i
        xj = x[t, lane[:r]]
        seg = ((xj >> 12) & 1).to(torch.bool)
        row = torch.where(seg[:, None], rows[(xj >> 14) & 0x7F], row[:r])
        d = (xj & 0xFFF) - 1274
        ad = d.abs()
        e = transform.ilog2(ad.clamp(min=1), max_bits=12)
        live = (xj >> 13) & 1
        nb = (torch.where(ad != 0, 2 * e + 3, 1) * live).clamp(max=K)
        quads = [[torch.zeros_like(xj) for _ in range(2)] for _ in range(qs)]
        for k in range(int(nb.max()) if nb.numel() else 0):
            ctx, bit = transform.decision(k, d, ad, e, cfg)
            valid = nb > k
            st = row.gather(1, ctx[:, None])[:, 0]
            f = fused[st]
            ns = torch.where(bit == 1, f >> 16, f >> 8) & 0xFF
            row.scatter_(1, ctx[:, None], torch.where(valid, ns, st)[:, None])
            rec = torch.where(valid, (1 << 9) | (bit << 8) | (f & 0xFF), 0)
            quads[k // 4][k % 4 >= 2] |= rec << (10 * (k % 2))
        for q in range(qs):
            lo[t * qs + q, lane[:r]] = quads[q][0].to(torch.int32)
            hi[t * qs + q, lane[:r]] = quads[q][1].to(torch.int32)
    return lo, hi


def walk_symbols(xs: torch.Tensor, K: int = 24, init=None,
                 cfg: CodecConfig = REV2
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk each lane's context-sorted symbols: ``xs`` [n, S] int32
    (``bucket<<14 | live<<13 | seg<<12 | diff+1274``, ``encode.stage_sym_sort``)
    -> pair-packed coder records (lo, hi), each [n*K/4, S] int32, K/4 quads
    per symbol, each decision coded on its context under ``cfg``.

    A context run (``seg``) starts from zeros, or from ``init[bucket]`` when
    ``init`` (a [121, 8] u8 prior or seed table, 8 substates only) is given.
    At most K decisions of a symbol are walked; records past its last
    decision are 0.  A CUDA ``xs`` launches kernel 3 built for ``cfg``
    (counted in ``walk_symbols.launches`` and, under the build's defines,
    in ``walk_symbols.by_cfg``; a build that fails raises
    ``build.KernelCompileError``); a CPU ``xs`` runs ``walk_symbols_plain``.
    """
    _check_i32(xs, "xs")
    if K < 4 or K % 4:
        raise ValueError(f"K must be a positive multiple of 4, got {K}")
    config.check(cfg)
    config.check_start(cfg, init is not None)
    if not xs.is_cuda:
        return walk_symbols_plain(xs, K, init, cfg=cfg)
    defines = config.defines(cfg)
    xs = xs.contiguous()
    n, S = xs.shape
    dev = xs.device
    fn = build.load("walk_symbols", "llct_walk_symbols",
                    [_P] * 5 + [_I] * 3 + [_P], defines)
    with torch.cuda.device(dev):
        fused = _fused_table(dev)
        rows = reset_rows(init, dev)
        lo = torch.empty((n * K // 4, S), dtype=torch.int32, device=dev)
        hi = torch.empty_like(lo)
        rc = fn(xs.data_ptr(), fused.data_ptr(), rows.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), n, S, K, _stream(dev))
    build.check(rc, "walk_symbols")
    _count(walk_symbols, defines)
    return lo, hi


walk_symbols.launches = 0
walk_symbols.by_cfg = {}      # config.defines(cfg) -> launches of that build


def build_stream_plain(hash_: torch.Tensor, diff: torch.Tensor, n_sym: int,
                       K: int, cfg: CodecConfig = REV2) -> torch.Tensor:
    """The stream builder in plain torch: elementwise over (lane, symbol),
    one ``transform.decision`` under ``cfg`` per slot."""
    config.check(cfg)
    S, n_pad = hash_.shape
    ad = diff.abs()
    e = transform.ilog2(ad.clamp(min=1), max_bits=12)
    live = torch.arange(n_pad, device=hash_.device) < n_sym
    nb = torch.where(live, torch.where(ad != 0, 2 * e + 3, 1), 0)
    slots = []
    for k in range(K):
        ctx, bit = transform.decision(k, diff, ad, e, cfg)
        slots.append(torch.where(
            nb > k, (hash_ * cfg.substates + ctx) * 2 + bit, -1)
            .to(torch.int32))
    return torch.stack(slots, dim=2).reshape(S, n_pad * K)


def build_stream(hash_: torch.Tensor, diff: torch.Tensor, n_sym: int,
                 K: int = 24, cfg: CodecConfig = REV2) -> torch.Tensor:
    """Expand each lane's symbols into K decision slots: ``hash_``, ``diff``
    [S, n_pad] int32 lane-major (folded context hash and residual; symbols
    at or past ``n_sym`` are padding) -> [S, n_pad*K] int32 lane-major, slot
    k of symbol j at ``j*K + k``: ``(hash*substates + ctx)*2 + bit`` of the
    symbol's decision k under ``cfg``, -1 past its last decision (so K
    below its count cuts it short) and on padding symbols.

    A CUDA ``hash_`` launches kernel 5 built for ``cfg`` (counted in
    ``build_stream.launches`` and in ``build_stream.by_cfg``; a build that
    fails raises ``build.KernelCompileError``); a CPU ``hash_`` runs
    ``build_stream_plain``.
    """
    _check_i32(hash_, "hash", "[S, n]")
    _check_i32(diff, "diff", "[S, n]")
    if hash_.shape != diff.shape or hash_.device != diff.device:
        raise ValueError("hash and diff must match in shape and device")
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    config.check(cfg)
    if not hash_.is_cuda:
        return build_stream_plain(hash_, diff, n_sym, K, cfg)
    defines = config.defines(cfg)
    hash_, diff = hash_.contiguous(), diff.contiguous()
    S, n_pad = hash_.shape
    dev = hash_.device
    fn = build.load("build_stream", "llct_build_stream",
                    [_P] * 3 + [_I] * 4 + [_P], defines)
    with torch.cuda.device(dev):
        out = torch.empty((S, n_pad * K), dtype=torch.int32, device=dev)
        rc = fn(hash_.data_ptr(), diff.data_ptr(), out.data_ptr(), S, n_pad,
                n_sym, K, _stream(dev))
    build.check(rc, "build_stream")
    _count(build_stream, defines)
    return out


build_stream.launches = 0
build_stream.by_cfg = {}      # config.defines(cfg) -> launches of that build


def walk_probs_plain(xs: torch.Tensor, chunks: int | None = None
                     ) -> torch.Tensor:
    """The state walk in plain torch over kernel 6's partition
    (``chunk_bounds``, ``chunks`` defaulting to the kernel's kChunks):
    vectorised over (chunk, lane) pairs, with a Python loop over a chunk's
    decisions."""
    T, S = xs.shape
    dev = xs.device
    chunks = chunks or build.constant("walk_probs", "kChunks")
    start, lane, length = _threads(*chunk_bounds((xs & 2) != 0, chunks))
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    st = torch.zeros(len(length), dtype=torch.int64, device=dev)
    probs = torch.empty((T, S), dtype=torch.int32, device=dev)
    r = len(length)
    for i in range(length[0] if r else 0):
        while length[r - 1] <= i:         # threads past r have ended
            r -= 1
        t = start[:r] + i
        x = xs[t, lane[:r]]
        st = torch.where((x & 2) != 0, 0, st[:r])
        f = fused[st]
        probs[t, lane[:r]] = (f & 0xFF).to(torch.int32)
        st = torch.where((x & 1) != 0, f >> 16, f >> 8) & 0xFF
    return probs


def walk_probs(xs: torch.Tensor) -> torch.Tensor:
    """Walk each lane's context-sorted decisions through the 128-state
    machine: ``xs`` [T, S] int32 (``bit | seg<<1``, ``encode.stage_walk_xs``)
    -> the coding probability of every entry, [T, S] int32.  The state
    resets to 0 where ``seg`` is set (a new context).

    A CUDA ``xs`` launches kernel 6 (counted in ``walk_probs.launches``); a
    CPU ``xs`` runs ``walk_probs_plain``.
    """
    _check_i32(xs, "xs")
    if not xs.is_cuda:
        return walk_probs_plain(xs)
    xs = xs.contiguous()
    T, S = xs.shape
    dev = xs.device
    fn = build.load("walk_probs", "llct_walk_probs", [_P] * 3 + [_I] * 2 + [_P])
    with torch.cuda.device(dev):
        fused = _fused_table(dev)
        probs = torch.empty((T, S), dtype=torch.int32, device=dev)
        rc = fn(xs.data_ptr(), fused.data_ptr(), probs.data_ptr(), T, S,
                _stream(dev))
    build.check(rc, "walk_probs")
    walk_probs.launches += 1
    return probs


walk_probs.launches = 0


# --- the range coders (kernels 4, 7 and 8) ----------------------------------


def _plain_start(S: int, dev) -> tuple[torch.Tensor, ...]:
    """(low, rng, pend, run) of ``S`` fresh coders, int64."""
    z = torch.zeros(S, dtype=torch.int64, device=dev)
    return z, z + 0xFF00, z - 1, z


def _plain_step(state, x: torch.Tensor):
    """Code one record ``valid<<9 | bit<<8 | prob`` per lane (``x`` [S]):
    -> (new state, (emit, carry, head, run before the step)), the flush
    record of ``coder.shift_step``."""
    low, rng, pend, run = state
    prob, one, valid = x & 0xFF, (x & 0x100) != 0, (x & 0x200) != 0
    range1 = (rng * prob) >> 8
    low = torch.where(one & valid, low + rng - range1, low)
    rng = torch.where(valid, torch.where(one, range1, rng - range1), rng)
    return coder.shift_step(low, rng, pend, run, valid & (rng < 0x100))


def _raise_on_offsets(bad: torch.Tensor, what: str) -> None:
    if bool(bad.any()):
        raise RuntimeError(f"{what}: a byte offset reached 2^22")


def _plain_off(record, T: int, S: int, dev, what: str
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels 4 and 7 in plain torch, vectorised over lanes, with a Python
    loop over decisions: ``record(t)`` gives decision t's records [S]."""
    state = _plain_start(S, dev)
    off = torch.zeros(S, dtype=torch.int64, device=dev)
    bad = torch.zeros(S, dtype=torch.bool, device=dev)
    kp = torch.empty((T, S), dtype=torch.int32, device=dev)
    for t in range(T):
        state, (emit, carry, head, flushed) = _plain_step(state, record(t))
        kp[t] = coder.kp_record(emit, carry, head, off)
        bad |= emit & (off >= coder.OFF_LIMIT)
        off = torch.where(emit, off + 1 + flushed, off)
    _raise_on_offsets(bad, what)
    return kp, torch.stack([*state, off]).to(torch.int32)


def _launch_off(entry: str, inputs: tuple, steps: int, T: int, S: int, dev
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel 4 or 7 (the C entry ``entry``) over ``steps`` input
    rows -> (kp [T, S], fin [5, S], per-lane offset error flags)."""
    fn = build.load("coder_scan", entry,
                    [_P] * (len(inputs) + 3) + [_I] * 2 + [_P])
    with torch.cuda.device(dev):
        kp = torch.empty((T, S), dtype=torch.int32, device=dev)
        fin = torch.empty((5, S), dtype=torch.int32, device=dev)
        bad = torch.empty(S, dtype=torch.int32, device=dev)
        rc = fn(*(t.data_ptr() for t in inputs), kp.data_ptr(),
                fin.data_ptr(), bad.data_ptr(), steps, S, _stream(dev))
    build.check(rc, entry)
    return kp, fin, bad


def coder_scan_off_q_plain(qlo: torch.Tensor, qhi: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The quad coder in plain torch (``coder.shift_step`` for each
    renormalisation)."""
    Tq, S = qlo.shape
    words = (qlo.to(torch.int64), qhi.to(torch.int64))
    return _plain_off(
        lambda t: (words[(t >> 1) & 1][t >> 2] >> (10 * (t & 1))) & 0x3FF,
        4 * Tq, S, qlo.device, "coder_scan_off_q")


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
    kp, fin, bad = _launch_off("llct_coder_scan_off_q", (qlo, qhi), Tq,
                               4 * Tq, S, qlo.device)
    coder_scan_off_q.launches += 1
    _raise_on_offsets(bad, "coder_scan_off_q")
    return kp, fin


coder_scan_off_q.launches = 0


def coder_scan_off_plain(xs: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The record coder in plain torch (``coder.shift_step`` for each
    renormalisation)."""
    T, S = xs.shape
    return _plain_off(lambda t: xs[t].to(torch.int64), T, S, xs.device,
                      "coder_scan_off")


def coder_scan_off(xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Range-code each lane's records in stream order, one per word: ``xs``
    [T, S] int32 (``valid<<9 | bit<<8 | prob``, dead records 0,
    ``encode.stage_back_sort``) -> (kp [T, S] int32 and fin [5, S] int32, as
    ``coder_scan_off_q`` gives them).

    Raises if a byte offset reaches 2^22.  A CUDA ``xs`` launches kernel 7
    (counted in ``coder_scan_off.launches``); a CPU ``xs`` runs
    ``coder_scan_off_plain``.
    """
    _check_i32(xs, "xs")
    if not xs.is_cuda:
        return coder_scan_off_plain(xs)
    xs = xs.contiguous()
    T, S = xs.shape
    kp, fin, bad = _launch_off("llct_coder_scan_off", (xs,), T, T, S,
                               xs.device)
    coder_scan_off.launches += 1
    _raise_on_offsets(bad, "coder_scan_off")
    return kp, fin


coder_scan_off.launches = 0


def coder_scan_plain(xs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot-record coder in plain torch (``coder.shift_step`` for each
    renormalisation)."""
    T, S = xs.shape
    dev = xs.device
    state = _plain_start(S, dev)
    meta = torch.empty((T, S), dtype=torch.int32, device=dev)
    runs = torch.empty_like(meta)
    for t in range(T):
        state, (emit, carry, head, flushed) = _plain_step(
            state, xs[t].to(torch.int64))
        meta[t] = coder.slot_meta(emit, carry, head)
        runs[t] = flushed
    return meta, runs, torch.stack(state).to(torch.int32)


def coder_scan(xs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range-code each lane's records in stream order into slot records:
    ``xs`` [T, S] int32 (as ``coder_scan_off`` reads it) -> (meta [T, S]
    int32, ``emit | carry<<1 | head<<8`` of each step's shift; runs [T, S]
    int32, the deferred run before each step, emitting or not; fin [4, S]
    int32, the final low, rng, pend and run).  ``coder.finish_steps`` and
    ``coder.expand_slots`` turn them into bytes.

    A CUDA ``xs`` launches kernel 8 (counted in ``coder_scan.launches``); a
    CPU ``xs`` runs ``coder_scan_plain``.
    """
    _check_i32(xs, "xs")
    if not xs.is_cuda:
        return coder_scan_plain(xs)
    xs = xs.contiguous()
    T, S = xs.shape
    dev = xs.device
    fn = build.load("coder_scan", "llct_coder_scan", [_P] * 4 + [_I] * 2 + [_P])
    with torch.cuda.device(dev):
        meta = torch.empty((T, S), dtype=torch.int32, device=dev)
        runs = torch.empty_like(meta)
        fin = torch.empty((4, S), dtype=torch.int32, device=dev)
        rc = fn(xs.data_ptr(), meta.data_ptr(), runs.data_ptr(),
                fin.data_ptr(), T, S, _stream(dev))
    build.check(rc, "coder_scan")
    coder_scan.launches += 1
    return meta, runs, fin


coder_scan.launches = 0
