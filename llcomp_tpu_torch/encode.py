"""Lane encoding: ``[S, H, W, C]`` u8 stripes -> one rev-2 stream per lane.

Two engines give the same bytes:

* ``"fused"`` (default): port of the fused branch of ``encode_lanes`` in
  ``llcomp_tpu/encode.py`` (`encode.py:979-1031`, ``_encode_lanes_fused``,
  ``_outcap``) and of its precompute (``_stage_precompute_g``,
  ``_apply_rct``, ``_stage_xs_fused``, `encode.py:213-290,691-696`).  The
  precompute runs as torch ops on the lanes' device; kernel 1
  (``kernels.encode_fused``) codes the streams.  Each lane's output is sized
  at ``outcap`` (raw * 1.5 + 64, the coder's hard bound), so the TPU path's
  overflow fallback, cap ladder and marker expansion have no counterpart.
* ``"sort"``: the symbol-granular sort chain, the JAX package's
  ``engine="pallas"`` (`encode.py:1030-1059`, the symbol branch of
  ``_launch_stage_rest`` with ``_stage_sym_sort``, ``_stage_compact``,
  ``_collect_bytes``; `encode.py:341-418,546-659`).  Symbols are sorted by
  context, kernel 3 (``kernels.encode_kernels.walk_symbols``) walks each
  context's run with a one-row model, a second sort puts the records back in
  stream order, and kernel 4 (``coder_scan_off_q``) range-codes them.  The
  sorts are torch ops.  The live-quad count Tq is exact (the JAX bucketing
  only bounded its recompiles), and the TPU HBM slot budget is part of the
  lane-chunk budget.

  Its second variant, ``variant="decision"`` (the JAX package's
  ``LLCT_ENCODE_VARIANT=decision``, the else branch of
  ``_launch_stage_rest``, `encode.py:557-601`, with ``_stage_fwd_sort``,
  ``_stage_walk_xs``, ``_stage_back_sort``; `encode.py:311-338,421-442`),
  sorts decisions instead of symbols: kernel 5 (``build_stream``) expands
  each symbol into K decision slots, a sort orders them by (context,
  position), kernel 6 (``walk_probs``) walks each context's run with one
  state, a second sort restores stream order, and kernel 7
  (``coder_scan_off``) range-codes them.  It takes unprimed lanes only, and
  its decision prefix Tc is the exact count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import coder
from . import device as devmod
from . import profiling
from .core import tables, transform
from .core.config import REV2, CodecConfig
from .kernels.encode_fused import encode_fused_async
from .kernels.encode_kernels import (build_stream, coder_scan_off,
                                     coder_scan_off_q, walk_probs,
                                     walk_symbols)

# Device bytes one chunk of lanes may hold (``lane_bytes`` sizes a lane).
LANE_BUDGET_BYTES = 8 << 30
MAX_INFLIGHT = 2       # pieces of the fused engine a device holds at once
ENGINES = ("fused", "sort")
VARIANTS = ("symbol", "decision")     # the sort engine's two chains
MAX_SLOTS = 24            # decisions per symbol at most (2 * 10 + 3, rounded)
# Peak device bytes of the sort chain per decision slot (n_sym * K a lane):
# the walk's int32 records, their int64 copies, the compact key and its
# sort's values, indices and scratch.  An H100 peaked at 20.9 B per slot
# (1,024 lanes x 12,288 symbols, K = 20, the per-symbol arrays included);
# chip_smoke.py checks a full chunk against ``lane_bytes``.
SORT_SLOT_BYTES = 22
# Peak device bytes of the decision variant per decision slot (n_sym * K a
# lane), set by the forward sort: the int32 stream, its int64 key and the
# sort's int64 values, int64 indices and scratch.  An H100 peaked at 52.3 B
# per slot (256 and 1,024 lanes x 12,288 symbols, K = 24); chip_smoke.py
# checks a full chunk against ``lane_bytes``.
DECISION_SLOT_BYTES = 54
SLOT_LIMIT = 1 << 25      # n_sym * 24 below this: the compact key's 23 bits
POS_LIMIT = 1 << 20       # decision variant: n_sym * K below this (20-bit pos)
OUTCAP_LIMIT = 1 << 21    # outcap below this: the byte offsets' bound
_DEAD_HASH = 0x1FFF       # symbol padding sorts after every context run
_BIG = 1 << 22            # forward-sort context of a padding slot
_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def outcap(n_sym: int) -> int:
    """Per-lane compressed-size bound, bucketed (raw + raw/2 + 64)."""
    return -(-(n_sym + n_sym // 2 + 64) // 1024) * 1024


def lane_bytes(n_sym: int, engine: str, variant: str = "symbol") -> int:
    """Device bytes one lane of ``n_sym`` symbols holds at the engine's peak.
    Fused: model rows, packed symbols (two layouts), output row and
    precompute temporaries.  Sort: ``SORT_SLOT_BYTES`` (symbol variant) or
    ``DECISION_SLOT_BYTES`` (decision variant) per slot at the largest K,
    the per-symbol arrays and the output row."""
    if engine == "sort":
        per_slot = (DECISION_SLOT_BYTES if variant == "decision"
                    else SORT_SLOT_BYTES)
        return per_slot * MAX_SLOTS * n_sym + 64 * n_sym + outcap(n_sym)
    return REV2.num_states + 56 * n_sym + outcap(n_sym)


def lanes_per_chunk(n_sym: int, engine: str, variant: str = "symbol") -> int:
    """Lanes of ``n_sym`` symbols that one chunk of ``encode_lanes`` codes
    at once: as many as ``LANE_BUDGET_BYTES`` holds, at least one."""
    return max(1, LANE_BUDGET_BYTES // lane_bytes(n_sym, engine, variant))


def _hash_diff(imgs: torch.Tensor, cfg: CodecConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 lanes [S, H, W, C] -> folded (hash, diff) int32 [S, H*W*C]."""
    h, diff = transform.context_and_residual(transform.rct_forward(imgs), cfg)
    S = imgs.shape[0]
    return h.reshape(S, -1), diff.reshape(S, -1)


def precompute(imgs: torch.Tensor, cfg: CodecConfig = REV2) -> torch.Tensor:
    """u8 lanes [S, H, W, C] -> int32 packed symbols [S, H*W*C] in stream
    order: ``live<<25 | hash<<12 | (diff + 1274)``, hash and diff sign-folded
    (every symbol is live: the port pads no symbols)."""
    h, diff = _hash_diff(imgs, cfg)
    return (1 << 25) | (h << 12) | (diff + 1274)


def _start_table(primed: bool, seed):
    """[121, 8] u8 model start table: the stored seed, the static prior, or
    None (zeros).  A seed promotes ``primed``.  A seed must hold states of
    the 128-state machine: a larger value would index past every state
    table."""
    if seed is not None:
        tab = np.ascontiguousarray(seed, dtype=np.uint8)
        if tab.shape != (tables.PRIOR_BUCKETS, 8):
            raise ValueError(f"seed must be [121, 8], got {tab.shape}")
        if tab.max(initial=0) > 127:
            raise ValueError(f"seed holds state {tab.max()}, above 127")
        return tab
    return tables.PRIOR_TAB if primed else None


# --- the sort chain ---------------------------------------------------------


def check_sort_bounds(n_sym: int) -> None:
    """Raise ValueError for a stripe outside the sort chain's format bounds
    (`encode.py:801-812`): n_sym * 24 < 2^25 decision slots per lane and
    outcap < 2^21 bytes."""
    if n_sym * MAX_SLOTS >= SLOT_LIMIT:
        raise ValueError(f"a stripe of {n_sym} symbols breaks the sort "
                         f"chain's slot bound n_sym*24 < 2^25")
    if outcap(n_sym) >= OUTCAP_LIMIT:
        raise ValueError(f"a stripe of {n_sym} symbols breaks the sort "
                         f"chain's byte bound outcap < 2^21")


def stage_count(diff: torch.Tensor) -> tuple[int, int, int]:
    """Decision counts from residuals ``diff`` [S, n] (`encode.py:293-308`):
    (most decisions in a lane, most decisions of one symbol, most quads in a
    lane, where a symbol holds ceil(decisions / 4) quads).  One host sync."""
    ad = diff.abs()
    e = transform.ilog2(ad.clamp(min=1), max_bits=12)
    nb = torch.where(ad != 0, 2 * e + 3, 1).to(torch.int64)
    counts = torch.stack([nb.sum(dim=1).max(), nb.max(),
                          ((nb + 3) >> 2).sum(dim=1).max()])
    total, per_sym, quads = counts.tolist()
    return total, per_sym, quads


def slots_per_symbol(sym_max: int) -> int:
    """K: decisions walked per symbol, a multiple of 4 (one quad) covering
    the most any symbol has (`encode.py:566`)."""
    return min(MAX_SLOTS, max(4, -(-sym_max // 4) * 4))


def stage_sym_sort(hash_: torch.Tensor, diff: torch.Tensor, n_sym: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each lane's symbols by (context hash, position)
    (``_stage_sym_sort``, `encode.py:341-370`).

    hash_, diff [S, n_pad] int32, lane-major; symbols at or past ``n_sym``
    are padding.  The sort key is the int64 ``hash<<42 | sympos<<12 |
    diff+1274``, padding with hash 0x1FFF so that it sorts last and is dead.
    -> (xs [n_pad, S] int32, lane-minor as kernel 3 reads it:
    ``bucket<<14 | live<<13 | seg<<12 | diff+1274`` with bucket = hash % 121
    and seg set where a context run starts; origsym [S, n_pad] int32, each
    sorted symbol's stream position, lane-major as ``stage_compact`` sorts).
    """
    n_pad = hash_.shape[1]
    sym = torch.arange(n_pad, device=hash_.device, dtype=torch.int64)
    h64 = torch.where(sym < n_sym, hash_.to(torch.int64), _DEAD_HASH)
    key = (h64 << 42) | (sym << 12) | (diff.to(torch.int64) + 1274)
    s = torch.sort(key, dim=1).values
    h_s = s >> 42
    origsym = ((s >> 12) & ((1 << 30) - 1)).to(torch.int32)
    prev = torch.cat([torch.full_like(h_s[:, :1], -2), h_s[:, :-1]], dim=1)
    xs = ((h_s % tables.PRIOR_BUCKETS) << 14
          | (h_s != _DEAD_HASH).to(torch.int64) << 13
          | (h_s != prev).to(torch.int64) << 12
          | (s & 0xFFF))
    return xs.to(torch.int32).t().contiguous(), origsym


def stage_compact(lo: torch.Tensor, hi: torch.Tensor, origsym: torch.Tensor,
                  K: int, Tq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Put kernel 3's records back in stream order and front-pack the live
    quads (``_stage_compact``, `encode.py:373-418`).

    lo, hi [n_pad*K/4, S] int32 (kernel 3's quads, context-sorted);
    origsym [S, n_pad] the sorted symbols' stream positions.  A symbol's
    live records are a prefix of its K, so a quad is live when its first
    record is.  Each quad becomes the int64 key ``slotquad<<40 | hi<<20 |
    lo`` (slotquad = origsym * K/4 + quad), dead quads INT64_MAX; one sort
    per lane restores stream order with the live quads in front, and the
    first ``Tq`` are kept.  -> (qlo, qhi) [Tq, S] int32, lane-minor as
    kernel 4 reads them, dead quads 0.
    """
    S, n_pad = origsym.shape
    qs = K // 4
    lo64 = lo.t().reshape(S, n_pad, qs).to(torch.int64)
    hi64 = hi.t().reshape(S, n_pad, qs).to(torch.int64)
    quad = torch.arange(qs, device=lo.device, dtype=torch.int64)
    slotquad = origsym.to(torch.int64)[:, :, None] * qs + quad
    key = torch.where((lo64 & (1 << 9)) != 0,
                      (slotquad << 40) | (hi64 << 20) | lo64, _INT64_MAX)
    del lo64, hi64, slotquad
    s = torch.sort(key.reshape(S, n_pad * qs), dim=1).values[:, :Tq]
    dead = s == _INT64_MAX
    qlo = torch.where(dead, 0, s & 0xFFFFF).to(torch.int32)
    qhi = torch.where(dead, 0, (s >> 20) & 0xFFFFF).to(torch.int32)
    return qlo.t().contiguous(), qhi.t().contiguous()


def decision_slots(sym_max: int) -> int:
    """K of the decision variant: 8, 16 or 24 slots per symbol, the first
    covering the most decisions any symbol has (`encode.py:568`)."""
    return 8 if sym_max <= 8 else 16 if sym_max <= 16 else 24


def check_decision_bounds(n_sym: int, K: int) -> None:
    """Raise ValueError for a stripe whose ``n_sym * K`` decision slots
    reach 2^20: the forward sort keeps a slot's position in 20 bits
    (`encode.py:330-336`), and a larger one would run into its context.
    The JAX package is kept inside only by its default slot budget
    (``fits_pallas_budget``, `encode.py:809-812`)."""
    if n_sym * K >= POS_LIMIT:
        raise ValueError(f"a stripe of {n_sym} symbols at K {K} breaks the "
                         f"decision variant's position bound n_sym*K < 2^20")


def stage_fwd_sort(stream: torch.Tensor, Tc: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each lane's decision slots by (context, position) and keep the
    first ``Tc`` (``_stage_fwd_sort`` and the Tc cut, `encode.py:311-338,
    596-597`).

    stream [S, T] int32 lane-major (``build_stream``, padding -1), T < 2^20.
    Each slot becomes the int64 key ``ctx<<21 | pos<<1 | bit`` with ctx =
    stream >> 1 (hash*8 + substate) and 2^40 for padding, which sorts last;
    keys are unique, so the order is total.  -> (skey, spay) [S, Tc] int32,
    lane-major: the context (``_BIG`` for padding) and ``bit<<20 | pos``.
    """
    T = stream.shape[1]
    key = (stream >> 1).to(torch.int64)
    key.masked_fill_(stream < 0, 1 << 40)
    key <<= 21
    key |= torch.arange(T, device=stream.device, dtype=torch.int64) << 1
    key |= stream & 1
    s = torch.sort(key, dim=1).values[:, :Tc]
    del key
    ctx = s >> 21
    skey = torch.where(ctx >= POS_LIMIT, _BIG, ctx).to(torch.int32)
    spay = (((s & 1) << 20) | ((s >> 1) & (POS_LIMIT - 1))).to(torch.int32)
    return skey, spay


def stage_walk_xs(skey: torch.Tensor, spay: torch.Tensor) -> torch.Tensor:
    """Kernel 6's input (``_stage_walk_xs``, `encode.py:421-427`): ``bit |
    seg<<1`` per sorted slot, seg set where the context differs from the
    slot before (always on the first).  skey, spay [S, Tc] -> [Tc, S] int32,
    lane-minor."""
    prev = torch.cat([torch.full_like(skey[:, :1], -2), skey[:, :-1]], dim=1)
    xs = ((spay >> 20) & 1) | ((skey != prev).to(torch.int32) << 1)
    return xs.t().contiguous()


def stage_back_sort(skey: torch.Tensor, spay: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    """Put the walked slots back in stream order, live slots in front
    (``_stage_back_sort``, `encode.py:430-442`).

    skey, spay [S, Tc] lane-major; probs [Tc, S] (kernel 6's output).  Each
    live slot becomes the int32 key ``pos<<9 | bit<<8 | prob``, padding
    ``1<<30``; one sort per lane.  -> the coder's records [Tc, S] int32,
    lane-minor: ``valid<<9 | bit<<8 | prob``, dead records 0.
    """
    pay = (probs.t() & 0xFF) | (((spay >> 20) & 1) << 8)
    key = torch.where(skey < _BIG, ((spay & (POS_LIMIT - 1)) << 9) | pay,
                      1 << 30)
    s = torch.sort(key, dim=1).values
    return torch.where(s < (1 << 30), (s & 0x1FF) | (1 << 9), 0).t().contiguous()


def _no_hook(stage: str, *made) -> None:
    pass


def _finish_bytes(kp: torch.Tensor, fin: torch.Tensor, cap: int, stage_done
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Offset-packed records and final carries -> (bytes [S, width] u8,
    lens [S] int32), expanded at the longest stream once the lengths are
    synced (``_stage_finish``, ``_collect_bytes``, `encode.py:445-461,
    626-643`)."""
    kp_fin, lens = coder.finish_steps_off(fin)
    width = int(lens.max())
    if width > cap:      # cannot happen for the rev-2 coder
        raise RuntimeError(f"stream overflow: {width} > bound {cap}")
    out = coder.expand_kp(kp, kp_fin, width)
    stage_done("finish and expansion", out, lens)
    return out, lens


def _encode_sort(lanes: torch.Tensor, cfg: CodecConfig, init, cap: int,
                 stage_done=_no_hook):
    """The sort chain on one chunk of lanes (the symbol branch of
    ``_launch_stage_rest`` with ``_collect_bytes``, `encode.py:546-643`):
    the records are expanded at the longest stream once the lengths are
    synced.  -> (bytes [S, width] u8, lens [S] int32).

    ``stage_done(stage, *made)`` is called after each of the six stages
    with what it made; ``chip_smoke.py`` times the stages and holds the
    kernels against their plain versions through it."""
    timed = profiling.timed
    h, diff = timed("encode/precompute", _hash_diff, lanes, cfg)
    _, sym_max, quad_max = stage_count(diff)
    K = slots_per_symbol(sym_max)
    stage_done("precompute and counts", K, quad_max)
    xs, origsym = timed("encode/sym_sort", stage_sym_sort, h, diff,
                        h.shape[1])
    stage_done("sym sort", xs, origsym)
    lo, hi = timed("encode/walk", walk_symbols, xs, K, init)
    stage_done("walk", lo, hi)
    qlo, qhi = timed("encode/compact_sort", stage_compact, lo, hi, origsym,
                     K, quad_max)
    stage_done("compact sort", qlo, qhi)
    kp, fin = timed("encode/coder", coder_scan_off_q, qlo, qhi)
    stage_done("coder", kp, fin)
    return timed("encode/finish", _finish_bytes, kp, fin, cap, stage_done)


def _encode_decision(lanes: torch.Tensor, cfg: CodecConfig, init, cap: int,
                     stage_done=_no_hook):
    """The decision variant of the sort chain on one chunk of unprimed lanes
    (``init`` is None; the else branch of ``_launch_stage_rest`` with
    ``_collect_bytes``, `encode.py:557-601,626-643`).  The decision prefix
    Tc is the exact count: JAX buckets it only to bound its recompiles, and
    the dead entries past the count code as silent.  Raises ValueError past
    ``check_decision_bounds``.  -> (bytes [S, width] u8, lens [S] int32).

    ``stage_done`` as in ``_encode_sort``, after each of the eight stages."""
    h, diff = profiling.timed("encode/precompute", _hash_diff, lanes, cfg)
    total, sym_max, _ = stage_count(diff)
    K = decision_slots(sym_max)
    n_sym = h.shape[1]
    check_decision_bounds(n_sym, K)
    stage_done("precompute and counts", K, total, h, diff)
    stream = build_stream(h, diff, n_sym, K)
    stage_done("build", stream)
    skey, spay = stage_fwd_sort(stream, total)
    del stream
    stage_done("fwd sort", skey, spay)
    xs = stage_walk_xs(skey, spay)
    stage_done("walk xs", xs)
    probs = walk_probs(xs)
    del xs
    stage_done("walk", probs)
    coder_xs = stage_back_sort(skey, spay, probs)
    del skey, spay, probs
    stage_done("back sort", coder_xs)
    kp, fin = profiling.timed("encode/coder", coder_scan_off, coder_xs)
    del coder_xs
    stage_done("coder", kp, fin)
    return profiling.timed("encode/finish", _finish_bytes, kp, fin, cap,
                           stage_done)


def _streams(out: np.ndarray, lens: np.ndarray) -> list[bytes]:
    """Rows of ``out`` [S, >= max(lens)] u8 cut at ``lens`` -> bytes."""
    return [out[s, : lens[s]].tobytes() for s in range(out.shape[0])]


def _check_args(cfg: CodecConfig, engine: str, variant: str, primed: bool,
                seed) -> None:
    if cfg != REV2:
        raise ValueError("llcomp_tpu_torch supports the rev-2 cfg only")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "decision" and engine != "sort":
        raise ValueError("variant='decision' is a chain of engine='sort'")
    if variant == "decision" and (primed or seed is not None):
        raise ValueError("variant='decision' walks every context from state "
                         "0: it takes no primed or seeded lanes")


def _as_lanes(imgs) -> np.ndarray:
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    if imgs.ndim != 4:
        raise ValueError(f"expected lanes [S, H, W, C], got {imgs.shape}")
    return imgs


def encode_lanes(imgs, cfg: CodecConfig = REV2, primed: bool = False,
                 seed=None, device="cuda", engine: str = "fused",
                 variant: str = "symbol") -> list[bytes]:
    """Encode equal-shaped lanes [S, H, W, C] u8 -> per-lane headerless
    rev-2 streams.

    primed: context row h starts at tables.PRIOR_TAB[h % 121] (sliced
    container flag bit 0).  seed: a [121, 8] u8 stored-seed table (flag
    bit 1) used instead.  device: 'cuda' (the kernels) or 'cpu' (their
    plain versions).  engine: 'fused' (kernel 1) or 'sort', the counterpart
    of the JAX package's engine='pallas' (kernels 3 and 4; raises
    ValueError for a stripe past its format bounds).  Both give the same
    bytes.  variant: the sort engine's chain, 'symbol' (kernels 3 and 4) or
    'decision' (kernels 5-7), the counterpart of the JAX package's
    LLCT_ENCODE_VARIANT=decision, for unprimed, unseeded lanes only (raises
    ValueError otherwise); same bytes.  The fused engine codes the lanes
    as one batch of ``encode_lanes_pipelined``, whose chunks overlap their
    copies with the kernel; the sort engine codes its chunks in turn.
    """
    _check_args(cfg, engine, variant, primed, seed)
    dev = devmod.resolve(device)
    imgs = _as_lanes(imgs)
    if engine == "fused":
        return encode_lanes_pipelined([imgs], cfg, primed, seed, dev)[0]
    S = imgs.shape[0]
    n_sym = int(np.prod(imgs.shape[1:]))
    cap = outcap(n_sym)
    init = _start_table(primed, seed)
    check_sort_bounds(n_sym)
    run = _encode_sort if variant == "symbol" else _encode_decision
    chunk = lanes_per_chunk(n_sym, engine, variant)
    streams: list[bytes] = []
    for c0 in range(0, S, chunk):
        lanes = profiling.timed("encode/upload", torch.from_numpy(
            imgs[c0 : c0 + chunk]).to, dev)
        out, lens = run(lanes, cfg, init, cap)
        lens_h = lens.cpu().numpy()
        width = int(lens_h.max(initial=0))
        streams.extend(_streams(profiling.timed(
            "encode/download", _to_host, out[:, :width]), lens_h))
    return streams


# --- several batches, overlapped ---------------------------------------------


def pipeline_fits(n_sym: int) -> bool:
    """True iff a lane of ``n_sym`` symbols fits one chunk of the fused
    engine's budget, so that ``encode_lanes_pipelined`` can hold it in
    flight beside others (`encode.py:788-798` of the JAX package, whose
    limits were the TPU's VMEM and slot budgets)."""
    return lane_bytes(n_sym, "fused") <= LANE_BUDGET_BYTES


def _fused_input(lanes: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Kernel 1's input: the packed symbols of ``lanes``, symbol-major."""
    return precompute(lanes, cfg).t().contiguous()


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _launch_piece(lanes: np.ndarray, cfg: CodecConfig, init,
                  dev: torch.device, stream):
    """Start one piece of lanes [S, H, W, C] u8 through the fused engine on
    ``dev`` and ``stream`` (None: the current stream), both made current:
    the H2D copy (pageable: the host waits for the copy, not for the
    kernels before it), the precompute and kernel 1 are queued.  Each stage
    is ``profiling.timed`` on the current stream and only named
    (``profiling.marked``) on a side stream, where a sync would undo the
    overlap.  -> what ``_collect_piece`` takes."""
    cap = outcap(int(np.prod(lanes.shape[1:])))
    stage = profiling.timed if stream is None else profiling.marked
    with devmod.guard(dev, stream):
        x = stage("encode/upload", torch.from_numpy(lanes).to, dev)
        xs = stage("encode/precompute", _fused_input, x, cfg)
        out, lens, ovf = stage("encode/fused_kernel", encode_fused_async, xs,
                               init, cap)
        return out, torch.stack([lens, ovf.to(torch.int32)]), stream


def _collect_piece(out: torch.Tensor, meta: torch.Tensor, stream
                   ) -> list[bytes]:
    """Wait for a piece's stream through its lengths and overflow flags,
    then bring back only ``out[:, :max(lens)]`` and cut the streams."""
    stage = profiling.timed if stream is None else profiling.marked
    with devmod.guard(out.device, stream):
        lens, ovf = meta.cpu().numpy()
        if ovf.any():
            raise RuntimeError(
                f"encoded stream overflowed outcap={out.shape[1]}")
        width = int(lens.max(initial=0))
        return _streams(stage("encode/download", _to_host, out[:, :width]),
                        lens)


def _encode_fused(batches: list[np.ndarray], devs: list, cfg: CodecConfig,
                  init, max_inflight: int) -> list[list[bytes]]:
    """The fused engine's loop: each batch's lanes split over ``devs``
    (``device.shard_plan``) and cut into pieces of at most
    ``lanes_per_chunk`` lanes (each holding ``outcap`` bytes a lane on the
    device), run through ``device.overlapped`` with at most
    ``max_inflight`` pieces of a device in flight, or one where a lane
    alone outgrows a chunk's budget (``pipeline_fits``), and at least one
    of each of the device's shards.  -> each batch's streams."""
    work, where = [], []
    for bi, b in enumerate(batches):
        n_sym = int(np.prod(b.shape[1:]))
        if not pipeline_fits(n_sym):
            max_inflight = 1
        for dev, lo, hi in devmod.pieces(len(b), devs,
                                         lanes_per_chunk(n_sym, "fused")):
            work.append((dev, (b[lo:hi], cfg, init)))
            where.append((bi, lo))
    done = devmod.overlapped(work, _launch_piece, _collect_piece,
                             max(max_inflight, devmod.most_shards(devs)))
    streams: list[list[bytes]] = [[] for _ in batches]
    for (bi, _), piece in sorted(zip(where, done), key=lambda p: p[0]):
        streams[bi] += piece
    return streams


def encode_lanes_pipelined(batches, cfg: CodecConfig = REV2,
                           primed: bool = False, seed=None, device="cuda",
                           engine: str = "fused",
                           max_inflight: int = MAX_INFLIGHT
                           ) -> list[list[bytes]]:
    """Encode several lane batches [S_i, H_i, W_i, C_i] u8 -> each batch's
    streams, equal to ``encode_lanes`` on that batch.

    Port of ``encode_lanes_pipelined`` (`encode.py:815-976` of the JAX
    package) on CUDA streams.  Fused engine: each batch is cut into pieces
    of at most ``lanes_per_chunk`` lanes, and each piece's H2D copy,
    precompute and kernel 1 run on a side stream while earlier pieces are
    still on the device; pieces are collected in order, bringing back only
    the bytes up to their longest stream.  At most ``max_inflight`` pieces
    are on the device at once, or one when a lane alone outgrows a chunk's
    budget (``pipeline_fits``).  A single piece runs at once on the
    current stream.  engine='sort' runs the batches one after another
    through ``encode_lanes``.  On the CPU the pieces run in turn through
    the plain version.
    """
    _check_args(cfg, engine, "symbol", primed, seed)
    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    dev = devmod.resolve(device)
    batches = [_as_lanes(b) for b in batches]
    if engine == "sort":
        return [encode_lanes(b, cfg, primed, seed, dev, engine)
                for b in batches]
    return _encode_fused(batches, [dev], cfg, _start_table(primed, seed),
                         max_inflight)
