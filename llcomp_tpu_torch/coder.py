"""The carry-less range coder, vectorised over lanes in torch.

One lane is one independent rev-2 stream.  Every lane advances one binary
decision per call, with element-wise ops only, so the plain versions of both
kernels (``kernels/encode_fused.py``, ``kernels/decode_kernel.py``) run on
any device.  Spec: ``oracle.RangeEncoder``/``RangeDecoder``
(`oracle.py:220-312`), reference `llcomp.hpp:33-127`.

The encoder writes each lane's bytes straight into a ``[S, outcap]`` buffer.
A shift flushes the pending byte plus a run of deferred bytes, and the run is
0xFF without a carry and 0x00 with one: the buffer starts as 0xFF, head
bytes are scattered in place, and carried runs are marked as intervals and
zeroed once at ``finish``.  Writes past ``outcap`` set a sticky per-lane
overflow flag instead.

The sort chain (``encode.encode_lanes(engine="sort")``) codes through kernel
4 (symbol variant) or 7 (decision variant) instead, which emit one
offset-packed record per decision (``off<<9 | carry<<8 | head``,
``KP_SILENT`` when no byte is flushed); ``finish_steps_off`` and
``expand_kp`` turn those records into bytes.  Kernel 8 emits slot records
(``meta = emit | carry<<1 | head<<8`` and the run before each step), which
``finish_steps`` and ``expand_slots`` turn into bytes.
"""
from __future__ import annotations

import torch

_I32 = 1 << 32
KP_SILENT = 0x7FFFFFFF    # record of a decision that flushes no byte
OFF_LIMIT = 1 << 22       # byte offsets below this keep off<<9 in int32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits (kept as
    int64): the wrap-around that int32 arithmetic in the kernels gives."""
    x = x & (_I32 - 1)
    return torch.where(x >= (1 << 31), x - _I32, x)


def shift_step(low, rng, pend, run, do):
    """One renormalising shift on the lanes where ``do`` is set
    (`llcomp.hpp:38-58`; the JAX package's ``coder.shift_step``).

    -> ((low, rng, pend, run), (emit, carry, head, out_run)): the new state
    and what the shift flushed: on ``emit``, the byte ``head`` followed by
    ``out_run`` bytes of 0x00 (``carry``) or 0xFF.
    """
    first = pend < 0
    nocarry = low <= 0xFF00
    carry = low >= 0x10000
    emit = do & ~first & (nocarry | carry)
    defer = do & ~first & ~nocarry & ~carry
    head = torch.where(carry, pend + 1, pend) & 0xFF
    pend2 = torch.where(do & ~defer, (low >> 8) & 0xFF, pend)
    run2 = torch.where(emit, 0, torch.where(defer, run + 1, run))
    low2 = torch.where(do, (low & 0xFF) << 8, low)
    rng2 = torch.where(do, rng << 8, rng)
    return (low2, rng2, pend2, run2), (emit, carry, head, run)


def kp_record(emit, carry, head, off) -> torch.Tensor:
    """Offset-packed byte record ``off<<9 | carry<<8 | head`` where ``emit``,
    ``KP_SILENT`` elsewhere, as int32."""
    rec = (off.to(torch.int64) << 9) | (carry.to(torch.int64) << 8) | head
    return torch.where(emit, rec, KP_SILENT).to(torch.int32)


def slot_meta(emit, carry, head) -> torch.Tensor:
    """Slot record ``emit | carry<<1 | head<<8`` as int32 (the JAX
    package's ``coder.pack_slot``)."""
    meta = (emit.to(torch.int64) | (carry.to(torch.int64) << 1)
            | (head.to(torch.int64) << 8))
    return meta.to(torch.int32)


def _flush_shifts(low, rng, pend, run) -> list[tuple]:
    """The two forced shifts of the coder's finish (`llcomp.hpp:75-81`: low
    += 0xFF, two shifts, the pending byte dropped) on final carries (int64
    [S] each) -> each shift's (emit, carry, head, out_run)."""
    low = low + 0xFF
    every = torch.ones_like(low, dtype=torch.bool)
    flushed = []
    for _ in range(2):
        (low, rng, pend, run), rec = shift_step(low, rng, pend, run, every)
        flushed.append(rec)
    return flushed


def finish_steps(carry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Final coder carries ``carry`` [4, S] (low, rng, pend, run) -> the two
    forced flush shifts' slot records (meta, runs), each [2, S] int32 (the
    JAX package's ``coder.finish_steps``)."""
    recs = _flush_shifts(*carry.to(torch.int64))
    meta = torch.stack([slot_meta(e, c, h) for e, c, h, _ in recs])
    runs = torch.stack([r for *_, r in recs]).to(torch.int32)
    return meta, runs


def finish_steps_off(fin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Final coder carries ``fin`` [5, S] (low, rng, pend, run, off) -> the
    two forced flush shifts' records ``kp_fin`` [2, S] int32 and the stream
    lengths [S] int32 (the JAX package's ``finish_steps_grouped_off``)."""
    fin = fin.to(torch.int64)
    off = fin[4]
    recs = []
    for emit, carry, head, out_run in _flush_shifts(*fin[:4]):
        recs.append(kp_record(emit, carry, head, off))
        off = torch.where(emit, off + 1 + out_run, off)
    return torch.stack(recs), off.to(torch.int32)


def expand_slots(meta: torch.Tensor, runs: torch.Tensor, *, outcap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot records -> (bytes [S, outcap] u8, stream lengths [S] int32).

    meta, runs [T, S] int32, a lane's steps in order, the two flush steps
    of ``finish_steps`` included (the counterpart of the JAX package's
    ``expand_slots_on_device``, lane-minor).  An emitting slot flushes
    ``1 + run`` bytes, so the byte offsets are an exclusive cumsum down the
    steps; the emitting slots become offset-packed records
    ``off<<9 | carry<<8 | head`` and go through ``expand_kp``.
    """
    emit = (meta & 1) != 0
    length = torch.where(emit, 1 + runs.to(torch.int64), 0)
    ends = length.cumsum(dim=0)
    offs = ends - length
    rec = (offs << 9) | ((meta & 2).to(torch.int64) << 7) | ((meta >> 8) & 0xFF)
    kp = torch.where(emit & (offs < outcap), rec, KP_SILENT).to(torch.int32)
    # the flush records are already rows of ``kp``
    return expand_kp(kp, kp[:0], outcap), ends[-1].to(torch.int32)


def expand_kp(kp: torch.Tensor, kp_fin: torch.Tensor, outcap: int
              ) -> torch.Tensor:
    """Offset-packed byte records -> bytes [S, outcap] u8.

    kp [T, S] and kp_fin [2, S] int32: per lane, the records of emitting
    shifts carry strictly increasing offsets.  The byte at ``off`` is
    ``head``; the bytes after it, up to the next record, are 0x00 if the
    record carried and 0xFF if not (the JAX package's
    ``expand_kp_grouped``, which sorts where this scatters).  Each record
    (off+1)<<9 | carry<<8 | head lands at row ``off`` of a zeroed [outcap, S]
    buffer, and a running max down the rows hands every byte position the
    latest record at or before it.
    """
    rec = torch.cat([kp, kp_fin])
    S = rec.shape[1]
    off = rec >> 9
    sel = (rec != KP_SILENT) & (off < outcap)
    buf = torch.zeros((outcap, S), dtype=torch.int32, device=rec.device)
    lane = torch.arange(S, device=rec.device).expand_as(rec)
    buf.index_put_((off[sel].long(), lane[sel]),
                   ((off[sel] + 1) << 9) | (rec[sel] & 0x1FF))
    sv = torch.cummax(buf, dim=0).values
    pos = torch.arange(outcap, device=rec.device, dtype=torch.int32)[:, None]
    fill = torch.where((sv & 0x100) != 0, 0, 0xFF)
    byte = torch.where((sv >> 9) - 1 == pos, sv & 0xFF, fill)
    return byte.t().to(torch.uint8).contiguous()


class Encoder:
    """Range encoders of ``S`` lanes writing into ``[S, outcap]`` bytes."""

    def __init__(self, S: int, outcap: int, device) -> None:
        z = torch.zeros(S, dtype=torch.int64, device=device)
        self.outcap = outcap
        self.low = z.clone()
        self.rng = torch.full_like(z, 0xFF00)
        self.pend = torch.full_like(z, -1)   # byte awaiting carry resolution
        self.run = z.clone()                 # deferred bytes after it
        self.pos = z.clone()                 # bytes emitted so far
        self.ovf = torch.zeros(S, dtype=torch.bool, device=device)
        # column outcap is a trash slot for lanes that write nothing
        self.out = torch.full((S, outcap + 1), 0xFF, dtype=torch.uint8,
                              device=device)
        # +1 at the start of a carried (all-zero) run, -1 past its end
        self.zero_edges = torch.zeros((S, outcap + 2), dtype=torch.int32,
                                      device=device)

    def _shift(self, do: torch.Tensor) -> None:
        """One renormalising shift on the lanes where ``do`` is set, its
        flushed bytes written (``shift_step``)."""
        (self.low, self.rng, self.pend, self.run), (emit, carry, head, run) = (
            shift_step(self.low, self.rng, self.pend, self.run, do))
        cap = self.outcap
        at = torch.where(emit, self.pos.clamp(max=cap), cap)
        self.out.scatter_(1, at[:, None], head.to(torch.uint8)[:, None])
        zrun = emit & carry & (run > 0)
        start = torch.where(zrun, (self.pos + 1).clamp(max=cap + 1), cap + 1)
        end = torch.where(zrun, (self.pos + 1 + run).clamp(max=cap + 1),
                          cap + 1)
        one = zrun.to(torch.int32)[:, None]
        self.zero_edges.scatter_add_(1, start[:, None], one)
        self.zero_edges.scatter_add_(1, end[:, None], -one)
        self.ovf |= emit & (self.pos + 1 + run > cap)
        self.pos = torch.where(emit, self.pos + 1 + run, self.pos)

    def put(self, bit: torch.Tensor, prob: torch.Tensor,
            valid: torch.Tensor) -> None:
        """Code ``bit`` at P(1) = ``prob``/256 on the lanes where ``valid``."""
        range1 = (self.rng * prob) >> 8
        one = bit.to(torch.bool) & valid
        self.low = torch.where(one, self.low + self.rng - range1, self.low)
        self.rng = torch.where(valid, torch.where(one, range1,
                                                  self.rng - range1), self.rng)
        do = valid & (self.rng < 0x100)
        # most decisions shift no lane: skip the shift's ops then, where the
        # test costs no device sync
        if do.is_cuda or bool(do.any()):
            self._shift(do)

    def finish(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Two forced shifts (`llcomp.hpp:75-81`); the byte left pending is
        dropped.  -> (bytes [S, outcap] u8, lengths [S] int32, overflow [S])."""
        every = torch.ones_like(self.ovf)
        self.low = self.low + 0xFF
        self._shift(every)
        self._shift(every)
        zero = self.zero_edges.cumsum(dim=1)[:, : self.outcap] > 0
        out = self.out[:, : self.outcap].masked_fill(zero, 0)
        return out, self.pos.to(torch.int32), self.ovf


class Decoder:
    """Range decoders of ``S`` lanes over zero-padded ``[S, cap]`` bytes; a
    read at or past a lane's length gives 0 (`llcomp.hpp:91-127`).  State is
    int64 holding int32 values, wrapped like the kernels' int32 arithmetic,
    which only matters on corrupt streams."""

    def __init__(self, data: torch.Tensor, lens: torch.Tensor) -> None:
        self.data = data
        self.cap = data.shape[1]
        self.lens = lens.to(torch.int64).clamp(max=self.cap)
        self.pos = torch.zeros_like(self.lens)
        self.rng = torch.full_like(self.lens, 0xFF00)
        b0 = self._byte()
        self.pos += 1
        b1 = self._byte()
        self.pos += 1
        self.low = (b0 << 8) | b1

    def _byte(self) -> torch.Tensor:
        at = self.pos.clamp(max=self.cap - 1)[:, None]
        b = self.data.gather(1, at)[:, 0].to(torch.int64)
        return torch.where(self.pos < self.lens, b, 0)

    def get(self, prob: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """Decode one bit per lane where ``act`` (0 elsewhere)."""
        range1 = (self.rng * prob) >> 8
        rng0 = self.rng - range1
        bit = (self.low >= rng0) & act
        self.low = torch.where(bit, wrap32(self.low - rng0), self.low)
        self.rng = torch.where(act, torch.where(bit, range1, rng0), self.rng)
        refl = act & (self.rng < 0x100)
        fresh = wrap32((self.low << 8) | self._byte())
        self.low = torch.where(refl, fresh, self.low)
        self.rng = torch.where(refl, self.rng << 8, self.rng)
        self.pos = torch.where(refl, self.pos + 1, self.pos)
        return bit
