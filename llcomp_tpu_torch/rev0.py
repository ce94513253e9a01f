"""Revision-0 codec: the llcomp.js bitstream (magic 0x77).

Port of ``llcomp_tpu/rev0.py``, in NumPy on the host as there: the JAX
package has no kernel for it, and ``api`` takes it only for ``revision=0``
or a stream's 0x77 magic.  The reference ships a second, independent
implementation in JavaScript (its ``llcomp.js``) that encodes an older,
incompatible format revision (SURVEY §2.12).  Differences from rev 2:

* magic byte 0x77 (`llcomp.js:314`), not 0x79;
* the probability model stores 128 states but draws P(MPS) from a 64-entry
  **float** table indexed ``state >> 1`` (`llcomp.js:113-122,138`); the coded
  probability is P(bit==1) = p if the state is odd else 1-p;
* the range coder multiplies by the float probability with clamping
  ``max(1, min(range-1, int(range*p)))`` (`llcomp.js:40,80`) instead of the
  integer ``range*P >> 8``;
* the MPS/LPS transition tables have different tails
  (`llcomp.js:95-111`: MPS ...125,124,125,126,127; LPS ...76,77,126,127);
* compression requires 3 or 4 channels (`llcomp.js:299`).

Everything else (RCT, neighbors, context hash, binarization, model layout,
finish semantics) matches rev 2.  All float arithmetic is IEEE-754 double in
both JavaScript and Python, so results are deterministic and portable.
Conformance rests on round trips, pinned goldens and the shared components.
"""
from __future__ import annotations

import numpy as np

from .core import tables
from .core.config import REV2, CodecConfig

# --- the NumPy helpers of the rev-2 spec that revision 0 shares (copies of
# the JAX package's oracle functions of the same names) ----------------------


def _quant(table: np.ndarray, x) -> np.ndarray:
    """A quantizer table with the reference's clamp-then-wrap indexing
    (`llcomp.hpp:335-341`)."""
    return table[np.clip(x, -128, 127) & 0xFF]


def _trunc_div4(x: np.ndarray) -> np.ndarray:
    """C++ integer division by 4 truncates toward zero; numpy // floors."""
    x = np.asarray(x)
    return np.where(x >= 0, x // 4, -((-x) // 4))


def rct_forward(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] image -> int16 transformed planes.

    For C >= 3 the first three channels become (r-g, g + (b-g + r-g)/4, b-g);
    extra channels (alpha, ...) pass through.  For C < 3 all channels pass
    through.  Output ranges: r, b in [-255, 255], g in [-127, 382].
    """
    v = img.astype(np.int32).copy()
    if img.shape[-1] >= 3:
        r = v[..., 0] - v[..., 1]
        b = v[..., 2] - v[..., 1]
        g = v[..., 1] + _trunc_div4(b + r)
        v[..., 0], v[..., 1], v[..., 2] = r, g, b
    return v.astype(np.int16)


def neighbors(v: np.ndarray) -> dict[str, np.ndarray]:
    """Causal neighbors of every sample of int16 planes ``v`` [H, W, C].

    Boundary fallbacks follow the reference exactly: the very first pixel of a
    stream seeds ``l`` with 128; row 0 folds top neighbors onto ``l``; column
    boundaries fold onto ``l``/``t``.  Because encoding is lossless the encoder
    may read neighbors from the original transformed image — this is what makes
    the whole stage embarrassingly parallel.
    """
    x = v.astype(np.int32)
    H, W, _ = x.shape

    l = np.empty_like(x)
    l[:, 1:] = x[:, :-1]
    if H > 1:
        l[1:, 0] = x[:-1, 0]
    l[0, 0] = 128

    t = np.empty_like(x)
    t[1:] = x[:-1]
    t[0] = l[0]

    L = np.empty_like(x)
    if W > 2:
        L[:, 2:] = x[:, :-2]
    L[:, : min(2, W)] = l[:, : min(2, W)]

    tl = np.empty_like(x)
    tl[1:, 1:] = x[:-1, :-1]
    tl[0, :] = t[0, :]
    tl[:, 0] = t[:, 0]

    tr = np.empty_like(x)
    if W > 1:
        tr[1:, :-1] = x[:-1, 1:]
    tr[0, :] = t[0, :]
    tr[1:, W - 1] = t[1:, W - 1]

    T = np.empty_like(x)
    if H > 2:
        T[2:] = x[:-2]
    T[: min(2, H)] = t[: min(2, H)]

    return {"l": l, "t": t, "L": L, "tl": tl, "tr": tr, "T": T}


def median3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Median of three == clip the gradient term into [min, max] of the others."""
    return np.clip(b, np.minimum(a, c), np.maximum(a, c))


def context_and_residual(
    v: np.ndarray, cfg: CodecConfig = REV2
) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample (folded context hash, folded residual) of planes ``v``.

    hash = q11(l-tl) + 11 q11(tl-t) + 121 q11(t-tr) [+ 605 q5(L-l) + 3025 q5(T-t)]
    predict = median(l, l + t - tl, t);  diff = v - predict;
    a negative hash negates both (halving the model, `llcomp.hpp:433-436`).
    """
    n = neighbors(v)
    l, t, L, tl, tr, T = n["l"], n["t"], n["L"], n["tl"], n["tr"], n["T"]
    h = (
        _quant(tables.QUANT11, l - tl)
        + _quant(tables.QUANT11, tl - t) * 11
        + _quant(tables.QUANT11, t - tr) * 121
    )
    if cfg.large_model:
        h = (h + _quant(tables.QUANT5, L - l) * 605
             + _quant(tables.QUANT5, T - t) * 3025)
    predict = median3(l, l + t - tl, t)
    diff = v.astype(np.int32) - predict
    neg = h < 0
    return np.where(neg, -h, h), np.where(neg, -diff, diff)


def binarize(diff: np.ndarray, cfg: CodecConfig = REV2):
    """Decompose signed residuals into fixed 24-slot binary-decision rows.

    Returns (ctx [N, 24] uint8, bit [N, 24] uint8, valid [N, 24] bool) where N
    is the flattened symbol count.  Slot layout per nonzero value v with
    e = floor(log2 |v|):

      slot 0                 zero flag     ctx 0,            bit 0
      slots 1 .. e           unary exp     ctx min(slot, 4), bit 1
      slot  e+1              exp stop      ctx min(e+1, 4),  bit 0
      slots e+2 .. 2e+1      mantissa MSB> ctx min(5+j, 6),  bit (|v|>>i)&1
      slot  2e+2             sign          ctx 7,            bit v<0

    and a zero value is the single slot (ctx 0, bit 1).  Max 2e+3 = 23 slots.
    """
    v = np.asarray(diff, dtype=np.int64).reshape(-1)
    n = v.shape[0]
    uv = np.abs(v)
    nz = uv != 0
    # exponent; 0 for v == 0 (unused there)
    e = np.zeros(n, dtype=np.int64)
    e[nz] = np.floor(np.log2(uv[nz].astype(np.float64))).astype(np.int64)
    # floating log2 is exact for our magnitudes (< 2**20), but guard anyway:
    e[nz] = np.where(uv[nz] >> e[nz] >= 2, e[nz] + 1, e[nz])
    e[nz] = np.where(uv[nz] >> e[nz] == 0, e[nz] - 1, e[nz])

    K = cfg.max_bins_per_symbol
    s = np.arange(K)[None, :]                       # slot index grid [1, K]
    e2 = e[:, None]
    uv2 = uv[:, None]

    in_exp = (s >= 1) & (s <= e2)
    is_stop = s == e2 + 1
    in_mant = (s >= e2 + 2) & (s <= 2 * e2 + 1)
    is_sign = s == 2 * e2 + 2

    ctx = np.zeros((n, K), dtype=np.int64)
    bit = np.zeros((n, K), dtype=np.int64)
    valid = np.zeros((n, K), dtype=bool)

    # slot 0: zero flag
    valid[:, 0] = True
    bit[:, 0] = (~nz).astype(np.int64)

    ctx = np.where(in_exp, np.minimum(s, cfg.e_lim), ctx)
    bit = np.where(in_exp, 1, bit)
    ctx = np.where(is_stop, np.minimum(e2 + 1, cfg.e_lim), ctx)
    mant_shift = 2 * e2 + 1 - s                     # i = e-1 .. 0 across slots
    ctx = np.where(in_mant, np.minimum(cfg.e_lim + 1 + (s - e2 - 2), cfg.r_lim), ctx)
    bit = np.where(in_mant, (uv2 >> np.maximum(mant_shift, 0)) & 1, bit)
    ctx = np.where(is_sign, cfg.sign_ctx, ctx)
    bit = np.where(is_sign, (v < 0)[:, None].astype(np.int64), bit)

    nzmask = nz[:, None]
    valid = valid | (nzmask & (in_exp | is_stop | in_mant | is_sign))
    ctx = np.where(valid, ctx, 0)
    bit = np.where(valid, bit, 0)
    return ctx.astype(np.uint8), bit.astype(np.uint8), valid


# --- revision 0 ------------------------------------------------------------

MAGIC = 0x77

# MPS transition (`llcomp.js:95-102`): climb by 2 up to 125, then the tail
# 124,125 self-pairs; 126/127 absorbing (and unreachable from state 0).
NEXT_STATE_MPS_0 = np.array(
    [min(i + 2, 125) if i < 124 else i for i in range(128)], dtype=np.uint8
)

# LPS transition (`llcomp.js:104-111`).
NEXT_STATE_LPS_0 = np.array([
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 18, 19, 22, 23, 22, 23, 24, 25, 26, 27, 26, 27, 30, 31, 30, 31,
    32, 33, 32, 33, 36, 37, 36, 37, 38, 39, 38, 39, 42, 43, 42, 43, 44, 45,
    44, 45, 46, 47, 48, 49, 48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55,
    56, 57, 58, 59, 58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65,
    66, 67, 66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127,
], dtype=np.uint8)

# P(MPS) by state pair (`llcomp.js:113-122`), float64.
MPS_PROBABILITY = np.array([
    0.5156, 0.5405, 0.5615, 0.5825, 0.6016, 0.6207, 0.6398, 0.6570,
    0.6723, 0.6875, 0.7028, 0.7162, 0.7295, 0.7410, 0.7525, 0.7639,
    0.7754, 0.7849, 0.7945, 0.8040, 0.8117, 0.8212, 0.8289, 0.8365,
    0.8422, 0.8499, 0.8556, 0.8613, 0.8671, 0.8728, 0.8785, 0.8823,
    0.8881, 0.8919, 0.8957, 0.8995, 0.9033, 0.9072, 0.9110, 0.9148,
    0.9167, 0.9205, 0.9224, 0.9263, 0.9282, 0.9301, 0.9320, 0.9339,
    0.9358, 0.9377, 0.9396, 0.9415, 0.9434, 0.9454, 0.9473, 0.9473,
    0.9492, 0.9511, 0.9511, 0.9530, 0.9530, 0.9549, 0.9568, 0.9702,
], dtype=np.float64)

N_HASHES = 7926  # same reachable folded-hash space as rev 2
SUB = 8


def _prob1(state: int) -> float:
    p = MPS_PROBABILITY[state >> 1]
    return p if (state & 1) else 1.0 - p


class RangeEncoder0:
    """Rev-0 encoder: float probability with clamped split (`llcomp.js:39-52`)."""

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFF00
        self.pending = -1
        self.run = 0
        self.out = bytearray()

    def _shift(self) -> None:
        if self.pending < 0:
            self.pending = self.low >> 8
        elif self.low <= 0xFF00:
            self.out.append(self.pending & 0xFF)
            self.out.extend(b"\xff" * self.run)
            self.run = 0
            self.pending = self.low >> 8
        elif self.low >= 0x10000:
            self.out.append((self.pending + 1) & 0xFF)
            self.out.extend(b"\x00" * self.run)
            self.run = 0
            self.pending = (self.low >> 8) & 0xFF
        else:
            self.run += 1
        self.low = (self.low & 0xFF) << 8
        self.range <<= 8

    def put(self, bit: int, prob: float) -> None:
        range1 = max(1, min(self.range - 1, int(self.range * prob)))
        if bit:
            self.low += self.range - range1
            self.range = range1
        else:
            self.range -= range1
        if self.range < 0x100:
            self._shift()

    def finish(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._shift()
        self.range = 0xFF
        self._shift()
        return bytes(self.out)


class RangeDecoder0:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.range = 0xFF00
        self.low = (self._byte() << 8) | self._byte()

    def _byte(self) -> int:
        if self.pos >= len(self.data):
            return 0
        b = self.data[self.pos]
        self.pos += 1
        return b

    def get(self, prob: float) -> int:
        range1 = max(1, min(self.range - 1, int(self.range * prob)))
        self.range -= range1
        if self.low < self.range:
            bit = 0
        else:
            self.low -= self.range
            self.range = range1
            bit = 1
        if self.range < 0x100:
            self.range <<= 8
            self.low = (self.low << 8) | self._byte()
        return bit


def encode(img: np.ndarray) -> bytes:
    """uint8 [H, W, C] (C in {3, 4}, like llcomp.js) -> rev-0 stream."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError("revision 0 requires 3 or 4 channels (llcomp.js:299)")
    H, W, C = img.shape
    v = rct_forward(img)
    hash_, diff = context_and_residual(v)
    ctx, bit, valid = binarize(diff)
    sym_hash = hash_.reshape(-1)

    states = np.zeros(N_HASHES * SUB, dtype=np.uint8)
    enc = RangeEncoder0()
    for si in range(ctx.shape[0]):
        base = int(sym_hash[si]) * SUB
        for k in range(ctx.shape[1]):
            if not valid[si, k]:
                break
            idx = base + int(ctx[si, k])
            st = int(states[idx])
            b = int(bit[si, k])
            enc.put(b, _prob1(st))
            states[idx] = (
                NEXT_STATE_MPS_0[st] if b == (st & 1) else NEXT_STATE_LPS_0[st]
            )
    head = bytes([MAGIC, C, W & 0xFF, W >> 8, H & 0xFF, H >> 8])
    return head + enc.finish()


# Samples a payload byte can hold at most.  Each sample takes at least one
# coder decision, and a decision keeps at most 0.9702 (the top of
# MPS_PROBABILITY) of the range plus one unit of a range >= 256, so it
# costs at least 0.0378 bits: at most 212 decisions a byte.  Constant
# images reach 124.
SAMPLES_PER_BYTE = 256


def header(data: bytes) -> tuple[int, int, int]:
    """A rev-0 stream's (C, W, H), checked before anything is allocated:
    raises ValueError for a short header, a wrong magic, C not 3 or 4
    (`llcomp.js:299`), or more samples than the payload can hold."""
    if data[:1] != bytes([MAGIC]):
        raise ValueError("Invalid magic number")
    if len(data) < 6:
        raise ValueError(f"revision-0 header cut at {len(data)} of 6 bytes")
    C = data[1]
    W = data[2] | (data[3] << 8)
    H = data[4] | (data[5] << 8)
    if C not in (3, 4):
        raise ValueError(f"revision 0 has 3 or 4 channels, header says {C}")
    if W * H * C > SAMPLES_PER_BYTE * (len(data) - 6 + 4):
        raise ValueError(f"revision-0 header {W}x{H}x{C} holds more samples "
                         f"than {len(data) - 6} payload bytes can code")
    return C, W, H


def decode(data: bytes) -> np.ndarray:
    """Rev-0 stream -> uint8 [H, W, C].  Raises ValueError for a bad
    ``header`` or an invalid exponent."""
    C, W, H = header(data)
    dec = RangeDecoder0(data, pos=6)

    states = np.zeros(N_HASHES * SUB, dtype=np.uint8)
    q11 = tables.QUANT11
    q5 = tables.QUANT5
    lines = np.zeros((3, W * C), dtype=np.int64)
    out = np.empty((H, W, C), dtype=np.uint8)

    def q(table, x):
        return int(table[max(-128, min(127, x)) & 0xFF])

    def rac(base, ctx):
        idx = base + ctx
        st = int(states[idx])
        b = dec.get(_prob1(st))
        states[idx] = (
            NEXT_STATE_MPS_0[st] if b == (st & 1) else NEXT_STATE_LPS_0[st]
        )
        return b

    for h in range(H):
        line0 = lines[h % 3]
        line1 = lines[(h + 2) % 3]
        line2 = lines[(h + 1) % 3]
        for w in range(W):
            x = w * C
            for i in range(C):
                l = int(line0[x - C + i]) if w > 0 else (int(line1[x + i]) if h > 0 else 128)
                t = int(line1[x + i]) if h > 0 else l
                L = int(line0[x - 2 * C + i]) if w > 1 else l
                tl = int(line1[x - C + i]) if h > 0 and w > 0 else t
                tr = int(line1[x + C + i]) if h > 0 and w < W - 1 else t
                T = int(line2[x + i]) if h > 1 else t

                hsh = (q(q11, l - tl) + q(q11, tl - t) * 11 + q(q11, t - tr) * 121
                       + q(q5, L - l) * 605 + q(q5, T - t) * 3025)
                predict = median3(l, l + t - tl, t)
                neg = hsh < 0
                if neg:
                    hsh = -hsh
                base = hsh * SUB

                if rac(base, 0):
                    diff = 0
                else:
                    e = 0
                    c = 1
                    while rac(base, min(c, 4)):
                        c += 1
                        e += 1
                        if e > 31:
                            raise ValueError("Invalid exponent")
                    value = 1
                    c = 5
                    for _ in range(e):
                        value = 2 * value + rac(base, min(c, 6))
                        c += 1
                    diff = -value if rac(base, 7) else value
                if neg:
                    diff = -diff
                line0[x + i] = predict + diff

            r, g, b = int(line0[x]), int(line0[x + 1]), int(line0[x + 2])
            g -= int(_trunc_div4(np.int64(r + b)))
            r += g
            b += g
            out[h, w, 0] = max(0, min(255, r))
            out[h, w, 1] = max(0, min(255, g))
            out[h, w, 2] = max(0, min(255, b))
            for i in range(3, C):
                out[h, w, i] = line0[x + i] & 0xFF
    return out
