"""Plain reference of the llcomp rev-2 codec and its sliced ``.llct`` container.

Written from the format's definition (the C++ reference ``llcomp.hpp``, as the
JAX package's NumPy oracle states it), for the benchmark alone: it imports
nothing of the program under test and takes nothing the program made.

* ``residuals``: colour transform, causal neighbours, context hash, median
  prediction and sign fold of a stack of stripes, in plain torch on any
  device (the decision counts of the roofline come from here).
* ``encode_stripe``: one stripe's headerless stream.  The decisions are laid
  out with NumPy; the adaptive model and the carry-less range coder run as a
  plain Python loop, the format's one serial part.
* ``pack`` / ``parse``: the container's bytes (head, length index, crc32
  table, streams).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Format tables (`llcomp.hpp:252-333`) and rev 2's constants (`:18-32`)
# ---------------------------------------------------------------------------

E_LIM, R_LIM, SIGN_CTX, SUBSTATES = 4, 6, 7, 8
# reachable folded hashes: 5 + 5*11 + 5*121 + 2*605 + 2*3025 = 7925
NUM_HASHES = 7926
MAX_SLOTS = 24

# P(bit == 1 | state) scaled by 256.
STATE_PROB = (
    123, 131, 117, 137, 111, 143, 106, 148, 101, 153, 96, 158, 91, 163, 87,
    167, 83, 171, 79, 175, 75, 179, 72, 182, 68, 186, 66, 188, 63, 191, 60,
    194, 57, 197, 54, 200, 52, 202, 49, 205, 48, 206, 45, 209, 43, 211, 41,
    213, 40, 214, 38, 216, 36, 218, 35, 219, 33, 221, 32, 222, 30, 224, 30,
    224, 28, 226, 27, 227, 26, 228, 25, 229, 24, 230, 23, 231, 22, 232, 21,
    233, 21, 233, 20, 234, 19, 235, 18, 236, 18, 236, 17, 237, 17, 237, 16,
    238, 16, 238, 15, 239, 15, 239, 14, 240, 14, 240, 13, 241, 13, 241, 13,
    241, 12, 242, 12, 242, 12, 242, 11, 243, 11, 243, 11, 243, 11, 243, 7,
    247,
)
# The state after a less probable bit (`llcomp.hpp:261-268`); after a more
# probable one (the state's low bit) it climbs two, saturating at 126 / 127.
NEXT_LPS = (
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 18, 19, 22, 23, 22, 23, 24, 25, 26, 27, 26, 27, 30, 31, 30, 31,
    32, 33, 32, 33, 36, 37, 36, 37, 38, 39, 38, 39, 42, 43, 42, 43, 44, 45,
    44, 45, 46, 47, 48, 49, 48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55,
    56, 57, 58, 59, 58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65,
    66, 67, 66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 76, 77, 76, 77, 76, 77, 76, 77, 78, 79,
)
NEXT_MPS = tuple(min(s + 2, 126 | (s & 1)) for s in range(128))
NEXT0 = tuple(NEXT_LPS[s] if s & 1 else NEXT_MPS[s] for s in range(128))
NEXT1 = tuple(NEXT_MPS[s] if s & 1 else NEXT_LPS[s] for s in range(128))

# The primed start (container flag bit 0): context row h starts at
# PRIOR[h % 121], 8 substates a row.  Format constants.
PRIOR = np.frombuffer(bytes.fromhex(
    "06070c122c1208061e01282e56160e0b300f102e620e0e215a37130a480804257e71"
    "3915180602417e7f7f7f7e011d7f01010101010101015a3d2511140a02324021070e"
    "3c0c061832111234520e101a1e01263456140e0c22032436541210181e01242c5616"
    "0c022a0b0c2456100a0f543311084608061d7e6b3915180802370101010101010101"
    "01010101010101016a4b2d1316080228482909103c0a060c34130c325a0e0c103011"
    "1234560e102034131032560e0e282a0b0e24560e0a103417001c4e0e08015231110a"
    "420a040f765f33131c0602257e7f017f0101117f7e7f7f270108027e7e5f35111a08"
    "022c5a3b15084008040a4e2d0b10420a060e4a2b0b0a3c0a061c4c2d0f08400a0424"
    "4a2b0d083c0a041c4a2b0d083a0a061056371502320a040076552d0d200804130101"
    "0101010101017e7f7f550206027e7e77411d120802347e6337111c06022c7e633515"
    "180802347e573b171606023c7e633915140604407e5b33151806023a765731131808"
    "022a76552f0f1e0a021676552b0b2608040001010101010101017e7f7f15030b0e7e"
    "7e7f7f3d020a02767e7f7745060a017e7e4f7f7f00150a7e7e7f7f7f0e01087e0101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "010101010101010101010101010101017e7f7f7e017e7f7f01010101010101010101"
    "01010101010154311f06380a0a044c2d11003008040d623517002606061b623d1705"
    "2608042576472307220a042f70432107220a0427764925092408021f70532b092408"
    "04157e633913180602217e7f6b57040c0c7f01010101010101015631150120080414"
    "3a1b01102e0c0802381b001a3c0c081142230318480a061d46290914540a06214425"
    "09104a0c08174629090e480a060b5a3715084008060b765f350f1c0802297e7f7f6b"
    "0208087f010101010101010162391f09180804283a1b0112320c0610321306244c0c"
    "0a012e0f082c56100a092e0f0c2a5a0e0a152a0b0e2852100a0d2e0f0a225a0e0a09"
    "54310f0c460a06157e5f37131c0602357e7f7f45040e1a7f01010101010101015a41"
    "210b140804383c1f030e360c061a2e110a24520e0a0a22051a2c5a120e062001222e"
    "56160e071e01222c44160c022a0b142c520e0c175635110c480a06217e7139151a08"
    "02397e7f7f7f0e01097f01010101010101015a472311120606364223070c340a0624"
    "36150c2c520e0e1e260520365610101a"
), dtype=np.uint8).reshape(121, 8)


def start_states(primed: bool) -> list[int]:
    """A stream's model at its start: every state 0, or the primed prior."""
    if not primed:
        return [0] * (NUM_HASHES * SUBSTATES)
    return PRIOR[np.arange(NUM_HASHES) % 121].reshape(-1).tolist()


# ---------------------------------------------------------------------------
# Precompute (`llcomp.hpp:396-436`)
# ---------------------------------------------------------------------------


def _quant(x: torch.Tensor, thresholds: tuple[int, ...]) -> torch.Tensor:
    """sign(d) * (thresholds <= |d|), d = x clamped to a signed byte."""
    d = x.clamp(-128, 127)
    mag = torch.zeros_like(d)
    for t in thresholds:
        mag += (d.abs() >= t).to(d.dtype)
    return torch.sign(d) * mag


def residuals(lanes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 stripes [S, H, W, C], each coded as an image of its own ->
    (folded hash, folded residual), int32 [S, H*W*C] in stream order.

    Colour transform for C >= 3: (r-g, g + trunc((r-g + b-g) / 4), b-g).
    Neighbours of sample (y, x): l = (y, x-1), t = (y-1, x), L = (y, x-2),
    tl, tr, T = (y-2, x), with the reference's folds at the edges: the first
    sample's l is 128, l in column 0 is the sample above, t in row 0 is l,
    tl and tr fall back to t off the stripe, L to l, T to t.
    """
    v = lanes.to(torch.int32)
    S, H, W, C = v.shape
    if C >= 3:
        r = v[..., 0] - v[..., 1]
        b = v[..., 2] - v[..., 1]
        g = v[..., 1] + torch.div(r + b, 4, rounding_mode="trunc")
        v = torch.cat([torch.stack([r, g, b], -1), v[..., 3:]], -1)
    p = torch.zeros((S, H + 2, W + 3, C), dtype=torch.int32, device=v.device)
    p[:, 2:, 2:W + 2] = v                     # v[y, x] at p[y + 2, x + 2]

    def at(dy: int, dx: int) -> torch.Tensor:
        return p[:, 2 + dy:H + 2 + dy, 2 + dx:W + 2 + dx]

    ys = torch.arange(H, device=v.device).view(1, H, 1, 1)
    xs = torch.arange(W, device=v.device).view(1, 1, W, 1)
    first = (ys == 0) & (xs == 0)
    l = torch.where(xs > 0, at(0, -1),
                    torch.where(ys > 0, at(-1, 0), torch.full_like(v, 128)))
    l = torch.where(first, 128, l)
    t = torch.where(ys > 0, at(-1, 0), l)
    L = torch.where(xs > 1, at(0, -2), l)
    tl = torch.where((ys > 0) & (xs > 0), at(-1, -1), t)
    tr = torch.where((ys > 0) & (xs < W - 1), at(-1, 1), t)
    T = torch.where(ys > 1, at(-2, 0), t)
    h = (_quant(l - tl, (1, 2, 5, 12, 35))
         + 11 * _quant(tl - t, (1, 2, 5, 12, 35))
         + 121 * _quant(t - tr, (1, 2, 5, 12, 35))
         + 605 * _quant(L - l, (1, 4))
         + 3025 * _quant(T - t, (1, 4)))
    pred = torch.maximum(torch.minimum(l, t),
                         torch.minimum(torch.maximum(l, t), l + t - tl))
    d = v - pred
    neg = h < 0
    return (torch.where(neg, -h, h).reshape(S, -1),
            torch.where(neg, -d, d).reshape(S, -1))


def decisions(diff: torch.Tensor) -> int:
    """Binary decisions the residuals ``diff`` take: 1 for a zero, else
    2e + 3 with e = floor(log2 |d|)."""
    a = diff.abs().to(torch.int64)
    e = torch.zeros_like(a)
    for j in range(1, 12):
        e += (a >> j > 0).to(a.dtype)
    return int(torch.where(a != 0, 2 * e + 3, 1).sum())


# ---------------------------------------------------------------------------
# Binarisation (`llcomp.hpp:166-206`) and the range coder (`:33-127`)
# ---------------------------------------------------------------------------


def _layout(hash_: np.ndarray, diff: np.ndarray) -> tuple[list, list]:
    """One stripe's decisions in coding order -> (model index, bit) lists.

    A zero residual is one decision (context 0, bit 1).  Otherwise, with
    u = |d| and e = floor(log2 u): context 0 bit 0; e ones in contexts
    min(k, 4), k = 1..e; a zero in context min(e + 1, 4); the e bits of u
    below its top bit, MSB first, in contexts min(5 + j, 6); the sign in
    context 7.
    """
    d = diff.astype(np.int64)
    u = np.abs(d)
    e = np.zeros_like(u)
    for j in range(1, 12):
        e += (u >> j) > 0
    s = np.arange(MAX_SLOTS)[None, :]
    e2, u2 = e[:, None], u[:, None]
    nz = (u != 0)[:, None]
    in_exp = (s >= 1) & (s <= e2)
    stop = s == e2 + 1
    in_mant = (s >= e2 + 2) & (s <= 2 * e2 + 1)
    sign = s == 2 * e2 + 2
    ctx = np.where(in_exp, np.minimum(s, E_LIM), 0)
    ctx = np.where(stop, np.minimum(e2 + 1, E_LIM), ctx)
    ctx = np.where(in_mant, np.minimum(E_LIM + 1 + s - e2 - 2, R_LIM), ctx)
    ctx = np.where(sign, SIGN_CTX, ctx)
    bit = np.where(in_exp, 1, 0)
    bit = np.where(in_mant, (u2 >> np.maximum(2 * e2 + 1 - s, 0)) & 1, bit)
    bit = np.where(sign, (d < 0)[:, None], bit)
    bit = np.where(s == 0, ~nz, bit)
    valid = (s == 0) | (nz & (in_exp | stop | in_mant | sign))
    idx = hash_.astype(np.int64)[:, None] * SUBSTATES + ctx
    return idx[valid].tolist(), bit[valid].astype(np.int64).tolist()


def code(idx: list[int], bits: list[int], states: list[int]) -> bytes:
    """The adaptive model and the carry-less range coder over decisions
    ``(idx[i], bits[i])`` from the model ``states`` -> the stream's bytes.

    Coder state: low, range (from 0xFF00), a pending byte and a run of
    0xFF bytes held back until a carry is settled.  A decision splits the
    range at (range * P(1)) >> 8; one renormalisation (range < 0x100)
    shifts a byte out.  Two forced shifts finish the stream and the byte
    then pending is dropped.
    """
    prob, nxt0, nxt1 = STATE_PROB, NEXT0, NEXT1
    low, rng, pending, run = 0, 0xFF00, -1, 0
    out = bytearray()
    for i, b in zip(idx, bits):
        st = states[i]
        r1 = (rng * prob[st]) >> 8
        if b:
            low += rng - r1
            rng = r1
            states[i] = nxt1[st]
        else:
            rng -= r1
            states[i] = nxt0[st]
        if rng < 0x100:
            if pending < 0:
                pending = low >> 8
            elif low <= 0xFF00:
                out.append(pending & 0xFF)
                out += b"\xff" * run
                run, pending = 0, low >> 8
            elif low >= 0x10000:
                out.append((pending + 1) & 0xFF)
                out += b"\x00" * run
                run, pending = 0, (low >> 8) & 0xFF
            else:
                run += 1
            low = (low & 0xFF) << 8
            rng <<= 8
    for extra in (0xFF, 0):
        rng = 0xFF
        low += extra
        if pending < 0:
            pending = low >> 8
        elif low <= 0xFF00:
            out.append(pending & 0xFF)
            out += b"\xff" * run
            run, pending = 0, low >> 8
        elif low >= 0x10000:
            out.append((pending + 1) & 0xFF)
            out += b"\x00" * run
            run, pending = 0, (low >> 8) & 0xFF
        else:
            run += 1
        low = (low & 0xFF) << 8
    return bytes(out)


def encode_stripe(stripe: np.ndarray, primed: bool) -> bytes:
    """u8 [H, W, C] stripe -> its headerless rev-2 stream."""
    h, d = residuals(torch.from_numpy(np.ascontiguousarray(stripe))[None])
    idx, bits = _layout(h[0].numpy(), d[0].numpy())
    return code(idx, bits, start_states(primed))


# ---------------------------------------------------------------------------
# The sliced container
# ---------------------------------------------------------------------------

MAGIC = b"LLCT"
FLAG_PRIMED, FLAG_CRC = 1, 4


def regions(height: int, width: int, slice_h: int) -> list[tuple]:
    """Untiled stream order: one (y0, y1, 0, width) a stripe, top down."""
    return [(y, min(y + slice_h, height), 0, width)
            for y in range(0, height, slice_h)]


def pack(streams: list[bytes], height: int, width: int, channels: int,
         slice_h: int, flags: int) -> bytes:
    """Head (magic, version 1, revision 2, channels, flags, width, height,
    slice height, stream count), u32 lengths, u32 crc32s where flag bit 2
    is set, then the streams in order."""
    n = len(streams)
    head = MAGIC + struct.pack("<BBBBIIII", 1, 2, channels, flags, width,
                               height, slice_h, n)
    index = struct.pack(f"<{n}I", *map(len, streams))
    if flags & FLAG_CRC:
        index += struct.pack(f"<{n}I", *map(zlib.crc32, streams))
    return head + index + b"".join(streams)


def parse(blob: bytes) -> list[bytes]:
    """A container with no seed and no tiles -> its streams (by the length
    index).  Raises ValueError on any other layout."""
    if blob[:4] != MAGIC or len(blob) < 24:
        raise ValueError("not a sliced container")
    flags, n = blob[7], struct.unpack_from("<I", blob, 20)[0]
    if flags & ~(FLAG_PRIMED | FLAG_CRC):
        raise ValueError(f"flags {flags:#x} outside the reference's layout")
    lens = struct.unpack_from(f"<{n}I", blob, 24)
    off = 24 + 4 * n + (4 * n if flags & FLAG_CRC else 0)
    streams = []
    for ln in lens:
        streams.append(blob[off:off + ln])
        off += ln
    if off != len(blob):
        raise ValueError("lengths do not cover the container")
    return streams
