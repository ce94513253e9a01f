"""Whole-batch precompute stages as torch ops (any device).

Port of ``llcomp_tpu/core/transform.py`` plus the oracle's ``binarize``
(`oracle.py:155-212`).  The encoder side of llcomp is serial only in the
entropy coder: the neighbours the reference reads from its line ring
(`llcomp.hpp:417-422`) are the forward-transformed input samples, so colour
transform, neighbours, context hash, prediction, residual, sign fold and
binarization are data-parallel maps over ``[S, H, W, C]``.

All integer semantics (truncation toward zero, clamp-then-wrap quantizer
indexing) match the reference bit for bit.  Planes are int32 throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import config
from .config import REV2, CodecConfig


def trunc_div4(x: torch.Tensor) -> torch.Tensor:
    """C-style ``x / 4``: truncate toward zero (torch ``//`` floors)."""
    return torch.div(x, 4, rounding_mode="trunc")


def rct_forward(img: torch.Tensor) -> torch.Tensor:
    """uint8 [..., C] -> int32 planes; C >= 3 applies the reversible transform
    to the first three channels, the rest pass through."""
    v = img.to(torch.int32)
    if img.shape[-1] < 3:
        return v
    r = v[..., 0] - v[..., 1]
    b = v[..., 2] - v[..., 1]
    g = v[..., 1] + trunc_div4(b + r)
    return torch.cat([torch.stack([r, g, b], dim=-1), v[..., 3:]], dim=-1)


def rct_inverse(planes: torch.Tensor) -> torch.Tensor:
    """int planes [..., C] -> uint8 image (first 3 channels clamped)."""
    v = planes.to(torch.int32)
    if planes.shape[-1] < 3:
        return v.clamp(0, 255).to(torch.uint8)
    r, g0, b = v[..., 0], v[..., 1], v[..., 2]
    g = g0 - trunc_div4(r + b)
    rgb = torch.stack([r + g, g, b + g], dim=-1).clamp(0, 255)
    # channels past the third wrap like the reference's u8 store
    return torch.cat([rgb, v[..., 3:] & 0xFF], dim=-1).to(torch.uint8)


def _quant_arith(thresholds: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Banded quantizer, arithmetically (bit-identical to tables.QUANT*)."""
    y = x.clamp(-128, 127)
    a = y.abs()
    mag = sum((a >= t).to(torch.int32) for t in thresholds)
    return torch.sign(y) * mag


def quant11(x: torch.Tensor) -> torch.Tensor:
    return _quant_arith((1, 2, 5, 12, 35), x)


def quant5(x: torch.Tensor) -> torch.Tensor:
    return _quant_arith((1, 4), x)


def neighbors(v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(l, t, L, tl, tr, T) for int planes ``v`` [S, H, W, C], with the
    reference's edge folds: the first pixel's l is 128, l at column 0 comes
    from the row above, row 0 has t = l, the last column has tr = t, rows 0-1
    have T = t and columns 0-1 have L = l."""
    x = v.to(torch.int32)
    _, H, W, _ = x.shape

    def shift_w(a, n):  # left neighbour at distance n
        return F.pad(a, (0, 0, n, 0))[:, :, :W]

    def shift_h(a, n):  # top neighbour at distance n
        return F.pad(a, (0, 0, 0, 0, n, 0))[:, :H]

    col = torch.arange(W, device=x.device).view(1, 1, W, 1)
    row = torch.arange(H, device=x.device).view(1, H, 1, 1)
    x_up = shift_h(x, 1)
    l = torch.where(col > 0, shift_w(x, 1),
                    torch.where(row > 0, x_up, torch.full_like(x, 128)))
    t = torch.where(row > 0, x_up, l)
    L = torch.where(col > 1, shift_w(x, 2), l)
    tl = torch.where((row > 0) & (col > 0), shift_h(shift_w(x, 1), 1), t)
    x_up_r = F.pad(x_up, (0, 0, 0, 1))[:, :, 1:]   # V[h-1, w+1]
    tr = torch.where((row > 0) & (col < W - 1), x_up_r, t)
    T = torch.where(row > 1, shift_h(x, 2), t)
    return l, t, L, tl, tr, T


def context_and_residual(v: torch.Tensor, cfg: CodecConfig = REV2
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Folded (hash, diff) per sample of planes [S, H, W, C]
    (`llcomp.hpp:424-436`): a negative hash negates both."""
    l, t, L, tl, tr, T = neighbors(v)
    h = quant11(l - tl) + quant11(tl - t) * 11 + quant11(t - tr) * 121
    if cfg.large_model:
        h = h + quant5(L - l) * 605 + quant5(T - t) * 3025
    predict = torch.clamp(l + t - tl, torch.minimum(l, t), torch.maximum(l, t))
    diff = v.to(torch.int32) - predict
    neg = h < 0
    return torch.where(neg, -h, h), torch.where(neg, -diff, diff)


def ilog2(uv: torch.Tensor, max_bits: int = 16) -> torch.Tensor:
    """floor(log2(uv)) for 1 <= uv < 2**max_bits, exact integer arithmetic."""
    e = torch.zeros_like(uv)
    for j in range(1, max_bits):
        e = e + ((uv >> j) > 0).to(uv.dtype)
    return e


def context_tables(cfg: CodecConfig, n: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [n] tables of ``config.exp_ctx(cfg, k)`` and
    ``config.mant_ctx(cfg, j)`` for k, j = 0 .. n-1: the contexts of a
    symbol's exponent decision k and mantissa decision j, which the plain
    versions index and the kernels' builds compute from the same cfg."""
    exp = [config.exp_ctx(cfg, k) for k in range(n)]
    mant = [config.mant_ctx(cfg, j) for j in range(n)]
    return (torch.tensor(exp, dtype=torch.int64, device=device),
            torch.tensor(mant, dtype=torch.int64, device=device))


def decision(k: int, d: torch.Tensor, ad: torch.Tensor, e: torch.Tensor,
             cfg: CodecConfig = REV2):
    """(ctx, bit) of decision ``k`` of symbols with residual ``d``, ``ad`` =
    |d| and ``e`` = floor(log2 ad): one slot of ``binarize``, for k below
    the symbol's decision count (1 if d == 0, else 2e+3)."""
    if k == 0:
        return torch.zeros_like(d), (ad == 0).to(d.dtype)
    in_exp = e >= k
    is_stop = e + 1 == k
    in_mant = (e + 2 <= k) & (2 * e + 1 >= k)
    exp_ctx, mant_ctx = context_tables(cfg, k + 1, d.device)
    ctx = torch.where(in_exp, config.exp_ctx(cfg, k), cfg.sign_ctx)  # or sign
    ctx = torch.where(is_stop, exp_ctx[(e + 1).clamp(0, k)], ctx)
    ctx = torch.where(in_mant, mant_ctx[(k - e - 2).clamp(0, k)], ctx)
    bit = torch.where(in_exp, 1, (d < 0).to(d.dtype))
    bit = torch.where(is_stop, 0, bit)
    bit = torch.where(in_mant, (ad >> (2 * e + 1 - k).clamp(0, 30)) & 1, bit)
    return ctx, bit


def binarize(diff: torch.Tensor, cfg: CodecConfig = REV2):
    """Residuals (any shape, flattened to N) -> (ctx [N, K], bit [N, K],
    valid [N, K] bool), K = ``cfg.max_bins_per_symbol``, the slot layout of
    ``putSymbol`` (`llcomp.hpp:166-206`; rev 2's contexts in brackets):

      slot 0             zero flag  ctx 0,                      bit v == 0
      slots 1 .. e       unary exp  exp_ctx(slot) (min(slot, 4)), bit 1
      slot  e+1          exp stop   exp_ctx(e+1) (min(e+1, 4)),  bit 0
      slots e+2 .. 2e+1  mantissa   mant_ctx(j) (min(5+j, 6)),   bit (|v|>>i)&1
      slot  2e+2         sign       sign_ctx (7),                bit v<0

    (the mantissa MSB first, j = slot - e - 2, i = 2e+1 - slot)
    """
    v = diff.reshape(-1, 1).to(torch.int64)
    uv = v.abs()
    nz = uv != 0
    e = ilog2(torch.clamp(uv, min=1), max_bits=21)
    K = cfg.max_bins_per_symbol
    s = torch.arange(K, device=v.device).view(1, -1)
    exp_ctx, mant_ctx = context_tables(cfg, K + 2, v.device)
    in_exp = (s >= 1) & (s <= e)
    is_stop = s == e + 1
    in_mant = (s >= e + 2) & (s <= 2 * e + 1)
    is_sign = s == 2 * e + 2
    ctx = torch.zeros_like(s.expand(v.shape[0], -1))
    bit = torch.zeros_like(ctx)
    ctx = torch.where(in_exp, exp_ctx[s], ctx)
    bit = torch.where(in_exp, 1, bit)
    ctx = torch.where(is_stop, exp_ctx[(e + 1).clamp(max=K + 1)], ctx)
    ctx = torch.where(in_mant, mant_ctx[(s - e - 2).clamp(0, K + 1)], ctx)
    bit = torch.where(in_mant, (uv >> torch.clamp(2 * e + 1 - s, min=0)) & 1,
                      bit)
    ctx = torch.where(is_sign, cfg.sign_ctx, ctx)
    bit = torch.where(is_sign, (v < 0).to(bit.dtype), bit)
    zero_slot = s == 0
    bit = torch.where(zero_slot, (~nz).to(bit.dtype), bit)
    valid = zero_slot | (nz & (in_exp | is_stop | in_mant | is_sign))
    return ctx, bit, valid
