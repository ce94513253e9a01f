"""Per-image stored model seed (sliced-container flag bit 1).

Port of ``llcomp_tpu/seed.py``.  The seed is a [121, 8] u8 start-state table,
the same shape as the static prior (``tables.PRIOR_TAB``): context row h of
every stripe starts at ``seed[h % 121]``.  The encoder derives it from the
image's own bit statistics, pooled per (bucket, substate) over sampled 8-row
bands; the bit counts are taken with torch ops on the given device, and the
table is picked from them with the JAX package's float64 NumPy arithmetic
and ``np.argmin`` tie-breaking, so the table is byte-equal.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from . import device as devmod
from .core import tables, transform
from .core.config import REV2, CodecConfig

BUCKETS = tables.PRIOR_BUCKETS  # 121: the hash's two low quantizer components
_MIN_EVIDENCE = 512             # bits per (bucket, substate) to trust it
_BAND = 8                       # rows per sampled band (prediction needs two)


def _as_hwc(img) -> np.ndarray:
    img = np.asarray(img, dtype=np.uint8)
    return img[..., None] if img.ndim == 2 else img


def band_starts(img: np.ndarray, sample_mp: float) -> range:
    """First rows of the 8-row bands sampled from ``img`` (up to
    ``sample_mp`` megapixels)."""
    n_px = img.shape[0] * img.shape[1]
    step = max(1, int(np.ceil(n_px / (sample_mp * 1e6)))) * _BAND
    return range(0, img.shape[0], step)


def _count_bits(img: np.ndarray, sample_mp: float, cfg: CodecConfig, dev,
                n0: torch.Tensor, n1: torch.Tensor) -> None:
    """Add the image's per-(bucket, substate) 0 and 1 counts to n0, n1."""
    subs = cfg.substates
    for y0 in band_starts(img, sample_mp):
        band = torch.from_numpy(img[y0 : y0 + _BAND]).to(dev)[None]
        h, diff = transform.context_and_residual(transform.rct_forward(band),
                                                 cfg)
        ctx, bit, valid = transform.binarize(diff, cfg)
        key = (h.reshape(-1, 1).to(torch.int64) % BUCKETS) * subs + ctx
        n1 += torch.bincount(key[valid & (bit == 1)], minlength=BUCKETS * subs)
        n0 += torch.bincount(key[valid & (bit == 0)], minlength=BUCKETS * subs)


def derive(img, cfg: CodecConfig = REV2, sample_mp: float = 2.0, *,
           device="cuda") -> np.ndarray:
    """uint8 [H, W, C] -> [121, 8] u8 start-state table."""
    return derive_pooled([img], cfg, sample_mp, device=device)


def derive_pooled(imgs, cfg: CodecConfig = REV2, sample_mp: float = 0.5,
                  *, device="cuda") -> np.ndarray:
    """One table pooled over several images (a batch of lanes from several
    images shares one table; each image's container stores its copy)."""
    # a seed has the prior's 8 substates a bucket: callers derive one only
    # under such a cfg (config.check_start)
    assert cfg.substates == tables.PRIOR_TAB.shape[1], cfg.substates
    dev = devmod.resolve(device)
    n0 = torch.zeros(BUCKETS * cfg.substates, dtype=torch.int64, device=dev)
    n1 = torch.zeros_like(n0)
    for img in imgs:
        _count_bits(_as_hwc(img), sample_mp, cfg, dev, n0, n1)
    return table_from_counts(n0.cpu().numpy(), n1.cpu().numpy(), cfg)


def table_from_counts(n0: np.ndarray, n1: np.ndarray,
                      cfg: CodecConfig = REV2) -> np.ndarray:
    """Pick, per (bucket, substate), the state whose probability is nearest
    the pooled P(1); thin evidence keeps the static prior."""
    n = (n0 + n1).astype(np.float64)
    p1 = np.where(n > 0, 256.0 * n1 / np.maximum(n, 1), 128.0)
    prob = tables.STATE_PROB.astype(np.float64)
    states = np.argmin(np.abs(prob[None, :] - p1[:, None]), axis=1)
    fallback = tables.PRIOR_TAB.reshape(-1)
    return np.where(n >= _MIN_EVIDENCE, states,
                    fallback).astype(np.uint8).reshape(BUCKETS,
                                                       cfg.substates)


def pack_blob(tab: np.ndarray) -> bytes:
    """[121, 8] u8 -> container seed blob (zlib level 6)."""
    tab = np.ascontiguousarray(tab, dtype=np.uint8)
    if tab.shape != (BUCKETS, 8):
        raise ValueError(f"seed table must be [121, 8], got {tab.shape}")
    return zlib.compress(tab.tobytes(), 6)


def unpack_blob(blob: bytes) -> np.ndarray:
    raw = zlib.decompress(bytes(blob))
    if len(raw) != BUCKETS * 8:
        raise ValueError(f"seed blob decodes to {len(raw)} bytes, "
                         f"expected {BUCKETS * 8}")
    return np.frombuffer(raw, dtype=np.uint8).reshape(BUCKETS, 8).copy()
