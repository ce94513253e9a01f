"""Photo-like content from a seed: 1/f multi-octave value noise, in torch.

The benchmark's stand-in for photographs, which are not in the repository:
natural images have power near 1/f^2 with detail at every scale plus sensor
noise.  Each image sums bilinear upsamplings of Gaussian grids of 4, 8, 16,
... cells a side (up to the image's longer side), each octave 0.55 times the
one before; the sum is normalised to a luminance of 128 +- 52, and each
channel gets a constant chroma offset (sd 14) and read noise of -1, 0 or +1.
A rewrite in torch, on the device, of ``make_natural`` in the repository's
root ``bench.py`` (the numbers are the same; the draws are torch's).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _octaves(n: int, h: int, w: int, gen: torch.Generator,
             dev: torch.device) -> torch.Tensor:
    """[n, h, w] float32: the normalised 1/f sum of n images."""
    acc = torch.zeros((n, 1, h, w), dtype=torch.float32, device=dev)
    size, amp = 4, 1.0
    while size <= max(h, w):
        g = torch.randn((n, 1, min(size, h), min(size, w)), generator=gen,
                        device=dev)
        acc += amp * F.interpolate(g, size=(h, w), mode="bilinear",
                                   align_corners=True)
        size *= 2
        amp *= 0.55
    mean = acc.mean(dim=(2, 3), keepdim=True)
    std = acc.std(dim=(2, 3), keepdim=True, correction=0).clamp(min=1e-9)
    return ((acc - mean) / std)[:, 0]


def corpus(images: list[dict], gen: torch.Generator,
           dev: torch.device) -> list[np.ndarray]:
    """One corpus: for each entry ``{"shape": [H, W, C], "count": n}`` of
    ``images``, n images made together on ``dev``, each returned as a host
    u8 [H, W, C] array of its own, in the entries' order."""
    out: list[np.ndarray] = []
    for entry in images:
        (h, w, c), n = entry["shape"], entry["count"]
        lum = 128 + 52 * _octaves(n, h, w, gen, dev)
        chroma = 14 * torch.randn((n, 1, 1, c), generator=gen, device=dev)
        noise = torch.randint(-1, 2, (n, h, w, c), generator=gen, device=dev)
        img = (lum[..., None] + chroma + noise).clamp(0, 255).to(torch.uint8)
        host = img.cpu().numpy()
        out.extend(np.ascontiguousarray(host[k]) for k in range(n))
    return out


def pool(images: list[dict], size: int, seed: int,
         dev: torch.device) -> list[list[np.ndarray]]:
    """``size`` distinct corpora from ``seed``: the same seed gives the same
    images on the same device."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [corpus(images, gen, dev) for _ in range(size)]
