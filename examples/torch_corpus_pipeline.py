"""Corpus compression with stats, on one device and over a mesh, through
the PyTorch/CUDA port.

    python examples/torch_corpus_pipeline.py [--device cuda|cpu] [--size N]
                                             [--images N]

The mesh is ``parallel.make_mesh()``, every local CUDA device; with
``--device cpu`` it is two CPU entries, which run the kernels' plain
PyTorch versions (slow: keep ``--size`` to a few dozen pixels).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from llcomp_tpu_torch import corpus, parallel


def synth_corpus(n: int, size: int) -> list[np.ndarray]:
    """``n`` gradient images, each side ``size``, 1.5 or 2 times it."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        h = int(rng.choice([size, size * 3 // 2, 2 * size]))
        w = int(rng.choice([size, size * 3 // 2]))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(
            np.stack([(xx * 2 + i) % 256, (xx + yy) % 256, (yy * 3) % 256], -1)
            + rng.integers(-3, 4, (h, w, 3)),
            0, 255,
        ).astype(np.uint8)
        out.append(img)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64,
                    help="the smallest side of an image")
    ap.add_argument("--images", type=int, default=12)
    args = ap.parse_args(argv)
    images = synth_corpus(args.images, args.size)

    # cross-image lane batching on one device
    blobs, stats = corpus.compress_corpus(images, slice_h=8,
                                          device=args.device)
    print("single-device:", stats.as_dict())

    # the same, each batch split over the mesh (identical bytes)
    if torch.device(args.device).type == "cuda":
        mesh = parallel.make_mesh()
    else:
        mesh = [args.device] * 2
    blobs_m, stats_m = corpus.compress_corpus(images, slice_h=8, mesh=mesh)
    assert blobs == blobs_m
    print(f"mesh x{len(mesh)} ({', '.join(map(str, mesh))}):",
          stats_m.as_dict())

    outs = corpus.decompress_corpus(blobs, mesh=mesh)
    assert all(np.array_equal(a, b) for a, b in zip(outs, images))
    print("round-trip bit-exact for", len(images), "images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
