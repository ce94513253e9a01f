"""Minimal in-memory round trip through the PyTorch/CUDA port.

    python examples/torch_basic_roundtrip.py [--device cuda|cpu] [--size N]
                                             [image.ppm]

Runs on the CUDA device unless ``--device cpu`` asks for the kernels'
plain PyTorch versions (slow: keep ``--size`` to a few dozen pixels).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import llcomp_tpu_torch


def synth_image(size: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size]
    return np.clip(
        np.stack([xx % 256, (xx + yy) % 256, yy % 256], -1)
        + rng.integers(-3, 4, (size, size, 3)),
        0, 255,
    ).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", nargs="?", help="a .ppm/.pgm (or, with Pillow, "
                    "any image) instead of the synthetic one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256,
                    help="side of the synthetic image")
    args = ap.parse_args(argv)
    if args.image:
        from llcomp_tpu_torch.io import load_image

        img = load_image(args.image)
    else:
        img = synth_image(args.size)

    # reference-compatible single stream (bit-exact vs llcompc)
    blob = llcomp_tpu_torch.compress(img, device=args.device)
    assert np.array_equal(
        llcomp_tpu_torch.decompress(blob, device=args.device), img)
    print(f"single stream: {img.nbytes} -> {len(blob)} bytes "
          f"({img.nbytes / len(blob):.2f}x)")

    # sliced container: every stripe an independent stream, a lane each
    blob_s = llcomp_tpu_torch.compress(img, slices="auto", device=args.device)
    assert np.array_equal(
        llcomp_tpu_torch.decompress(blob_s, device=args.device), img)
    print(f"sliced:        {img.nbytes} -> {len(blob_s)} bytes "
          f"({img.nbytes / len(blob_s):.2f}x)")
    print("both round trips exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
