"""Fault-tolerant decode and in-place repair of a sliced container, through
the PyTorch/CUDA port.

A corrupt stripe costs one stripe: it is reported instead of raising, and
heals with a pure splice (``api.reencode_slice``).

    python examples/torch_fault_tolerance.py [--device cuda|cpu] [--size N]

Runs on the CUDA device unless ``--device cpu`` asks for the kernels'
plain PyTorch versions (slow: keep ``--size`` to a few dozen pixels; at
least 16, so that the container holds two stripes).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from llcomp_tpu_torch import api, container


def synth_image(size: int) -> np.ndarray:
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:size, 0:size]
    return np.clip(
        128 + 64 * np.sin(xx / 17.0)[..., None]
        + 48 * np.cos(yy / 11.0)[..., None]
        + np.arange(3) * 9 + rng.integers(-3, 4, (size, size, 3)),
        0, 255,
    ).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256,
                    help="side of the synthetic image")
    args = ap.parse_args(argv)
    img = synth_image(args.size)

    blob = api.compress(img, slices="auto", device=args.device)
    streams, W, H, C, slice_h, flags, _seed, _tw = \
        container.unpack_sliced(blob)
    print(f"container: {len(streams)} slices of {slice_h} rows, "
          f"flags={flags:#x} (seeded={bool(flags & container.FLAG_SEEDED)}), "
          f"{len(blob)} bytes (ratio {img.nbytes / len(blob):.2f})")
    assert len(streams) >= 2, "the image is too small to hold two stripes"

    # storage corruption: zero one slice's payload bytes in the container
    # (an arithmetic stream decodes most byte soups to some pixels; the
    # per-slice crc32 table, flag bit 2, is what detects it)
    k = min(3, len(streams) - 1)
    payload = len(blob) - sum(len(s) for s in streams)  # the streams, last
    start = payload + sum(len(s) for s in streams[:k])
    broken = bytearray(blob)
    broken[start : start + len(streams[k])] = bytes(len(streams[k]))
    broken = bytes(broken)

    out, bad_slices = api.decompress(broken, strict=False, device=args.device)
    assert bad_slices == [k], bad_slices
    print(f"non-strict decode: bad slices = {bad_slices}; "
          f"{len(streams) - len(bad_slices)} of {len(streams)} slices exact")

    bounds = container.slice_bounds(H, slice_h)
    for i in bad_slices:  # repair from the source rows (or a replica)
        y0, y1 = bounds[i]
        broken = api.reencode_slice(broken, i, img[y0:y1], device=args.device)
    print("healed == original container:", broken == blob)
    assert broken == blob
    np.testing.assert_array_equal(api.decompress(broken, device=args.device),
                                  img)
    print("round-trip exact after repair")
    return 0


if __name__ == "__main__":
    sys.exit(main())
