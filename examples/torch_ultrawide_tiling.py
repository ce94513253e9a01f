"""Ultra-wide images: column tiling (container flag bit 3), through the
PyTorch/CUDA port.

A stripe can never be narrower than the image.  The auto policy
(``api.pick_tiling``, the JAX package's rule over its TPU geometry, kept so
that both packages write the same containers) cuts images wider than
2,048 pixels whose stripes that geometry clamps into column tiles;
``tile_w=0`` opts out, and an explicit ``tile_w`` tiles any image.  This
example shows the knob and what it does to the container.

    python examples/torch_ultrawide_tiling.py [--device cuda|cpu]
                                              [--height H] [--width W]

Runs on the CUDA device unless ``--device cpu`` asks for the kernels'
plain PyTorch versions (slow: keep the image to a few dozen pixels a side).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from llcomp_tpu_torch import api, container


def describe(name: str, blob: bytes, nbytes: int) -> None:
    streams, W, H, C, slice_h, flags, _seed, tile_w = \
        container.unpack_sliced(blob)
    tiles = -(-W // tile_w) if tile_w else 1
    print(f"{name} container: {len(streams)} slices ({tiles} column "
          f"tile(s) of {tile_w or W} px x {-(-H // slice_h)} stripes of "
          f"{slice_h} row(s)), ratio {nbytes / len(blob):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=8192)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    h, w = args.height, args.width
    img = np.clip(
        np.cumsum(rng.integers(-6, 7, (h, w, 3)), axis=1) + 128, 0, 255
    ).astype(np.uint8)

    tw, sh = api.pick_tiling(h, w, 3)
    print(f"policy for {w}x{h}x3: tile_w={tw}, slice_h={sh}")

    blobs = {"auto": api.compress(img, slices="auto", device=args.device)}
    blobs["untiled"] = api.compress(img, slices="auto", tile_w=0,
                                    device=args.device)         # opt out
    if not tw:         # the policy did not tile: tile explicitly
        blobs["4-tile"] = api.compress(img, slices="auto",
                                       tile_w=-(-w // 4), device=args.device)
    for name, blob in blobs.items():
        describe(name, blob, img.nbytes)
        out = api.decompress(blob, device=args.device)
        assert np.array_equal(out, img), f"{name}: round-trip mismatch"
    assert container.unpack_sliced(blobs["untiled"])[-1] == 0
    assert any(container.unpack_sliced(b)[-1] for b in blobs.values())
    print("round-trip exact; which mode compresses smaller is "
          "content-dependent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
