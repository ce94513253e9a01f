"""Command-line interface of the port, on the GPU by default.

Port of the JAX package's ``cli.py``: both reference CLIs (`llcompc.cpp`,
`llcompd.cpp`), the sliced mode, a stream inspector, corpus batching and a
conformance self-test:

    python -m llcomp_tpu_torch.cli compress   <image> [-o OUT] [--slices N|auto]
                                              [--tile-w auto|0|PX]
                                              [--backend B] [--revision 0|2]
                                              [--device cuda|cpu]
    python -m llcomp_tpu_torch.cli decompress <file.llcomp|.llct> [-o OUT]
    python -m llcomp_tpu_torch.cli info       <file.llcomp|.llct>
    python -m llcomp_tpu_torch.cli corpus     <dir> [-o OUTDIR] [--verify]
    python -m llcomp_tpu_torch.cli selftest   [--device cuda|cpu]

Like the reference, ``compress`` writes ``<input>.llcomp`` (``<input>.llct``
in sliced mode) and ``decompress`` writes ``<input>.png`` unless ``-o``
names a file; ``.ppm`` and ``.pgm`` need no Pillow.  ``--device cuda``
(the default) runs the CUDA kernels and fails without a GPU; ``--device
cpu`` runs their plain PyTorch versions; ``--backend native`` the C++ host
runtime, and ``--backend jax`` (the JAX CLI's name) the same engines as
``torch``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from . import container
from .api import BACKEND_ALIASES, BACKENDS
from .core.config import EXT, EXT_SLICED

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm"}

# Single-stream containers pinned by the JAX package's self-test
# (`cli.py:132-139` there), and a 12x8x3 probe's container (bytes of the
# JAX package's NumPy oracle).
GOLDEN = (
    (np.array([[[10, 20, 30]]], dtype=np.uint8),
     bytes.fromhex("790301000100" "8374be4365c6")),
    (np.array([[[0, 0, 0], [255, 255, 255]],
               [[128, 64, 32], [1, 2, 3]]], dtype=np.uint8),
     bytes.fromhex("790302000200" "8369acbe11430f72fa279a75645a50140baf6c")),
)
PROBE_HEX = (
    "790308000c0083782299454c2692b829c21a4ec7180e3688c291ee7ba0246848fd89"
    "35fb737e426fa9d568c50ce49154ba6bccfc96c5c96ac823214483fc96721a261e90"
    "2a70a5a18e16898a80d70b559de7356c7b5d7028c5995aaf7c1344a76b3b7c40d357"
    "ea40e19c95f39e542622c7d44ade535e94a7c8278289096f40ea458456f75c1b3cea"
    "c0b584d6fd8a0c94292bc6")


def probe_image() -> np.ndarray:
    """The self-test's 12x8x3 probe: a gradient with a hashed +-3 noise
    (integer arithmetic only, so every host makes the same pixels)."""
    y, x, c = np.ogrid[:12, :8, :3]
    i = (y * 8 + x) * 3 + c
    noise = ((i * 2654435761) >> 13) % 7 - 3
    return np.clip(64 + 9 * x + 5 * y + 10 * c + noise, 0,
                   255).astype(np.uint8)


def _cmd_compress(args) -> int:
    from . import api
    from .io import load_image

    img = load_image(args.input)
    slices = args.slices
    if slices not in (None, "auto"):
        slices = int(slices)
    tile_w = None if args.tile_w == "auto" else int(args.tile_w)
    t0 = time.perf_counter()
    blob = api.compress(img, slices=slices, backend=args.backend,
                        revision=args.revision, tile_w=tile_w,
                        device=args.device)
    dt = time.perf_counter() - t0
    out = pathlib.Path(args.output if args.output else str(args.input) + (
        EXT_SLICED if container.is_sliced(blob) else EXT))
    out.write_bytes(blob)
    h, w, _ = img.shape
    print(f"{args.input}: {img.nbytes} -> {len(blob)} bytes "
          f"({img.nbytes / len(blob):.2f}x, {8 * len(blob) / (h * w):.3f} "
          f"bpp, {h * w / 1e6 / dt:.2f} MP/s) -> {out}")
    return 0


def _cmd_decompress(args) -> int:
    from . import api
    from .io import save_image

    data = pathlib.Path(args.input).read_bytes()
    t0 = time.perf_counter()
    img = api.decompress(data, backend=args.backend, device=args.device)
    dt = time.perf_counter() - t0
    out = pathlib.Path(args.output if args.output else str(args.input)
                       + ".png")
    save_image(out, img)
    h, w, c = img.shape
    print(f"{args.input}: {w}x{h}x{c} ({h * w / 1e6 / dt:.2f} MP/s) -> {out}")
    return 0


def _cmd_info(args) -> int:
    data = pathlib.Path(args.input).read_bytes()
    if container.is_sliced(data):
        (streams, w, h, c, slice_h, flags, seed,
         tile_w) = container.unpack_sliced(data)
        mode = ""
        if flags & container.FLAG_PRIMED:
            mode += " primed"
        if flags & container.FLAG_SEEDED:
            mode += f" seeded({len(seed)}B)"
        if flags & container.FLAG_CRC:
            mode += " crc"
        if flags & container.FLAG_TILED:
            mode += f" tiled({tile_w}px)"
        print(f"sliced container v{container.CONTAINER_VERSION} (rev 2{mode})")
        tiles = -(-w // tile_w) if tile_w else 1
        geom = (f"{len(streams)} slices of {slice_h} rows"
                + (f" x {tiles} column tiles of {tile_w} px" if tile_w
                   else ""))
        print(f"  {w}x{h}x{c}, {geom}")
        print(f"  payload {sum(len(s) for s in streams)} bytes, "
              f"{8 * len(data) / (w * h):.3f} bpp")
        lens = [len(s) for s in streams]
        print(f"  slice bytes: min {min(lens)}, max {max(lens)}")
        bad = container.verify_slices(data)
        if bad:
            print(f"  CORRUPT slices (crc mismatch): {bad}")
        elif bad == []:
            print("  integrity: all slice crcs OK")
    elif data[:1] == b"\x77":
        from . import rev0

        c, w, h = rev0.header(data)
        print("single stream (legacy revision 0, llcomp.js format)")
        print(f"  {w}x{h}x{c}, payload {len(data) - 6} bytes, "
              f"{8 * len(data) / max(w * h, 1):.3f} bpp")
    else:
        payload, w, h, c = container.unpack_single(data)
        print("single stream (rev 2, reference-compatible)")
        print(f"  {w}x{h}x{c}, payload {len(payload)} bytes, "
              f"{8 * len(data) / max(w * h, 1):.3f} bpp")
    return 0


def _cmd_selftest(args) -> int:
    """The golden containers and the probe through every engine of the
    port: on ``--device`` kernel 1, the sort engine's symbol (kernels 3,
    4) and decision (kernels 5-7) variants and kernel 2 (their plain
    versions with ``--device cpu``), and the native runtime."""
    from . import decode, device, encode, host

    dev = device.resolve(args.device)
    tag = "" if dev.type == "cuda" else "plain "
    encoders = {
        f"fused ({tag}kernel 1)": lambda im: encode.encode_lanes(
            im[None], device=dev)[0],
        f"sort, symbol ({tag}kernels 3, 4)": lambda im: encode.encode_lanes(
            im[None], device=dev, engine="sort")[0],
        f"sort, decision ({tag}kernels 5-7)": lambda im: encode.encode_lanes(
            im[None], device=dev, engine="sort", variant="decision")[0],
        "native": host.encode_stream,
    }
    decoders = {
        f"{tag}kernel 2": lambda s, shape: decode.decode_lanes(
            [s], shape, device=dev)[0],
        "native": host.decode_stream,
    }
    cases = [*GOLDEN, (probe_image(), bytes.fromhex(PROBE_HEX))]
    failures = 0
    for name, fn in encoders.items():
        ok = all(container.pack_single(fn(img), img.shape[1], img.shape[0],
                                       img.shape[2]) == want
                 for img, want in cases)
        print(f"{'ok  ' if ok else 'FAIL'} encode engine {name} byte-exact")
        failures += not ok
    for name, fn in decoders.items():
        ok = all(np.array_equal(fn(want[6:], img.shape), img)
                 for img, want in cases)
        print(f"{'ok  ' if ok else 'FAIL'} decode engine {name} exact")
        failures += not ok
    print("selftest:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


def _cmd_corpus(args) -> int:
    from . import corpus
    from .io import load_image

    indir = pathlib.Path(args.indir)
    outdir = pathlib.Path(args.outdir) if args.outdir else indir
    outdir.mkdir(parents=True, exist_ok=True)
    paths = sorted(p for p in indir.iterdir()
                   if p.suffix.lower() in IMAGE_EXTS)
    if not paths:
        print(f"error: no images in {indir}", file=sys.stderr)
        return 1
    images = [load_image(p) for p in paths]
    blobs, stats = corpus.compress_corpus(images, slice_h=args.slice_h,
                                          backend=args.backend,
                                          device=args.device)
    for p, blob in zip(paths, blobs):
        (outdir / (p.name + EXT_SLICED)).write_bytes(blob)
    if args.verify:
        outs = corpus.decompress_corpus(blobs, backend=args.backend,
                                        device=args.device)
        bad = [p.name for p, a, b in zip(paths, outs, images)
               if not np.array_equal(a, b)]
        if bad:
            print(f"error: verify failed for {bad}", file=sys.stderr)
            return 1
        print(f"verified {len(paths)} images bit-exact")
    print(json.dumps(stats.as_dict()))
    return 0


def _engine_args(p: argparse.ArgumentParser, backend: bool = True) -> None:
    if backend:
        p.add_argument("--backend", default="torch",
                       choices=BACKENDS + tuple(BACKEND_ALIASES),
                       help="torch (the port's engines on --device, "
                            "default), auto, native (C++ on the CPU), "
                            "oracle (plain versions on the CPU) or jax "
                            "(the JAX package's name for torch)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels, default) or cpu (their plain "
                        "versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="llcomp-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress", help="image -> .llcomp/.llct")
    pc.add_argument("input")
    pc.add_argument("-o", "--output")
    pc.add_argument("--slices", default=None,
                    help="'auto' or stripe count; omit for reference format")
    pc.add_argument("--tile-w", dest="tile_w", default="auto",
                    help="column tile width for very wide images: 'auto' "
                         "(policy, default), 0 to disable, or a pixel "
                         "width (sliced mode only)")
    pc.add_argument("--revision", type=int, default=2, choices=[0, 2],
                    help="bitstream revision: 2 (default) or legacy 0 "
                         "(llcomp.js)")
    _engine_args(pc)
    pc.set_defaults(fn=_cmd_compress)

    pd = sub.add_parser("decompress", help=".llcomp/.llct -> image")
    pd.add_argument("input")
    pd.add_argument("-o", "--output")
    _engine_args(pd)
    pd.set_defaults(fn=_cmd_decompress)

    pi = sub.add_parser("info", help="inspect a compressed file")
    pi.add_argument("input")
    pi.set_defaults(fn=_cmd_info)

    pb = sub.add_parser(
        "corpus", help="compress every image in a directory (shared lanes)")
    pb.add_argument("indir")
    pb.add_argument("-o", "--outdir", default=None)
    pb.add_argument("--slice-h", type=int, default=8)
    pb.add_argument("--verify", action="store_true",
                    help="decode everything back and compare pixels")
    _engine_args(pb)
    pb.set_defaults(fn=_cmd_corpus)

    ps = sub.add_parser("selftest", help="golden vectors through every "
                                         "engine")
    _engine_args(ps, backend=False)
    ps.set_defaults(fn=_cmd_selftest)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
