"""Image file I/O: PNM (PPM/PGM) in NumPy, other formats through Pillow.

Port of the JAX package's ``io/images.py``.  The reference CLIs use
stb_image / stb_image_write (`llcompc.cpp:7-11`, `llcompd.cpp:29`).  PNM
needs no dependency, so the CLI runs on a host without Pillow (the GPU
hosts the port targets need not have it) when its files are ``.ppm`` or
``.pgm``; Pillow is imported only for other formats, where installed.
"""
from __future__ import annotations

import pathlib

import numpy as np


def _read_pnm(path: pathlib.Path) -> np.ndarray:
    data = path.read_bytes()
    # header: magic, width, height, maxval separated by whitespace/comments
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] not in b"\r\n":
                i += 1
        elif data[i] in b" \t\r\n":
            i += 1
        else:
            j = i
            while j < len(data) and data[j] not in b" \t\r\n":
                j += 1
            tokens.append(data[i:j])
            i = j
    magic, w, h, maxv = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxv > 255:
        raise ValueError("only 8-bit PNM supported")
    i += 1  # single whitespace after maxval
    c = {b"P5": 1, b"P6": 3}.get(magic)
    if c is None:
        raise ValueError(f"unsupported PNM magic {magic!r}")
    arr = np.frombuffer(data, dtype=np.uint8, count=w * h * c, offset=i)
    return arr.reshape(h, w, c).copy()


def _write_pnm(path: pathlib.Path, img: np.ndarray) -> None:
    h, w, c = img.shape
    if c == 1:
        path.write_bytes(b"P5\n%d %d\n255\n" % (w, h) + img.tobytes())
    elif c == 3:
        path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())
    else:
        raise ValueError(f"PNM supports 1 or 3 channels, got {c}")


def load_image(path) -> np.ndarray:
    """Load an image file -> uint8 [H, W, C] keeping the native channel count."""
    path = pathlib.Path(path)
    if path.suffix.lower() in (".ppm", ".pgm", ".pnm"):
        return _read_pnm(path)
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"Pillow not available; convert {path.suffix} to PPM/PGM first"
        ) from e
    img = np.array(Image.open(path))   # writable, as torch wants it
    if img.dtype != np.uint8:
        raise ValueError(f"only 8-bit images supported, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    return img


def save_image(path, img: np.ndarray) -> None:
    path = pathlib.Path(path)
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if path.suffix.lower() in (".ppm", ".pgm", ".pnm"):
        _write_pnm(path, img)
        return
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("Pillow not available; use a .ppm/.pgm output") from e
    Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img).save(path)
