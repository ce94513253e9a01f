"""Public in-memory API: compress / decompress / reencode_slice, on a CUDA
device by default.

Port of ``llcomp_tpu/api.py``.  Containers are shaped exactly as the JAX
package shapes them (``pick_tiling`` over the frozen TPU geometry in
``core.geometry``), so the bytes are equal.  ``device`` says where the
port's engines run: 'cuda' the CUDA kernels, 'cpu' their plain PyTorch
versions; 'cuda' without a GPU raises.  ``backend`` says which engine:

* 'torch' (default): the port's engines on ``device``;
* 'native': the threaded C++ runtime on the CPU (``host``), no kernel;
* 'oracle': the plain versions on the CPU (``backend='torch',
  device='cpu'``);
* 'auto': 'native' for a single stream or fewer than ``MIN_DEVICE_LANES``
  stripes, else 'torch' on ``device``, chosen by the shape of the work only;
  'torch' for a cfg other than REV2;
* 'jax', the JAX package's name for its device engines
  (``BACKEND_ALIASES``): 'torch'.

Every function takes the JAX package's parameters in its order, so that a
call written for ``llcomp_tpu`` runs here unchanged with ``device=``
added; ``device`` comes after them and is keyword-only.  One default
differs: ``backend`` is 'torch' where the JAX package says 'auto'
(``compress``, ``decompress``), so that an entry point runs on the card
unless the caller asks for the CPU; where it says 'jax' (``encode_stripes``,
``decode_stripes`` and the corpus), 'torch' is the same engine under the
port's name.  Every backend gives the same bytes.  A failed build or
launch raises; no path falls back to another engine.  ``cfg`` may be any
configuration that ``config.check`` passes; 'native' takes REV2 only, as
the JAX package's native runtime does.  The static prior and the stored
seed hold 8 substates a bucket, so under other ``substates`` the automatic
policy neither primes nor seeds, and asking for either raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import container
from . import device as devmod
from .core import config, geometry, transform
from .core.config import REV2, CodecConfig


def _as_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3:
        raise ValueError(f"expected [H, W, C] or [H, W], got shape {img.shape}")
    return img


def _check_cfg(cfg: CodecConfig, backend: str = "torch") -> None:
    """``config.check``, and REV2 only for the native runtime."""
    config.check(cfg)
    if backend == "native" and cfg != REV2:
        raise ValueError("backend='native' supports the rev-2 cfg only (its "
                         "C++ runtime is compiled for rev 2's constants)")


def pick_slice_height(height: int, width: int, channels: int,
                      target_lanes: int = 32, min_rows: int = 8) -> int:
    """Stripe height of ``compress(slices='auto')`` for an untiled image:
    about ``target_lanes`` stripes of at least ``min_rows`` rows, thinner
    where the JAX package's kernels need it (see ``core.geometry``)."""
    return _pick_slice_height_ex(height, width, channels, target_lanes,
                                 min_rows)[0]


def _pick_slice_height_ex(height: int, width: int, channels: int,
                          target_lanes: int = 32,
                          min_rows: int = 8) -> tuple[int, bool]:
    """(slice height, clamped by the TPU geometry?)."""
    rows = max(min_rows, -(-height // target_lanes))
    stride = width * channels

    def fast(r: int) -> bool:
        return geometry.fits_fast(r, stride)

    rows = max(1, min(height, rows))
    clamped = False
    while rows >= 2 and not fast(rows):
        rows = max(2, rows // 2) if rows > 2 else 1
        clamped = True
    if clamped and fast(rows):
        # clamped wide images: the tallest height at the best sublane packing
        best_r, best_n = rows, geometry.stripe_nsub(rows * stride)
        r = rows
        while r > 1:
            r //= 2
            if not fast(r):
                continue
            n = geometry.stripe_nsub(r * stride)
            if n > best_n:
                best_r, best_n = r, n
        rows = best_r
    if rows >= 2 or height == 1 or fast(1):
        return max(1, min(height, rows)), clamped
    return max(1, min(height, min_rows)), clamped  # extreme width


# Tiles narrower than this are never chosen by the auto policy.
MIN_TILE_W = 1024


def _tile_slice_height(height: int, tile_w: int, channels: int) -> int:
    """Stripe height for a column tile: the tallest at the best packing."""
    stride = tile_w * channels
    r0, _ = _pick_slice_height_ex(height, tile_w, channels)
    best_r = r0
    best_n = (geometry.stripe_nsub(r0 * stride)
              if geometry.fits_fast(r0, stride) else 0)
    r = r0
    while r > 1:
        r //= 2
        if not geometry.fits_fast(r, stride):
            continue
        n = geometry.stripe_nsub(r * stride)
        if n > best_n:
            best_r, best_n = r, n
    return best_r


def pick_tiling(height: int, width: int, channels: int) -> tuple[int, int]:
    """(tile_w, slice_h) for ``compress(slices='auto')``; tile_w 0 = untiled.

    Tiles only geometries already clamped by the TPU geometry, and only when
    tiling at least doubles the reachable sublane packing, preferring the
    widest such tile.  A pure function of geometry, equal to
    ``pick_tiling`` of ``llcomp_tpu/api.py``.
    """
    rows, clamped = _pick_slice_height_ex(height, width, channels)
    if not clamped or width < 2 * MIN_TILE_W:
        return 0, rows
    stride = width * channels
    base_n = (geometry.stripe_nsub(rows * stride)
              if geometry.fits_fast(rows, stride) else 1)
    best_n, best = base_n, (0, rows)
    for k in range(2, width // MIN_TILE_W + 1):
        tw = -(-width // k)
        if tw < MIN_TILE_W:
            break
        r = _tile_slice_height(height, tw, channels)
        if not geometry.fits_fast(r, tw * channels):
            continue
        n = geometry.stripe_nsub(r * tw * channels)
        if n > best_n:
            best_n, best = n, (tw, r)
        if n >= 8:
            break
    if best[0] and best_n >= 2 * base_n:
        return best
    return 0, rows


# Encoder policy: prime photo-like images (few zero residuals), not flat ones.
PRIMED_ZERO_FRAC_MAX = 0.2


def _pick_primed(img: np.ndarray, dev: torch.device,
                 cfg: CodecConfig = REV2) -> bool:
    """Prime iff the zero-residual fraction over sampled 8-row bands (up to
    ~2 MP, the bands ``seed.derive`` samples) is below PRIMED_ZERO_FRAC_MAX;
    never under a cfg whose substates are not the prior's 8."""
    from . import seed

    if cfg.substates != config.TABLE_SUBSTATES:
        return False
    zs, n = 0, 0
    for y0 in seed.band_starts(img, 2.0):
        v = transform.rct_forward(torch.from_numpy(img[y0 : y0 + 8])
                                  .to(dev)[None])
        _, diff = transform.context_and_residual(v, cfg)
        zs += int((diff == 0).sum())
        n += diff.numel()
    return (zs / max(n, 1)) < PRIMED_ZERO_FRAC_MAX


BACKENDS = ("torch", "auto", "native", "oracle")
# The JAX package's backend names -> the port's: 'jax', its device engines,
# is the port's device engines on ``device``.  Every backend gives the same
# bytes, so a name only chooses the engine.
BACKEND_ALIASES = {"jax": "torch"}

# Below this many stripes ``backend='auto'`` takes the native runtime: the
# crossover that chip_smoke.py phase 9 times on 8x512x3 stripes, encode plus
# decode end to end (an H100 beside 8 host cores: native ahead up to 32
# stripes, the two level within 4% at 64, the device ahead from 128; the
# JAX package's TPU value was 32).  Bytes are equal on every engine, so it
# is dispatch policy only.
MIN_DEVICE_LANES = 128


def _check_backend(backend: str) -> str:
    """A backend's name, the port's or the JAX package's
    (``BACKEND_ALIASES``) -> the port's; raises ValueError listing every
    accepted name."""
    if backend not in BACKENDS + tuple(BACKEND_ALIASES):
        raise ValueError(f"backend must be one of "
                         f"{BACKENDS + tuple(BACKEND_ALIASES)}, got "
                         f"{backend!r}")
    return BACKEND_ALIASES.get(backend, backend)


def _resolve_backend(backend: str, device, single: bool = False,
                     lanes: int | None = None, cfg: CodecConfig = REV2
                     ) -> tuple[str, torch.device | None]:
    """-> ('native', None) or ('torch', the resolved device).

    'auto' looks only at the work's shape and the cfg (a cfg other than
    REV2 takes the device engine, as the JAX package's 'auto' takes 'jax'),
    never at whether a GPU is present: a device engine asked for on a host
    without CUDA raises.  'native' raises for a cfg other than REV2."""
    backend = _check_backend(backend)
    _check_cfg(cfg, backend)
    if backend == "auto":
        few = single or (lanes is not None and lanes < MIN_DEVICE_LANES)
        backend = "native" if few and cfg == REV2 else "torch"
    if backend == "native":
        return "native", None
    if backend == "oracle":
        return "torch", torch.device("cpu")
    return "torch", devmod.resolve(device)


def compress(img, slices: int | str | None = None, cfg: CodecConfig = REV2,
             backend: str = "torch", revision: int = 2,
             primed: bool | None = None, seeded: bool | None = None,
             tile_w: int | None = None, *, device="cuda") -> bytes:
    """Compress a uint8 [H, W, C] image.

    slices=None/1 -> reference-compatible single stream.  slices='auto' or
    an int n -> sliced container of independent stripes.  primed, seeded,
    tile_w (sliced mode only): as in the JAX package's ``compress``; None =
    the same automatic policy (never primed nor seeded at substates other
    than 8).  cfg: any that ``config.check`` passes.  device: 'cuda' or
    'cpu'.  backend: see the module's docstring.  revision=0 -> the legacy
    llcomp.js bitstream (magic 0x77, ``rev0``, NumPy on the host).
    """
    img = _as_image(img)
    _check_backend(backend)
    if revision == 0:
        from . import rev0

        return rev0.encode(img)
    if revision != 2:
        raise ValueError(f"unsupported revision {revision}")
    _check_cfg(cfg)
    H, W, C = img.shape
    if slices in (None, 1):
        engine, dev = _resolve_backend(backend, device, single=True, cfg=cfg)
        if primed or seeded or tile_w:
            raise ValueError(
                "primed/seeded/tile_w apply to sliced mode only; "
                "pass slices='auto' or an int >= 2")
        if engine == "native":
            from . import host

            stream = host.encode_stream(img)
        else:
            from . import encode

            stream = encode.encode_lanes(img[None], cfg, device=dev)[0]
        return container.pack_single(stream, W, H, C, cfg)

    if slices == "auto":
        if tile_w is None:
            tw, slice_h = pick_tiling(H, W, C)
        elif tile_w:
            tw = int(tile_w)
            slice_h = _tile_slice_height(H, tw, C)
        else:
            tw, slice_h = 0, pick_slice_height(H, W, C)
    else:
        n = int(slices)
        if n < 1:
            raise ValueError(f"slices must be >= 1 or 'auto', got {n}")
        slice_h = max(1, -(-H // n))
        tw = int(tile_w) if tile_w else 0
    if tw and not 0 < tw < W:
        raise ValueError(f"tile_w {tw} outside (0, width={W})")
    regions = container.tile_regions(W, H, slice_h, tw)
    engine, dev = _resolve_backend(backend, device, lanes=len(regions),
                                   cfg=cfg)
    policy_dev = dev or torch.device("cpu")   # the native runtime's host
    if primed is None:
        primed = len(regions) > 1 and _pick_primed(img, policy_dev, cfg)
    if seeded is None:
        seeded = primed and H * W * C >= 120_000
    config.check_start(cfg, primed or seeded)
    if seeded:
        from . import seed as seedmod

        tab = seedmod.derive(img, cfg, device=policy_dev)
        streams = _encode_regions(img, regions, cfg, True, dev, seed=tab,
                                  backend=engine)
        return container.pack_sliced(
            streams, W, H, C, slice_h, cfg,
            flags=container.FLAG_SEEDED | container.FLAG_CRC,
            seed_blob=seedmod.pack_blob(tab), tile_w=tw)
    streams = _encode_regions(img, regions, cfg, primed, dev, backend=engine)
    return container.pack_sliced(
        streams, W, H, C, slice_h, cfg,
        flags=(container.FLAG_PRIMED if primed else 0) | container.FLAG_CRC,
        tile_w=tw)


def encode_stripes(img: np.ndarray, bounds, cfg: CodecConfig = REV2,
                   primed: bool = False, backend: str = "torch", seed=None,
                   *, device="cuda") -> list[bytes]:
    """Encode full-width stripes ``(y0, y1)`` as independent streams."""
    W = img.shape[1]
    engine, dev = _resolve_backend(backend, device, lanes=len(bounds),
                                   cfg=cfg)
    return _encode_regions(img, [(y0, y1, 0, W) for y0, y1 in bounds], cfg,
                           primed, dev, seed=seed, backend=engine)


def _encode_regions(img: np.ndarray, regions, cfg: CodecConfig,
                    primed: bool, dev: torch.device | None, seed=None,
                    backend: str = "torch") -> list[bytes]:
    """Encode ``(y0, y1, x0, x1)`` regions as independent streams, one lane
    batch per region shape, on ``dev`` or (``backend='native'``, ``dev``
    None) the native runtime."""
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    out: list[bytes | None] = [None] * len(regions)
    for idxs in by_shape.values():
        lanes = np.stack([img[y0:y1, x0:x1]
                          for y0, y1, x0, x1 in (regions[i] for i in idxs)])
        if backend == "native":
            from . import host

            blobs = host.encode_images(lanes, primed=primed, seed=seed)
        else:
            from . import encode

            blobs = encode.encode_lanes(lanes, cfg, primed=primed, seed=seed,
                                        device=dev)
        for i, blob in zip(idxs, blobs):
            out[i] = blob
    return out  # type: ignore[return-value]


def decompress(data: bytes, cfg: CodecConfig = REV2, backend: str = "torch",
               strict: bool = True, *, device="cuda"):
    """Decompress any container format back to a uint8 [H, W, C] image.

    strict=False: a corrupt slice does not raise away the image; returns
    ``(img, bad_slices)``, every slice not listed holding its exact pixels
    (single-stream containers, revision 0 included, report ``[0]``).  A
    header that cannot be read raises ValueError in either mode.  A stream
    with the 0x77 magic decodes as revision 0 (``rev0``, NumPy on the
    host).  device, backend, cfg: as in ``compress``.
    """
    backend = _check_backend(backend)
    _check_cfg(cfg, backend)
    data = bytes(data)
    if container.is_sliced(data):
        (streams, W, H, C, slice_h, flags, seed_blob,
         tile_w) = container.unpack_sliced(data, cfg)
        regions = container.tile_regions(W, H, slice_h, tile_w)
        engine, dev = _resolve_backend(backend, device, lanes=len(regions),
                                       cfg=cfg)
        tab = None
        if flags & container.FLAG_SEEDED:
            from . import seed as seedmod

            tab = seedmod.unpack_blob(seed_blob)
        # the crc table is the authoritative integrity check: failing
        # slices are reported without being decoded
        badcrc = container.verify_slices(data, cfg) or []
        if badcrc and strict:
            raise ValueError(f"corrupt stream in slices {badcrc} "
                             "(crc mismatch)")
        return _decode_regions(streams, regions, (H, W, C), cfg,
                               primed=bool(flags & container.FLAG_PRIMED),
                               dev=dev, strict=strict, seed=tab, skip=badcrc,
                               backend=engine)
    if data[:1] == b"\x77":
        from . import rev0

        def single():
            return rev0.decode(data)

        C, W, H = rev0.header(data)
    else:
        payload, W, H, C = container.unpack_single(data, cfg)
        engine, dev = _resolve_backend(backend, device, single=True, cfg=cfg)

        def single():
            if engine == "native":
                from . import host

                return host.decode_stream(payload, (H, W, C))
            from . import decode

            return decode.decode_lanes([payload], (H, W, C), cfg,
                                       device=dev)[0]
    if strict:
        return single()
    try:
        return single(), []
    except ValueError:
        return np.zeros((H, W, C), np.uint8), [0]


def decode_stripes(streams, bounds, W: int, C: int, cfg: CodecConfig = REV2,
                   primed: bool = False, backend: str = "torch",
                   strict: bool = True, seed=None, skip=(), *, device="cuda"):
    """Decode a sliced container's full-width stripes into one image."""
    H = bounds[-1][1]
    engine, dev = _resolve_backend(backend, device, lanes=len(bounds),
                                   cfg=cfg)
    return _decode_regions(streams, [(y0, y1, 0, W) for y0, y1 in bounds],
                           (H, W, C), cfg, primed=primed, dev=dev,
                           strict=strict, seed=seed, skip=skip,
                           backend=engine)


def _decode_native(streams, shape, primed: bool, seed
                   ) -> tuple[np.ndarray, list[int]]:
    """Native decode of equal-geometry streams -> (lanes, bad lanes).  The
    runtime decodes a batch as a whole, so a failing batch is decoded again
    a stream at a time to name the corrupt ones (`api.py:559-586` of the
    JAX package)."""
    from . import host

    try:
        return host.decode_streams(streams, shape, primed=primed,
                                   seed=seed), []
    except ValueError:
        lanes = np.zeros((len(streams), *shape), np.uint8)
        bad = []
        for k, s in enumerate(streams):
            try:
                lanes[k] = host.decode_stream(s, shape, primed=primed,
                                              seed=seed)
            except ValueError:
                bad.append(k)
        return lanes, bad


def _decode_regions(streams, regions, shape: tuple[int, int, int],
                    cfg: CodecConfig, primed: bool, dev: torch.device | None,
                    strict: bool = True, seed=None, skip=(),
                    backend: str = "torch"):
    """Decode per-region streams into one ``shape`` image, one lane batch
    per region shape, on ``dev`` or (``backend='native'``) the native
    runtime.  ``skip``: slices already known corrupt, zero-filled and
    reported without decoding."""
    H, W, C = shape
    out = np.empty((H, W, C), dtype=np.uint8)
    bad_slices: list[int] = list(skip)
    for i in bad_slices:
        y0, y1, x0, x1 = regions[i]
        out[y0:y1, x0:x1] = 0
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        if i not in bad_slices:
            by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    for (rows, cols), idxs in by_shape.items():
        batch = [streams[i] for i in idxs]
        if backend == "native":
            lanes, bad = _decode_native(batch, (rows, cols, C), primed, seed)
        else:
            from . import decode

            lanes, bad = decode.decode_lanes(
                batch, (rows, cols, C), cfg, primed=primed, errors="report",
                seed=seed, device=dev)
        if bad:
            if strict:
                raise ValueError("corrupt stream in slices "
                                 f"{sorted(idxs[b] for b in bad)}")
            bad_slices.extend(idxs[b] for b in bad)
        for k, i in enumerate(idxs):
            y0, y1, x0, x1 = regions[i]
            out[y0:y1, x0:x1] = lanes[k]
    if strict:
        return out
    return out, sorted(bad_slices)


def reencode_slice(data: bytes, index: int, stripe, cfg: CodecConfig = REV2,
                   *, device="cuda") -> bytes:
    """Replace one stripe of a sliced container in place.

    ``stripe`` is the uint8 pixel block of region ``index`` (a stripe, or a
    stripe of a column tile: ``container.tile_regions``), shape-checked
    against the container.  Each slice is an independent stream with its
    own index entry, so healing a corrupt or stale slice re-encodes only
    its pixels (``encode.encode_lanes`` on ``device``, under the
    container's flags and seed) and splices the stream in; no other payload
    byte moves.  Port of ``reencode_slice`` (`api.py:607-643` of the JAX
    package).
    """
    from . import encode

    _check_cfg(cfg)
    (streams, W, H, C, slice_h, flags, seed_blob,
     tile_w) = container.unpack_sliced(data, cfg)
    regions = container.tile_regions(W, H, slice_h, tile_w)
    if not 0 <= index < len(regions):
        raise IndexError(
            f"slice index {index} out of range [0, {len(regions)})")
    stripe = _as_image(stripe)
    y0, y1, x0, x1 = regions[index]
    if stripe.shape != (y1 - y0, x1 - x0, C):
        raise ValueError(f"stripe shape {stripe.shape} != expected "
                         f"{(y1 - y0, x1 - x0, C)}")
    tab = None
    if flags & container.FLAG_SEEDED:
        from . import seed as seedmod

        tab = seedmod.unpack_blob(seed_blob)
    streams = list(streams)
    streams[index] = encode.encode_lanes(
        stripe[None], cfg, primed=bool(flags & container.FLAG_PRIMED),
        seed=tab, device=device)[0]
    return container.pack_sliced(streams, W, H, C, slice_h, cfg, flags=flags,
                                 seed_blob=seed_blob, tile_w=tile_w)


def compress_sliced(img, slices: int | str = "auto", cfg: CodecConfig = REV2,
                    *, device="cuda", backend: str = "torch") -> bytes:
    """``compress`` into a sliced container (the JAX package's alias)."""
    return compress(img, slices=slices, cfg=cfg, device=device,
                    backend=backend)


def decompress_sliced(data: bytes, cfg: CodecConfig = REV2, *,
                      device="cuda", backend: str = "torch") -> np.ndarray:
    """``decompress`` (the JAX package's alias for sliced containers)."""
    return decompress(data, cfg, backend, device=device)
