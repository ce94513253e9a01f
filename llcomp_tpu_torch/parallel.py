"""Lanes split over a list of devices: sharded encode, decode and sliced
containers.

Port of ``llcomp_tpu/parallel.py``.  The codec's unit of parallelism is the
independent stream: every stage of a lane's encode or decode is a map over
lanes, so splitting a batch over devices needs no collective.  The port's
"mesh" is a list of devices, repeats allowed (``["cuda:0", "cuda:0"]``
runs two shards on one card, ``["cpu"] * 8`` eight on the CPU); device
``k`` takes the contiguous lane block ``shard_plan(S, n)[k]``, with no
padding lanes.  The shards run through the lane loops of ``encode`` and
``decode`` (``device.overlapped``, the one scheduler, of which a single
device is the case of one): every CUDA shard is launched, on a side stream
of its device where the device holds several, before any is collected, so
that shards on several cards, or on one card's idle SMs, overlap; CPU
shards run the plain versions in turn.  The decode runs kernel 2 (the JAX
package decodes sharded lanes on its XLA engine only).
"""
from __future__ import annotations

import numpy as np
import torch

from . import container
from . import decode as decmod
from . import device as devmod
from . import encode as encmod
from .core import config
from .core.config import REV2, CodecConfig
from .device import shard_plan

LANE_AXIS = "lanes"    # the JAX package's mesh axis; kept for the name only


def make_mesh(n_devices: int | None = None) -> tuple[torch.device, ...]:
    """The first ``n_devices`` CUDA devices (every one when None).  Raises
    RuntimeError where fewer exist: a mesh never falls back to the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise RuntimeError(f"make_mesh({n_devices}) needs {max(n, 1)} CUDA "
                           f"device(s), found {have}; pass an explicit list "
                           "such as ['cpu'] * n to run the plain versions")
    return tuple(torch.device("cuda", i) for i in range(n))


def devices(mesh) -> list[torch.device]:
    """A mesh (devices or their names) -> resolved devices, a bare 'cuda'
    taking the current device's index.  Raises where CUDA is asked for and
    absent, and for an empty mesh."""
    devs = [devmod.resolve(d) for d in mesh]
    if not devs:
        raise ValueError("the mesh holds no device")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def encode_lanes_sharded(lanes, mesh, cfg: CodecConfig = REV2,
                         primed: bool = False, seed=None,
                         engine: str = "auto") -> list[bytes]:
    """Encode equal-shaped lanes [S, H, W, C] u8 split over ``mesh`` ->
    per-lane headerless streams, equal to ``encode.encode_lanes``'s.

    primed, seed: the model start, as in ``encode_lanes``.  engine:
    'fused' (kernel 1, through the loop of
    ``encode.encode_lanes_pipelined``: every CUDA shard launched before any
    is collected) or 'sort' (kernels 3 and 4, whose chain syncs between
    stages: the shards run in turn), or a name of the JAX package's
    (``encode.ENGINE_ALIASES``: 'auto', the default, and 'xla' run 'fused',
    'pallas' runs 'sort').  CPU shards run the plain versions.
    """
    engine = encmod._check_args(cfg, engine, "symbol", primed, seed)
    devs = devices(mesh)
    lanes = encmod._as_lanes(lanes)
    if engine == "sort":
        return [s for dev, (a, b) in zip(devs, shard_plan(len(lanes),
                                                          len(devs)))
                if b > a for s in encmod.encode_lanes(
                    lanes[a:b], cfg, engine, primed, seed, device=dev)]
    return encmod._encode_fused([lanes], devs, cfg,
                                encmod._start_table(primed, seed, cfg),
                                encmod.MAX_INFLIGHT)[0]


def decode_lanes_sharded(streams: list[bytes], shape: tuple[int, int, int],
                         mesh, cfg: CodecConfig = REV2, primed: bool = False,
                         seed=None) -> np.ndarray:
    """Decode equal-geometry headerless streams split over ``mesh`` ->
    images [S, H, W, C] u8, through kernel 2 on every CUDA shard (launched
    before any is collected, by the loop of ``decode.decode_lanes``) and
    its plain version on CPU shards.  Raises ValueError naming the global
    lane indices of corrupt streams."""
    config.check(cfg)
    out, bad = decmod._decode(streams, shape,
                              encmod._start_table(primed, seed, cfg),
                              devices(mesh), cfg)
    if bad:
        raise ValueError(f"corrupt stream in lanes {bad}")
    return out


def _by_shape(regions) -> dict[tuple[int, int], list[int]]:
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    return by_shape


def compress_sharded(img, mesh, slices: int | str = "auto",
                     cfg: CodecConfig = REV2) -> bytes:
    """Sliced-container compress with the stripes split over ``mesh``.

    The policy of the JAX package's ``compress_sharded``: ``slices``
    'auto' tiles what ``api.pick_tiling`` tiles, and otherwise aims at 8
    stripes a device (``api.pick_slice_height(target_lanes=8*len(mesh))``);
    an int n cuts ceil(H/n)-row stripes.  Primed by ``api._pick_primed``
    where there are several stripes, seeded (``seed.derive``) where primed
    and H*W*C >= 120,000, CRC always; the policy's sampling runs on the
    mesh's first device.  Regions of one shape form one sharded batch.
    """
    from . import api
    from . import seed as seedmod

    img = api._as_image(img)
    api._check_cfg(cfg)
    devs = devices(mesh)
    H, W, C = img.shape
    tile_w = 0
    if slices == "auto":
        tile_w, slice_h = api.pick_tiling(H, W, C)
        if not tile_w:
            slice_h = api.pick_slice_height(H, W, C,
                                            target_lanes=8 * len(devs))
    else:
        slice_h = max(1, -(-H // int(slices)))
    regions = container.tile_regions(W, H, slice_h, tile_w)
    primed = len(regions) > 1 and api._pick_primed(img, devs[0], cfg)
    seed_tab = seed_blob = None
    if primed and H * W * C >= 120_000:   # api.compress's auto policy
        seed_tab = seedmod.derive(img, cfg, device=devs[0])
        seed_blob = seedmod.pack_blob(seed_tab)
    out: list[bytes] = [b""] * len(regions)
    for idxs in _by_shape(regions).values():
        stack = np.stack([img[y0:y1, x0:x1] for y0, y1, x0, x1
                          in (regions[i] for i in idxs)])
        for i, blob in zip(idxs, encode_lanes_sharded(
                stack, devs, cfg, primed, seed_tab)):
            out[i] = blob
    flags = (container.FLAG_SEEDED if seed_tab is not None
             else container.FLAG_PRIMED if primed else 0)
    return container.pack_sliced(out, W, H, C, slice_h, cfg,
                                 flags=flags | container.FLAG_CRC,
                                 seed_blob=seed_blob, tile_w=tile_w)


def decompress_sharded(data: bytes, mesh, cfg: CodecConfig = REV2
                       ) -> np.ndarray:
    """Decompress a sliced container with its stripes split over ``mesh``,
    one sharded batch per region shape.  Raises ValueError on a slice whose
    crc fails (before decoding) or whose stream is corrupt."""
    from . import seed as seedmod

    (streams, W, H, C, slice_h, flags, seed_blob,
     tile_w) = container.unpack_sliced(data, cfg)
    badcrc = container.verify_slices(data, cfg)
    if badcrc:
        raise ValueError(f"corrupt stream in slices {badcrc} (crc mismatch)")
    seed_tab = None if seed_blob is None else seedmod.unpack_blob(seed_blob)
    primed = bool(flags & (container.FLAG_PRIMED | container.FLAG_SEEDED))
    regions = container.tile_regions(W, H, slice_h, tile_w)
    out = np.empty((H, W, C), dtype=np.uint8)
    for (rows, cols), idxs in _by_shape(regions).items():
        lanes = decode_lanes_sharded([streams[i] for i in idxs],
                                     (rows, cols, C), mesh, cfg, primed,
                                     seed_tab)
        for k, i in enumerate(idxs):
            y0, y1, x0, x1 = regions[i]
            out[y0:y1, x0:x1] = lanes[k]
    return out
