"""Corpus (many-image) encode and decode: stripes of many images share lanes.

Port of ``llcomp_tpu/corpus.py``.  Stripes of equal shape from every image
(and every column tile) form shared lane batches, so a batch is full even
where one image has few stripes; each image's container is put back
together in order, byte-equal to compressing the image alone with the
corpus's settings.  On the device, the batches go through
``encode.encode_lanes_pipelined``, which overlaps their uploads, kernels
and downloads on CUDA streams; with ``mesh=`` (a list of devices) each
batch is split over the devices by ``parallel``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import api, container, profiling
from .core import config
from .core.config import REV2, CodecConfig


@dataclasses.dataclass
class CorpusStats:
    """What one ``compress_corpus`` call did."""

    images: int = 0
    pixels: int = 0
    raw_bytes: int = 0
    compressed_bytes: int = 0
    lanes: int = 0
    batches: int = 0
    encode_s: float = 0.0

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(1, self.compressed_bytes)

    @property
    def bpp(self) -> float:
        return 8.0 * self.compressed_bytes / max(1, self.pixels)

    @property
    def mps(self) -> float:
        return self.pixels / 1e6 / max(1e-9, self.encode_s)

    def as_dict(self) -> dict:
        return {
            "images": self.images,
            "pixels": self.pixels,
            "raw_bytes": self.raw_bytes,
            "compressed_bytes": self.compressed_bytes,
            "ratio": round(self.ratio, 3),
            "bpp": round(self.bpp, 3),
            # 6 digits: a one-image corpus can run well under 0.0005 MP/s
            "mps": round(self.mps, 6),
            "lanes": self.lanes,
            "batches": self.batches,
            "encode_s": round(self.encode_s, 3),
        }


def _region_plan(shapes, slice_h: int, tile_w="auto"):
    """Each image's region layout, and the lane groups.

    -> (eff, regions_per, groups): ``eff[idx] = (slice_h_i, tile_w_i)``
    (with ``tile_w`` 'auto', an image that ``api.pick_tiling`` tiles gets
    its tiled geometry, as ``api.compress`` gives it; every other image
    keeps the corpus ``slice_h``), ``regions_per[idx]`` its stream-order
    ``(y0, y1, x0, x1)`` list, and ``groups`` mapping ``(rows, cols, C)``
    to its ``(idx, j, region)`` members: stripes of equal shape share lanes
    across images and tiles.
    """
    eff: list[tuple[int, int]] = []
    for (H, W, C) in shapes:
        if tile_w == "auto":
            tw, sh = api.pick_tiling(H, W, C)
            if not tw:
                sh = slice_h
        elif tile_w:
            tw = int(tile_w) if 0 < int(tile_w) < W else 0
            sh = api._tile_slice_height(H, tw, C) if tw else slice_h
        else:
            tw, sh = 0, slice_h
        eff.append((sh, tw))
    regions_per = [container.tile_regions(s[1], s[0], e[0], e[1])
                   for s, e in zip(shapes, eff)]
    groups: dict[tuple[int, int, int], list] = {}
    for idx, regs in enumerate(regions_per):
        C = shapes[idx][2]
        for j, (y0, y1, x0, x1) in enumerate(regs):
            groups.setdefault((y1 - y0, x1 - x0, C), []).append(
                (idx, j, (y0, y1, x0, x1)))
    return eff, regions_per, groups


def _resolve(backend: str, device, mesh, lanes: int,
             cfg: CodecConfig = REV2):
    """-> (engine, device) as ``api._resolve_backend`` gives them, or, with
    a mesh (which wins over ``backend``, as in the JAX package), ('torch',
    the mesh's first device) for the policy's sampling."""
    if mesh is None:
        return api._resolve_backend(backend, device, lanes=lanes, cfg=cfg)
    from . import parallel

    api._check_backend(backend)
    return "torch", parallel.devices(mesh)[0]


def _encode_chunks(lanes: list[np.ndarray], cfg: CodecConfig, primed: bool,
                   seed, engine: str, dev, mesh=None) -> list[list[bytes]]:
    """Each lane batch's streams: split over ``mesh``, the native runtime,
    or the device engine with the batches pipelined."""
    if mesh is not None:
        from . import parallel

        return [parallel.encode_lanes_sharded(b, mesh, cfg, primed, seed)
                for b in lanes]
    if engine == "native":
        from . import host

        return [host.encode_images(b, primed=primed, seed=seed)
                for b in lanes]
    from . import encode

    return encode.encode_lanes_pipelined(lanes, cfg, primed=primed,
                                         seed=seed, device=dev)


def compress_corpus(images: list[np.ndarray], slice_h: int = 16,
                    cfg: CodecConfig = REV2, max_lanes_per_batch: int = 4096,
                    mesh=None, primed: bool | None = None,
                    backend: str = "torch", seeded: bool | None = None,
                    tile_w: int | str = "auto", *, device="cuda"
                    ) -> tuple[list[bytes], CorpusStats]:
    """Compress many images -> (one sliced container each, stats).

    Stripes of all images share lane batches (grouped by shape, at most
    ``max_lanes_per_batch`` lanes a batch).  ``primed``: None decides once
    for the corpus, by a majority vote of ``api._pick_primed`` over the
    first 8 images.  ``seeded``: None stores a pooled seed (flag bit 1,
    ``seed.derive_pooled`` of the first 16 images) in every container when
    the corpus is primed and its mean image holds at least 120,000 bytes;
    each container stays decodable alone.  ``tile_w``: 'auto' tiles the
    images that ``api.compress`` tiles; 0 never tiles; an int tiles every
    image wider than it.  ``backend`` and ``device``: as in
    ``api.compress``, 'auto' deciding by the corpus's stripe count.
    ``mesh``: a list of devices (``parallel.make_mesh``) over which each
    batch is split; it takes the place of ``backend`` and ``device``, and
    ``seeded`` None then stores no seed (the JAX package's policy).
    """
    from . import seed as seedmod

    with profiling.span("corpus/plan"):
        images = [api._as_image(im) for im in images]
        api._check_cfg(cfg)
        shapes = [im.shape for im in images]
        eff, regions_per, groups = _region_plan(shapes, slice_h, tile_w)
        engine, dev = _resolve(backend, device, mesh,
                               lanes=sum(len(r) for r in regions_per),
                               cfg=cfg)
    policy_dev = dev or torch.device("cpu")   # the native runtime's host
    if primed is None:
        with profiling.span("corpus/policy"):
            votes = [api._pick_primed(im, policy_dev, cfg)
                     for im in images[:8]]
        primed = sum(votes) * 2 > len(votes)
    if seeded is None:
        mean_raw = sum(im.nbytes for im in images) / max(len(images), 1)
        seeded = primed and mesh is None and mean_raw >= 120_000
    config.check_start(cfg, primed or seeded)
    seed_tab = seed_blob = None
    if seeded:
        with profiling.span("corpus/seed"):
            seed_tab = seedmod.derive_pooled(images[:16], cfg,
                                             device=policy_dev)
            seed_blob = seedmod.pack_blob(seed_tab)
        primed = True
    stats = CorpusStats(images=len(images))

    t0 = time.perf_counter()
    with profiling.span("corpus/stack"):
        members, lanes = [], []
        for group in groups.values():
            for start in range(0, len(group), max_lanes_per_batch):
                chunk = group[start : start + max_lanes_per_batch]
                members.append(chunk)
                lanes.append(np.stack([images[i][y0:y1, x0:x1]
                                       for i, _j, (y0, y1, x0, x1) in chunk]))
                stats.lanes += len(chunk)
                stats.batches += 1
    per_image: list[list] = [[None] * len(regs) for regs in regions_per]
    with profiling.span("corpus/lanes"):
        for chunk, streams in zip(members, _encode_chunks(
                lanes, cfg, primed, seed_tab, engine, dev, mesh)):
            for (i, j, _region), blob in zip(chunk, streams):
                per_image[i][j] = blob
    stats.encode_s = time.perf_counter() - t0

    flags = ((container.FLAG_SEEDED if seeded
              else container.FLAG_PRIMED if primed else 0)
             | container.FLAG_CRC)
    blobs = []
    with profiling.span("corpus/pack"):
        for idx, im in enumerate(images):
            H, W, C = im.shape
            blob = container.pack_sliced(per_image[idx], W, H, C,
                                         eff[idx][0], cfg, flags=flags,
                                         seed_blob=seed_blob,
                                         tile_w=eff[idx][1])
            blobs.append(blob)
            stats.pixels += H * W
            stats.raw_bytes += im.nbytes
            stats.compressed_bytes += len(blob)
    return blobs, stats


def decompress_corpus(blobs: list[bytes], cfg: CodecConfig = REV2,
                      max_lanes_per_batch: int = 4096, mesh=None,
                      backend: str = "torch", *,
                      device="cuda") -> list[np.ndarray]:
    """Decompress many sliced containers, stripes of equal shape, flags and
    seed sharing lane batches across images.  ``mesh``: a list of devices
    over which each batch is split, in place of ``backend`` and
    ``device``.  Raises ValueError on a corrupt stream."""
    from . import decode
    from . import seed as seedmod

    with profiling.span("corpus/parse"):
        api._check_cfg(cfg)
        metas = [container.unpack_sliced(b, cfg) for b in blobs]
    with profiling.span("corpus/plan"):
        # the seed blob is part of the key, so every batch has one start table
        groups: dict[tuple, list[tuple[int, tuple, bytes]]] = {}
        for idx, (streams, W, H, C, slice_h, flags, seed_blob,
                  tile_w) in enumerate(metas):
            primed = bool(flags & container.FLAG_PRIMED)
            for j, (y0, y1, x0, x1) in enumerate(
                    container.tile_regions(W, H, slice_h, tile_w)):
                groups.setdefault(
                    (y1 - y0, x1 - x0, C, primed, seed_blob),
                    []).append((idx, (y0, y1, x0, x1), streams[j]))
        engine, dev = _resolve(backend, device, mesh,
                               lanes=sum(len(m) for m in groups.values()),
                               cfg=cfg)
        seed_tabs = {blob: seedmod.unpack_blob(blob) for *_, blob in groups
                     if blob is not None}
        outs = [np.empty((H, W, C), dtype=np.uint8)
                for (_, W, H, C, _, _, _, _) in metas]
    for (rows, cols, C, primed, seed_blob), group in groups.items():
        seed_tab = seed_tabs.get(seed_blob)
        for start in range(0, len(group), max_lanes_per_batch):
            chunk = group[start : start + max_lanes_per_batch]
            streams = [m[2] for m in chunk]
            with profiling.span("corpus/lanes"):
                if mesh is not None:
                    from . import parallel

                    lanes = parallel.decode_lanes_sharded(
                        streams, (rows, cols, C), mesh, cfg, primed, seed_tab)
                elif engine == "native":
                    from . import host

                    lanes = host.decode_streams(streams, (rows, cols, C),
                                                primed=primed, seed=seed_tab)
                else:
                    lanes = decode.decode_lanes(streams, (rows, cols, C), cfg,
                                                primed=primed, seed=seed_tab,
                                                device=dev)
            with profiling.span("corpus/assemble"):
                for (idx, (y0, y1, x0, x1), _), lane in zip(chunk, lanes):
                    outs[idx][y0:y1, x0:x1] = lane
    return outs
