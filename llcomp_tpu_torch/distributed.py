"""Several processes on ``torch.distributed``: corpus spans, and one image's
stripes spread over every process with an ordered gather of their streams.

Port of ``llcomp_tpu/distributed.py``.

* ``initialize``: ``torch.distributed.init_process_group`` on a TCP
  address (NCCL by default; gloo for CPU processes); a no-op for one
  process or where a group is already up.
* **Corpus mode**: each process takes a contiguous span of the manifest
  (``corpus_span``) and compresses it alone; file-granular sharding needs
  no communication.
* **Single-image pod mode**: each process encodes its span of one image's
  stripes, then the variable-length streams are exchanged by
  ``_allgather_streams`` (two all-gathers: the lengths, then each rank's
  block of streams) and every process packs the same container.

The encode runs on each rank's device; the collectives carry CUDA tensors
under NCCL and CPU tensors under gloo.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from . import container
from . import device as devmod
from .core.config import REV2, CodecConfig


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> None:
    """Bring up the default process group at ``tcp://coordinator_address``
    (``host:port``) with ``num_processes`` ranks, this one ``process_id``.
    A no-op when a group is already up, or when no address and no count
    are given (one process).  An address or a count left out is read from
    the environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as ``init_process_group`` reads it."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    dist.init_process_group(
        backend,
        init_method=(None if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def corpus_span(n_items: int, process_id: int | None = None,
                process_count: int | None = None) -> tuple[int, int]:
    """Contiguous [start, stop) span of a manifest of ``n_items`` owned by a
    process: by default this one, of the group's size (rank 0 of 1 with no
    group)."""
    up = _group_up()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    pcount = ((dist.get_world_size() if up else 1) if process_count is None
              else process_count)
    per = -(-n_items // pcount)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def _gather_device() -> torch.device:
    """Where the collectives' tensors live: this rank's current CUDA device
    under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_streams(streams: list[bytes], n_total: int,
                       my_offset: int) -> list[bytes]:
    """Exchange variable-length byte streams across the group's processes.

    Every process holds the streams at ``[my_offset, my_offset +
    len(streams))`` of ``n_total``; returns the full ordered list on every
    process.  With no group, the identity (this process must hold all).
    With a group, of any size: one all-gather of each rank's lengths
    (an int64 [n_total] vector, -1 outside its span), then one all-gather
    of each rank's own [max_span, cap] u8 block of streams, cap the longest
    stream.  A rank with an empty span joins both.
    """
    if not 0 <= my_offset <= my_offset + len(streams) <= n_total:
        raise ValueError(f"streams at [{my_offset}, "
                         f"{my_offset + len(streams)}) outside [0, {n_total})")
    if not _group_up():
        if my_offset != 0 or len(streams) != n_total:
            raise ValueError("with no process group this process must hold "
                             f"all {n_total} streams")
        return list(streams)
    world = dist.get_world_size()
    dev = _gather_device()
    lens = np.full(n_total, -1, dtype=np.int64)
    lens[my_offset : my_offset + len(streams)] = [len(s) for s in streams]
    mine = torch.from_numpy(lens).to(dev)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    owned = torch.stack(every).cpu().numpy()          # [world, n_total]
    if not (np.count_nonzero(owned >= 0, axis=0) == 1).all():
        raise ValueError("the ranks' spans do not cover each stream once")
    rows = np.count_nonzero(owned >= 0, axis=1)       # each rank's span
    span, cap = int(rows.max(initial=0)), int(max(1, owned.max(initial=0)))
    block = np.zeros((span, cap), dtype=np.uint8)
    for i, s in enumerate(streams):
        block[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    mine = torch.from_numpy(block).to(dev)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    out: list[bytes] = [b""] * n_total
    for r, got in enumerate(every):
        got = got.cpu().numpy()
        for row, i in enumerate(np.nonzero(owned[r] >= 0)[0]):
            out[i] = got[row, : owned[r, i]].tobytes()
    return out


def _rank_device(device) -> torch.device:
    """``device`` resolved; a bare 'cuda' becomes this rank's card,
    ``cuda:{LOCAL_RANK or rank} % device_count``."""
    dev = devmod.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = int(os.environ.get("LOCAL_RANK",
                              dist.get_rank() if _group_up() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def compress_image_pod(img, slice_h: int = 8, cfg: CodecConfig = REV2,
                       primed: bool | None = None, device="cuda") -> bytes:
    """Compress one image with its stripes spread over the group's
    processes.

    Each process encodes its span of stripes (``corpus_span``) on
    ``device`` (a bare 'cuda': this rank's card), then every process packs
    the identical container from the ordered gather.  ``primed`` None
    decides by ``api._pick_primed``, a pure function of the image, so
    every process takes the same flags: primed or not, and CRC; no seed.
    """
    from . import api, encode

    img = api._as_image(img)
    api._check_cfg(cfg)
    dev = _rank_device(device)
    H, W, C = img.shape
    bounds = container.slice_bounds(H, slice_h)
    if primed is None:
        primed = len(bounds) > 1 and api._pick_primed(img, dev, cfg)
    lo, hi = corpus_span(len(bounds))
    by_shape: dict[int, list[int]] = {}
    for i in range(lo, hi):
        by_shape.setdefault(bounds[i][1] - bounds[i][0], []).append(i)
    local: dict[int, bytes] = {}
    for idxs in by_shape.values():
        lanes = np.stack([img[bounds[i][0] : bounds[i][1]] for i in idxs])
        local.update(zip(idxs, encode.encode_lanes(lanes, cfg, primed=primed,
                                                   device=dev)))
    with devmod.guard(dev):         # under NCCL, the gather on this card
        streams = _allgather_streams([local[i] for i in range(lo, hi)],
                                     len(bounds), lo)
    return container.pack_sliced(
        streams, W, H, C, slice_h, cfg,
        flags=(container.FLAG_PRIMED if primed else 0) | container.FLAG_CRC)


def compress_corpus_distributed(images, slice_h: int = 8,
                                cfg: CodecConfig = REV2, device="cuda"):
    """Each process compresses its span of the manifest on ``device`` (a
    bare 'cuda': this rank's card) -> ((start, stop), its blobs, stats).
    File-granular sharding needs no communication: callers write each blob
    under its manifest name."""
    from . import corpus

    lo, hi = corpus_span(len(images))
    blobs, stats = corpus.compress_corpus(list(images[lo:hi]), slice_h, cfg,
                                          device=_rank_device(device))
    return (lo, hi), blobs, stats
