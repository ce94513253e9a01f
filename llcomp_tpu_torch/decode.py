"""Lane decoding: per-lane streams -> ``[S, H, W, C]`` u8 stripes.

Port of ``decode_lanes`` in ``llcomp_tpu/decode.py`` with ``_decode_lanes_pallas``
(`decode.py:627-761`): streams are packed zero-padded to the bucketed cap,
kernel 2 (``kernels.decode_kernel``) decodes them, ``rct_inverse`` runs on the
device, and lanes whose streams tripped the corruption guards are reported.
A chunk is launched (H2D, kernel 2, inverse RCT queued on a stream) apart
from its collection (D2H), and ``device.overlapped`` runs the chunks, so
that a list of devices (``parallel``) starts every shard before it waits
on any.  ``decode_lanes(streams, shape, cfg, engine, primed, errors, seed)``
takes the JAX package's parameters in its order, with ``device`` after them,
keyword-only; each of the JAX package's decode engine names (``ENGINES``)
runs kernel 2.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as devmod
from . import profiling
from .core import config, geometry, transform
from .core.config import REV2, CodecConfig
from .encode import _start_table, _to_host
from .kernels.decode_kernel import decode
from .kernels.encode_fused import model_bytes

# Device bytes one chunk of lanes may hold: model rows, stream bytes, planes
# in two layouts and the decoded pixels.
LANE_BUDGET_BYTES = 8 << 30
# The JAX package's decode engines: kernel 2 there, or one of its XLA scans
# ("Not to port").  Each gives the same pixels, so each name runs kernel 2
# (its plain version on the CPU) on ``device``.
ENGINES = ("auto", "pallas", "decision", "lockstep", "rowbatch")


def _pack(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Streams -> (zero-padded [S, bucket_cap] u8, lengths [S] int32)."""
    lens = np.array([len(s) for s in streams], dtype=np.int32)
    cap = geometry.bucket_cap(int(lens.max(initial=0)))
    data = np.zeros((len(streams), cap), dtype=np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return data, lens


def lanes_per_chunk(streams: list[bytes], n_sym: int,
                    cfg: CodecConfig = REV2) -> int:
    """Lanes of ``n_sym`` samples that one chunk decodes at once: as many
    as ``LANE_BUDGET_BYTES`` holds at the longest stream (with ``cfg``'s
    model), at least one."""
    max_len = max((len(s) for s in streams), default=0)
    per_lane = model_bytes(cfg) + geometry.bucket_cap(max_len) + 13 * n_sym
    return max(1, LANE_BUDGET_BYTES // per_lane)


def _kernel(data: torch.Tensor, lens: torch.Tensor, shape, init,
            cfg: CodecConfig = REV2) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 and the inverse RCT -> (images [S, H, W, C] u8, err [S])."""
    H, W, C = shape
    planes, err = decode(data, lens, H, W, C, init, cfg)
    return transform.rct_inverse(planes.t().reshape(-1, H, W, C)), err


def _upload(data: np.ndarray, lens: np.ndarray, dev: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)


def _launch_chunk(streams: list[bytes], shape, init, cfg: CodecConfig,
                  dev: torch.device, stream):
    """Start decoding one chunk of ``streams`` on ``dev`` and ``stream``
    (None: the current stream), both made current: the H2D copies
    (pageable: the host waits for the copies, not for the kernels before
    them), kernel 2 and ``rct_inverse`` are queued.  Each stage is
    ``profiling.timed`` on the current stream and only named on a side
    stream; the host's packing of the streams is ``decode/pack``.  -> what
    ``_collect_chunk`` takes: device (images, err), and the stream."""
    stage = profiling.timed if stream is None else profiling.marked
    with profiling.span("decode/pack"):
        packed = _pack(streams)
    with devmod.guard(dev, stream):
        data, lens = stage("decode/upload", _upload, *packed, dev)
        imgs, err = stage("decode/kernel", _kernel, data, lens, shape, init,
                          cfg)
    return imgs, err, stream


def _collect_chunk(imgs: torch.Tensor, err: torch.Tensor, stream
                   ) -> tuple[np.ndarray, list[int]]:
    """Bring back a chunk's images and error flags -> (images, the lanes
    whose streams tripped the corruption guards)."""
    stage = profiling.timed if stream is None else profiling.marked
    with devmod.guard(imgs.device, stream):
        out = stage("decode/download", _to_host, imgs)
        return out, np.nonzero(_to_host(err))[0].tolist()


def _decode(streams: list[bytes], shape: tuple[int, int, int], init,
            devs: list, cfg: CodecConfig = REV2
            ) -> tuple[np.ndarray, list[int]]:
    """The decode's loop: ``streams`` split over ``devs``
    (``device.shard_plan``) and cut into chunks of ``lanes_per_chunk``
    lanes, run through ``device.overlapped`` with one chunk of each shard
    of a device in flight.  -> (images [S, H, W, C] u8, the lanes whose
    streams tripped the corruption guards, ascending)."""
    H, W, C = shape
    cut = devmod.pieces(len(streams), devs,
                        lanes_per_chunk(streams, H * W * C, cfg))
    done = devmod.overlapped(
        [(dev, (streams[lo:hi], shape, init, cfg)) for dev, lo, hi in cut],
        _launch_chunk, _collect_chunk, devmod.most_shards(devs))
    order = sorted(range(len(cut)), key=lambda i: cut[i][1])
    bad = sorted(cut[i][1] + k for i in order for k in done[i][1])
    if not cut:
        return np.zeros((0, H, W, C), dtype=np.uint8), bad
    with profiling.span("decode/concat"):
        return np.concatenate([done[i][0] for i in order]), bad


def decode_lanes(streams: list[bytes], shape: tuple[int, int, int],
                 cfg: CodecConfig = REV2, engine: str = "auto",
                 primed: bool = False, errors: str = "raise", seed=None, *,
                 device="cuda"):
    """Decode equal-geometry headerless streams -> images [S, H, W, C] u8.

    engine: any of the JAX package's names (``ENGINES``); every one runs
    kernel 2 on ``device``.  primed / seed: the model start, as in
    ``encode.encode_lanes`` (a seed promotes ``primed``).  errors: 'raise'
    raises ValueError naming the
    corrupt lanes; 'report' returns ``(images, bad_lanes)`` instead, with
    every lane not in ``bad_lanes`` exact.  cfg: any that ``config.check``
    passes.  The loop of ``parallel.decode_lanes_sharded`` on a list of one
    device.
    """
    config.check(cfg)
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if errors not in ("raise", "report"):
        raise ValueError(f"errors must be 'raise' or 'report', got {errors!r}")
    out, bad = _decode(streams, shape, _start_table(primed, seed, cfg),
                       [devmod.resolve(device)], cfg)
    if errors == "report":
        return out, bad
    if bad:
        raise ValueError(f"corrupt stream in lanes {bad}")
    return out
