"""Lane decoding: per-lane rev-2 streams -> ``[S, H, W, C]`` u8 stripes.

Port of ``decode_lanes`` in ``llcomp_tpu/decode.py`` with ``_decode_lanes_pallas``
(`decode.py:627-761`): streams are packed zero-padded to the bucketed cap,
kernel 2 (``kernels.decode_kernel``) decodes them, ``rct_inverse`` runs on the
device, and lanes whose streams tripped the corruption guards are reported.
A chunk is launched (H2D, kernel 2, inverse RCT queued on a stream) apart
from its collection (D2H), and ``device.overlapped`` runs the chunks, so
that a list of devices (``parallel``) starts every shard before it waits
on any.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as devmod
from . import profiling
from .core import geometry, transform
from .core.config import REV2, CodecConfig
from .encode import _start_table, _to_host
from .kernels.decode_kernel import decode

# Device bytes one chunk of lanes may hold: model rows, stream bytes, planes
# in two layouts and the decoded pixels.
LANE_BUDGET_BYTES = 8 << 30


def _pack(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Streams -> (zero-padded [S, bucket_cap] u8, lengths [S] int32)."""
    lens = np.array([len(s) for s in streams], dtype=np.int32)
    cap = geometry.bucket_cap(int(lens.max(initial=0)))
    data = np.zeros((len(streams), cap), dtype=np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return data, lens


def lanes_per_chunk(streams: list[bytes], n_sym: int) -> int:
    """Lanes of ``n_sym`` samples that one chunk decodes at once: as many
    as ``LANE_BUDGET_BYTES`` holds at the longest stream, at least one."""
    max_len = max((len(s) for s in streams), default=0)
    per_lane = REV2.num_states + geometry.bucket_cap(max_len) + 13 * n_sym
    return max(1, LANE_BUDGET_BYTES // per_lane)


def _kernel(data: torch.Tensor, lens: torch.Tensor, shape, init
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 and the inverse RCT -> (images [S, H, W, C] u8, err [S])."""
    H, W, C = shape
    planes, err = decode(data, lens, H, W, C, init)
    return transform.rct_inverse(planes.t().reshape(-1, H, W, C)), err


def _upload(data: np.ndarray, lens: np.ndarray, dev: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)


def _launch_chunk(streams: list[bytes], shape, init, dev: torch.device,
                  stream):
    """Start decoding one chunk of ``streams`` on ``dev`` and ``stream``
    (None: the current stream), both made current: the H2D copies
    (pageable: the host waits for the copies, not for the kernels before
    them), kernel 2 and ``rct_inverse`` are queued.  Each stage is
    ``profiling.timed`` on the current stream and only named on a side
    stream.  -> what ``_collect_chunk`` takes: device (images, err), and
    the stream."""
    stage = profiling.timed if stream is None else profiling.marked
    with devmod.guard(dev, stream):
        data, lens = stage("decode/upload", _upload, *_pack(streams), dev)
        imgs, err = stage("decode/kernel", _kernel, data, lens, shape, init)
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
            devs: list) -> tuple[np.ndarray, list[int]]:
    """The decode's loop: ``streams`` split over ``devs``
    (``device.shard_plan``) and cut into chunks of ``lanes_per_chunk``
    lanes, run through ``device.overlapped`` with one chunk of each shard
    of a device in flight.  -> (images [S, H, W, C] u8, the lanes whose
    streams tripped the corruption guards, ascending)."""
    H, W, C = shape
    cut = devmod.pieces(len(streams), devs,
                        lanes_per_chunk(streams, H * W * C))
    done = devmod.overlapped(
        [(dev, (streams[lo:hi], shape, init)) for dev, lo, hi in cut],
        _launch_chunk, _collect_chunk, devmod.most_shards(devs))
    order = sorted(range(len(cut)), key=lambda i: cut[i][1])
    bad = sorted(cut[i][1] + k for i in order for k in done[i][1])
    if not cut:
        return np.zeros((0, H, W, C), dtype=np.uint8), bad
    return np.concatenate([done[i][0] for i in order]), bad


def decode_lanes(streams: list[bytes], shape: tuple[int, int, int],
                 cfg: CodecConfig = REV2, primed: bool = False,
                 errors: str = "raise", seed=None, device="cuda"):
    """Decode equal-geometry headerless streams -> images [S, H, W, C] u8.

    primed / seed: the model start, as in ``encode.encode_lanes`` (a seed
    promotes ``primed``).  errors: 'raise' raises ValueError naming the
    corrupt lanes; 'report' returns ``(images, bad_lanes)`` instead, with
    every lane not in ``bad_lanes`` exact.  The loop of
    ``parallel.decode_lanes_sharded`` on a list of one device.
    """
    if cfg != REV2:
        raise ValueError("llcomp_tpu_torch supports the rev-2 cfg only")
    if errors not in ("raise", "report"):
        raise ValueError(f"errors must be 'raise' or 'report', got {errors!r}")
    out, bad = _decode(streams, shape, _start_table(primed, seed),
                       [devmod.resolve(device)])
    if errors == "report":
        return out, bad
    if bad:
        raise ValueError(f"corrupt stream in lanes {bad}")
    return out
