"""Entry points of the port, the counterpart of the root
``__graft_entry__.py`` (which stays the JAX package's).

``entry(device=)``              -- the flagship compute step and its input:
                                   the fused engine (precompute and kernel 1)
                                   on a batch of 8 lanes.
``dryrun_multichip(n, mesh=)``  -- the sharded round trip over an n-device
                                   list, the fused engine against the sort
                                   engine, and the lanes' placement.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as devmod
from . import encode, parallel
from .core.config import REV2

H, W, C, S = 16, 16, 3, 8


def entry(*, device="cuda"):
    """-> (fn, args): ``fn(*args)`` codes the 8 lanes of 16x16x3 in
    ``args`` (on ``device``) through the fused engine, returning the
    (bytes [8, row] u8, lengths [8] int32) tensors of
    ``encode.fused_tensors``; lane s's stream is ``bytes[s, :lengths[s]]``."""
    dev = devmod.resolve(device)

    def fn(lanes: torch.Tensor):
        return encode.fused_tensors(lanes, REV2)

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (xx * 3 + yy * 5)[..., None] + np.arange(C) * 7
    img = np.clip(base + rng.integers(-2, 3, (H, W, C)), 0, 255).astype(
        np.uint8)
    imgs = np.broadcast_to(img, (S, H, W, C)).copy()
    return fn, (torch.from_numpy(imgs).to(dev),)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, *, mesh=None) -> None:
    """Run the sharded path over ``n_devices`` devices on tiny shapes and
    check it.  ``mesh`` defaults to ``parallel.make_mesh(n_devices)``,
    which raises with fewer GPUs: no CPU fallback (pass ``['cpu'] * n`` to
    run the plain versions).  Checks the exact round trip of
    ``compress_sharded`` and ``decompress_sharded``, that the fused and
    sort engines give equal sharded bytes, that ``shard_plan`` gives device
    k the lanes ``[k*per, (k+1)*per)`` and that those lanes coded alone on
    device k give its part of the sharded streams; raises RuntimeError
    otherwise."""
    mesh = parallel.make_mesh(n_devices) if mesh is None else list(mesh)
    if len(mesh) != n_devices:
        raise ValueError(f"mesh of {len(mesh)} devices, want {n_devices}")
    devs = parallel.devices(mesh)
    h = 8 * n_devices
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:W]
    img = np.clip((xx * 2 + yy)[..., None] % 200
                  + rng.integers(-2, 3, (h, W, 3)), 0, 255).astype(np.uint8)

    blob = parallel.compress_sharded(img, devs, slices=2 * n_devices)
    out = parallel.decompress_sharded(blob, devs)
    _check(np.array_equal(out, img), "sharded round trip mismatch")

    fl = np.stack([img[y : y + 2] for y in range(0, 8, 2)])
    fused = parallel.encode_lanes_sharded(fl, devs, engine="fused")
    sort = parallel.encode_lanes_sharded(fl, devs, engine="sort")
    _check(fused == sort, "sharded fused/sort byte mismatch")

    # lane placement: device k codes the contiguous block [k*per, (k+1)*per)
    # of shard_plan, so each block coded alone on its device gives its part
    # of the sharded streams
    lanes = img[: 2 * n_devices, None]          # one row a lane
    per = 2
    blocks = parallel.shard_plan(len(lanes), n_devices)
    _check(blocks == [(k * per, (k + 1) * per) for k in range(n_devices)],
           f"shard_plan gave {blocks}")
    sharded = parallel.encode_lanes_sharded(lanes, devs)
    for k, (a, b) in enumerate(blocks):
        _check(sharded[a:b] == encode.encode_lanes(lanes[a:b], device=devs[k]),
               f"device {k} ({devs[k]}): its block [{a}, {b}) alone differs "
               "from its part of the sharded streams")
    _check(sharded == encode.encode_lanes(lanes, device=devs[0]),
           "sharded streams differ from encode_lanes'")
    print(f"dryrun_multichip({n_devices}): sliced encode+decode over "
          f"{n_devices} devices ({', '.join(map(str, devs))}) OK "
          f"({img.nbytes}B -> {len(blob)}B); lane placement verified "
          f"({per} lanes/device)")
