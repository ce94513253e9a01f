#!/usr/bin/env python3
"""The host's staging of two shards on one GPU, timed apart from the
kernels, in one process: phase 10's bench batch (1,024 lanes of 8x512x3,
seeded) cut in two shards of 512 lanes, each on a side stream of cuda:0.

Forms, each timed by the host clock between two
``torch.cuda.synchronize()``, in turns (the order reversed every other
round):

* ``in pinned fresh``: each shard copied into new pinned memory
  (``pin_memory()``), then an H2D copy that the host does not wait for;
* ``in pinned reused``: the same into pinned buffers made once;
* ``in pageable``: an H2D copy straight from the numpy array;
* ``out pinned fresh``, ``out pinned reused``, ``out pageable``: the read
  back of each shard's bytes up to its longest stream, into new pinned
  memory, into buffers made once, or through ``.cpu()``;
* ``kernels``: each shard's precompute and kernel 1 on its side stream,
  from lanes already on the card;
* ``encode``, ``decode``: ``parallel.encode_lanes_sharded`` and
  ``decode_lanes_sharded`` on ``[cuda:0, cuda:0]``, end to end (host numpy
  in, bytes or pixels out).

Usage, from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``:

    python3 tools/torch_shard_staging.py [--rounds 9]

Prints the card's ``nvidia-smi`` name and power limit, each form's
milliseconds in every round and their median, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from llcomp_tpu_torch import device as devmod
    from llcomp_tpu_torch import encode, parallel, seed
    from llcomp_tpu_torch.core.config import REV2
    from llcomp_tpu_torch.kernels.encode_fused import encode_fused_async

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    mesh = [dev, dev]
    imgs = cs.bench_images(100)
    tab = seed.derive_pooled(imgs[:8], device=dev)
    lanes = cs.bench_lanes(imgs)
    S, H, W, C = lanes.shape
    halves = [lanes[: S // 2], lanes[S // 2 :]]
    side = devmod.side_streams(dev, 2)
    cap = encode.outcap(H * W * C)
    on_card = [torch.from_numpy(h).to(dev) for h in halves]
    outs = []
    for s, x in zip(side, on_card):
        with torch.cuda.stream(s):
            out, lens, _ = encode_fused_async(
                encode._fused_input(x, REV2), tab, cap)
            outs.append(out[:, : int(lens.max())])
    torch.cuda.synchronize()
    pin_in = [torch.empty(h.shape, dtype=torch.uint8, pin_memory=True)
              for h in halves]
    pin_out = [torch.empty(o.shape, dtype=torch.uint8, pin_memory=True)
               for o in outs]

    def in_pinned_fresh():
        for s, h in zip(side, halves):
            host = torch.from_numpy(h).pin_memory()
            with torch.cuda.stream(s):
                host.to(dev, non_blocking=True)

    def in_pinned_reused():
        for s, h, buf in zip(side, halves, pin_in):
            buf.copy_(torch.from_numpy(h))
            with torch.cuda.stream(s):
                buf.to(dev, non_blocking=True)

    def in_pageable():
        for s, h in zip(side, halves):
            with torch.cuda.stream(s):
                torch.from_numpy(h).to(dev)

    def out_pinned_fresh():
        for s, o in zip(side, outs):
            host = torch.empty(o.shape, dtype=torch.uint8, pin_memory=True)
            with torch.cuda.stream(s):
                host.copy_(o, non_blocking=True)
            s.synchronize()

    def out_pinned_reused():
        for s, o, buf in zip(side, outs, pin_out):
            with torch.cuda.stream(s):
                buf.copy_(o, non_blocking=True)
            s.synchronize()

    def out_pageable():
        for s, o in zip(side, outs):
            with torch.cuda.stream(s):
                o.cpu()

    def kernels():
        for s, x in zip(side, on_card):
            with torch.cuda.stream(s):
                encode_fused_async(encode._fused_input(x, REV2), tab, cap)

    fresh = {}

    def sharded_encode():
        fresh["streams"] = parallel.encode_lanes_sharded(
            fresh["lanes"], mesh, seed=tab)

    def sharded_decode():
        back = parallel.decode_lanes_sharded(fresh["streams"], (H, W, C),
                                             mesh, seed=tab)
        assert (back == fresh["lanes"]).all()

    forms = {"in pinned fresh": in_pinned_fresh,
             "in pinned reused": in_pinned_reused,
             "in pageable": in_pageable,
             "out pinned fresh": out_pinned_fresh,
             "out pinned reused": out_pinned_reused,
             "out pageable": out_pageable, "kernels": kernels,
             "encode": sharded_encode, "decode": sharded_decode}
    ms: dict = {k: [] for k in forms}
    for rnd in range(args.rounds + 1):          # round 0 warms up
        fresh["lanes"] = cs.bench_lanes(cs.bench_images(5000 + 97 * rnd))
        for name in (forms if rnd % 2 == 0 else list(forms)[::-1]):
            if name == "decode" and "streams" not in fresh:
                sharded_encode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forms[name]()
            torch.cuda.synchronize()
            if rnd:
                ms[name].append((time.perf_counter() - t0) * 1e3)
        fresh.pop("streams")
    med = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in ms.items():
        print(f"{k}: median {med[k]:.3f} ms, max {max(v):.3f}; "
              + ", ".join(f"{t:.3f}" for t in v), flush=True)
    print(json.dumps({"card": card, "shard_bytes": [h.nbytes for h in halves],
                      "readback_bytes": [o.numel() for o in outs],
                      "median_ms": med, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
