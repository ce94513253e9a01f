#!/usr/bin/env python3
"""Seconds of one part of ``chip_smoke.py`` in two checkouts on one GPU, each
run in a fresh process:

* ``--run phase3`` (default): phase 3, every CUDA kernel against its plain
  PyTorch version (``phase_kernels_vs_plain``);
* ``--run encode``: phase 5's end-to-end encode, ``encode.encode_lanes`` of
  a fresh bench batch (1,024 lanes of 8x512x3, seeded from the first 8
  images; host numpy in, bytes out) after a warm-up, 7 batches, each
  between two ``torch.cuda.synchronize()``.

Usage, from the root of a checkout, on a machine with one CUDA GPU and
``nvcc`` (unpack the other commit with ``git archive`` into the ignored
``_checkout/`` first):

    python3 tools/torch_phase3_seconds.py --parent _checkout/parent \
        [--run encode] [--order parent,change,change,parent]

Each run builds the checkout's kernel sources (not timed), then times the
part; the runs go parent then this checkout, or in the order ``--order``
gives.  Prints each run's log and seconds, the card's ``nvidia-smi`` name
and power limit, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = """
import json, time, torch, chip_smoke as cs
from concurrent.futures import ThreadPoolExecutor
from llcomp_tpu_torch.kernels import build
with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:
    list(pool.map(build.build, cs.KERNEL_SOURCES))
"""
RUNS = {"phase3": BUILD + """
t0 = time.perf_counter()
cs.phase_kernels_vs_plain(torch, lambda m: print(m, flush=True))
print(f"SECONDS {json.dumps([time.perf_counter() - t0])}", flush=True)
""", "encode": BUILD + """
from llcomp_tpu_torch import encode, seed
dev = torch.device("cuda")
imgs = cs.bench_images(100)
tab = seed.derive_pooled(imgs[:8], device=dev)
encode.encode_lanes(cs.bench_lanes(imgs), seed=tab, device=dev)
ts = []
for rep in range(7):
    fresh = cs.bench_lanes(cs.bench_images(5000 + 97 * rep))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode.encode_lanes(fresh, seed=tab, device=dev)
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
print(f"SECONDS {json.dumps(ts)}", flush=True)
"""}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--order", default="parent,change")
    ap.add_argument("--run", default="phase3", choices=sorted(RUNS))
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    seconds = {}
    for label in args.order.split(","):
        r = subprocess.run([sys.executable, "-c", RUNS[args.run]],
                           cwd=trees[label], capture_output=True, text=True,
                           timeout=1200)
        print(f"--- {label} ({trees[label]}), rc {r.returncode}\n"
              f"{r.stdout}{r.stderr[-3000:]}", flush=True)
        m = re.search(r"SECONDS (.+)", r.stdout)
        if r.returncode or m is None:
            return 1
        seconds.setdefault(label, []).append(json.loads(m[1]))
    print(json.dumps({"card": card, f"{args.run}_seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
