#!/usr/bin/env python3
"""Seconds of one part of ``chip_smoke.py`` in two checkouts on one GPU, each
run in a fresh process:

* ``--run phase3`` (default): phase 3, every CUDA kernel against its plain
  PyTorch version (``phase_kernels_vs_plain``);
* ``--run encode``: phase 5's end-to-end encode, ``encode.encode_lanes`` of
  a fresh bench batch (1,024 lanes of 8x512x3, seeded from the first 8
  images; host numpy in, bytes out) after a warm-up, 7 batches, each
  between two ``torch.cuda.synchronize()``;
* ``--run decode``: phase 5's end-to-end decode, ``decode.decode_lanes``
  of the streams of a fresh bench batch (pixels out), timed as the encode;
* ``--run sharded``: phase 10's bench batch through
  ``parallel.encode_lanes_sharded`` and ``decode_lanes_sharded`` on
  ``[cuda:0]`` and ``[cuda:0, cuda:0]``, 7 fresh batches, the lists in
  turns (a checkout with ``llcomp_tpu_torch.parallel`` only);
* ``--run pipeline``: phase 9's corpus encode alone,
  ``encode.encode_lanes_pipelined`` (``max_inflight`` 2) of the lane
  batches that ``corpus.compress_corpus`` gives its 24 images, 7 times.

Usage, from the root of a checkout, on a machine with one CUDA GPU and
``nvcc`` (unpack the other commit with ``git archive`` into the ignored
``_checkout/`` first):

    python3 tools/torch_phase3_seconds.py --parent _checkout/parent \
        [--run encode] [--order parent,change,change,parent]

``--tree NAME=PATH`` names another checkout for ``--order`` (``--parent
PATH`` is ``--tree parent=PATH``).  Each run builds the checkout's kernel
sources (not timed), then times the part, in a fresh process; the runs go
parent then this checkout, or in the order ``--order`` gives.  Prints each
run's log and seconds, the card's ``nvidia-smi`` name and power limit, and
one JSON line.
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
WARM = """
from llcomp_tpu_torch import decode, encode, seed
dev = torch.device("cuda")
imgs = cs.bench_images(100)
tab = seed.derive_pooled(imgs[:8], device=dev)
lanes = cs.bench_lanes(imgs)
H, W, C = lanes.shape[1:]
decode.decode_lanes(encode.encode_lanes(lanes, seed=tab, device=dev),
                    (H, W, C), seed=tab, device=dev)


def fresh(rep):
    return cs.bench_lanes(cs.bench_images(5000 + 97 * rep))


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out
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
""", "decode": BUILD + WARM + """
ts = []
for rep in range(7):
    lanes = fresh(rep)
    st = encode.encode_lanes(lanes, seed=tab, device=dev)
    t, back = timed(lambda: decode.decode_lanes(st, (H, W, C), seed=tab,
                                                device=dev))
    assert (back == lanes).all()
    ts.append(t)
print(f"SECONDS {json.dumps(ts)}", flush=True)
""", "sharded": BUILD + WARM + """
from llcomp_tpu_torch import parallel
meshes = {"[cuda:0]": ["cuda:0"], "[cuda:0, cuda:0]": ["cuda:0"] * 2}
for mesh in meshes.values():
    parallel.decode_lanes_sharded(parallel.encode_lanes_sharded(
        lanes, mesh, seed=tab), (H, W, C), mesh, seed=tab)
ts = {f"{m} {d}": [] for m in meshes for d in ("encode", "decode")}
for rep in range(7):
    lanes = fresh(rep)
    for m in (meshes if rep % 2 == 0 else list(meshes)[::-1]):
        te, st = timed(parallel.encode_lanes_sharded, lanes, meshes[m],
                       seed=tab)
        td, back = timed(parallel.decode_lanes_sharded, st, (H, W, C),
                         meshes[m], seed=tab)
        assert (back == lanes).all()
        ts[f"{m} encode"].append(te)
        ts[f"{m} decode"].append(td)
print(f"SECONDS {json.dumps(ts)}", flush=True)
""", "pipeline": BUILD + """
from llcomp_tpu_torch import corpus, encode
imgs = cs.corpus_images()
piped, pipelined = [], encode.encode_lanes_pipelined


def spy(batches, *a, **k):
    piped.append((batches, a, k))
    return pipelined(batches, *a, **k)


encode.encode_lanes_pipelined = spy
corpus.compress_corpus(imgs, slice_h=16, max_lanes_per_batch=cs.CORPUS_BATCH)
encode.encode_lanes_pipelined = pipelined
batches, a, k = piped[0]
ts = []
for rep in range(7):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipelined(batches, *a, **k)
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
print(f"SECONDS {json.dumps(ts)}", flush=True)
"""}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--order", default="parent,change")
    ap.add_argument("--run", default="phase3", choices=sorted(RUNS))
    args = ap.parse_args()
    trees = {"change": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = pathlib.Path(path).resolve()
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
