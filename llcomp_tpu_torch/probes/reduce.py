"""The reduce probe: per-lane counters flushed when their maximum over the
whole tile crosses a threshold (kernel in ``csrc/probe_reduce.cu``).

Replaces the Pallas probe of ``tools/probe_reduce.py`` (``_kernel``
``:25``, ``run`` ``:54``).  ``x`` is ``[rows, lanes]`` int32, lanes minor,
walked in order 8 rows at a time.

    python -m llcomp_tpu_torch.probes.reduce [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import Probe, check_i32, i32, ints, is_cuda, launch
from . import main as _main

SRC = "probe_reduce"
MAX_LANES = 128     # the (8, lanes) tile: one block, one thread a word


def run_plain(x):
    fill = torch.zeros((8, x.shape[1]), dtype=torch.int64, device=x.device)
    flushed = torch.zeros_like(fill)
    acc = fill
    for c in range(x.shape[0] // 32):
        acc = torch.zeros_like(fill)
        for j in range(4):
            v = x[c * 32 + j * 8: c * 32 + j * 8 + 8].long()
            fill = fill + (v & 1)
            acc = acc + v
            flush = fill.max() > 3
            flushed = torch.where(flush, flushed + fill, flushed)
            fill = torch.where(flush, 0, fill)
    return i32(torch.cat([flushed, acc]))


def run(x):
    """Walk ``x`` [rows, lanes] in 32-row blocks, 8 rows at a time: fill +=
    v & 1 and acc += v; where max(fill) over the (8, lanes) tile exceeds 3,
    add fill to out[0:8] and reset it.  acc restarts every 32 rows; out
    [16, lanes] holds the flushed counts, then the last block's acc.  Rows
    past the last multiple of 32 are not read."""
    x = check_i32("x", x)
    if x.shape[0] < 32 or x.shape[1] > MAX_LANES:
        raise ValueError(f"the reduce probe takes at least 32 rows and at "
                         f"most {MAX_LANES} lanes, got {tuple(x.shape)}")
    if not is_cuda(x):
        return run_plain(x)
    out = torch.empty((16, x.shape[1]), dtype=torch.int32, device=x.device)
    launch(SRC, "llct_probe_reduce", x, out, x.shape[1], x.shape[0])
    run.launches += 1
    return out


run.launches = 0

PROBES = {"reduce": Probe(
    "reduce", "block max gating a flush", run, run_plain,
    lambda s, n, r, d: {"x": ints(s, 4, (64, n), d)})}


def main(argv=None) -> int:
    return _main(PROBES, argv, "python -m llcomp_tpu_torch.probes.reduce")


if __name__ == "__main__":
    sys.exit(main())
