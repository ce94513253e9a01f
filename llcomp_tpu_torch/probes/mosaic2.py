"""Probes pA-pF: the TPU's vector-to-scalar bridge, per-lane row access at a
scalar offset, and the mock symbol step on a pair of rows (kernels in
``csrc/probe_mosaic2.cu``).

Replace the Pallas probes of ``tools/probe_mosaic2.py`` (pA ``:71`` ...
pF ``:222``; the source notes give every line).  Arrays are ``[rows,
lanes]`` int32, lanes minor; ``idx`` is ``[k, lanes]`` and only its row 0
is read.  ``model`` planes are updated in place and default to zeros.
Inputs are non-negative, as the TPU probes made them.

    python -m llcomp_tpu_torch.probes.mosaic2 [pA ... pF] [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import (Probe, check_i32, check_steps, decide24_plain, i32, ints,
               is_cuda, launch, plane, row_bytes, row_store, row_store_plain,
               row_words, step_row, window, window_plain, zeros)
from . import main as _main

SRC = "probe_mosaic2"


def pA_dma_bridge_plain(idx):
    return i32(idx[:1].long() * 2 + 1)


def pA_dma_bridge(idx):
    """The TPU's VMEM-to-SMEM bridge, elementwise on the GPU: out[0, l] =
    idx[0, l] * 2 + 1."""
    idx = check_i32("idx", idx)
    if not is_cuda(idx):
        return pA_dma_bridge_plain(idx)
    out = torch.empty((1, idx.shape[1]), dtype=torch.int32, device=idx.device)
    launch(SRC, "llct_probe_pA", idx, out, idx.shape[1])
    pA_dma_bridge.launches += 1
    return out


def pB_dyn_row_load_plain(idx, src):
    return window_plain(idx, src, 1, 0)


def pB_dyn_row_load(idx, src):
    """Per-lane row load at the lane's index: out[0, l] = src[idx[0, l],
    l] (idx clamped into src)."""
    return window(pB_dyn_row_load, SRC, "llct_probe_pB", idx, src, 1, 0)


def pC_dyn_row_rmw_plain(idx, val, model=None):
    return row_store_plain(idx, val, model)


def pC_dyn_row_rmw(idx, val, model=None):
    """Per-lane row read-modify-write at the lane's index: model[idx[0, l]
    mod 8, l] = val[0, l]; out [8, lanes] = model[0:8]."""
    return row_store(pC_dyn_row_rmw, SRC, "llct_probe_pC", idx, val, model)


def pD_window_load_plain(idx, src, win=8):
    return window_plain(idx, src, win, 0)


def pD_window_load(idx, src, win=8):
    """Per-lane window of ``win`` rows: out [win, lanes], out[i, l] =
    src[r + i, l], r = min(idx[0, l], rows - win)."""
    if win < 1:
        raise ValueError(f"pD: win must be positive, got {win}")
    return window(pD_window_load, SRC, "llct_probe_pD", idx, src, win, 0,
                  win)


def pE_taa_plain(idx, src, rows=16):
    return window_plain(idx, src, 1, rows)


def pE_taa(idx, src, rows=16):
    """Gather from the first ``rows`` rows: out[0, l] = src[idx[0, l] mod
    rows, l]."""
    if rows < 1:
        raise ValueError(f"pE: rows must be positive, got {rows}")
    return window(pE_taa, SRC, "llct_probe_pE", idx, src, 1, rows, rows)


def pF_symbol_step_plain(idx, T=256, model=None):
    model = plane(model, idx.shape[1], idx.device)
    x = idx[0].long()
    lane = torch.arange(idx.shape[1], device=idx.device)
    acc = torch.zeros_like(x)
    for s in range(T):
        h = 2 * step_row(x, s, model.shape[0] // 2 - 1)
        b, acc = decide24_plain(row_bytes(model[h, lane], model[h + 1, lane]),
                                acc)
        model[h, lane], model[h + 1, lane] = row_words(b)
    return acc[None].to(torch.int32)


def pF_symbol_step(idx, T=256, model=None):
    """T mock symbol steps a lane on the row pair (h, h+1) of ``model``, h =
    2 * ((idx[0, l]*(s+1) + s*40503) mod (rows/2 - 1)): stage the two words
    in, 24 unrolled decisions carrying acc, stage them out.  out [1, lanes]
    = acc."""
    idx = check_i32("idx", idx)
    model = plane(model, idx.shape[1], idx.device)
    check_steps("pF", T, model.shape[0], 4)
    if not is_cuda(idx, model):
        return pF_symbol_step_plain(idx, T, model)
    out = torch.empty((1, idx.shape[1]), dtype=torch.int32, device=idx.device)
    launch(SRC, "llct_probe_pF", idx, model, out, idx.shape[1],
           model.shape[0], T)
    pF_symbol_step.launches += 1
    return out


for _f in (pA_dma_bridge, pB_dyn_row_load, pC_dyn_row_rmw, pD_window_load,
           pE_taa, pF_symbol_step):
    _f.launches = 0


def _idx(seed, lanes, rows, dev):
    return ints(seed, rows - 16, (1, lanes), dev)


def _window(win=None, height=None):
    def make(seed, lanes, rows, dev):
        kw = {"idx": _idx(seed, lanes, rows, dev),
              "src": ints(100 + seed, 1 << 20, (rows, lanes), dev)}
        if win:
            kw["win"] = win
        if height:
            kw["rows"] = height
        return kw
    return make


PROBES = {p.name: p for p in (
    Probe("pA", "scalar bridge (TPU: VMEM->SMEM DMA)", pA_dma_bridge,
          pA_dma_bridge_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d)}),
    Probe("pB", "per-lane row load at the lane's index", pB_dyn_row_load,
          pB_dyn_row_load_plain, _window()),
    Probe("pC", "per-lane row read-modify-write", pC_dyn_row_rmw,
          pC_dyn_row_rmw_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "val": ints(100 + s, 1 << 20, (1, n), d),
                              "model": zeros((r, n), d)}),
    Probe("pD8", "per-lane (8, lanes) window load", pD_window_load,
          pD_window_load_plain, _window(win=8)),
    Probe("pD16", "per-lane (16, lanes) window load", pD_window_load,
          pD_window_load_plain, _window(win=16)),
    Probe("pE16", "gather from 16 rows", pE_taa, pE_taa_plain,
          _window(height=16)),
    Probe("pE32", "gather from 32 rows", pE_taa, pE_taa_plain,
          _window(height=32)),
    Probe("pF", "mock symbol steps on row pairs, decisions unrolled",
          pF_symbol_step, pF_symbol_step_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "model": zeros((r, n), d)}, T=256),
)}


def main(argv=None) -> int:
    return _main(PROBES, argv, "python -m llcomp_tpu_torch.probes.mosaic2")


if __name__ == "__main__":
    sys.exit(main())
