"""Probes p0-p11: per-lane scalar and row access to a model plane, and the
cost split of one symbol step (kernels in ``csrc/probe_mosaic.cu``).

Replace the Pallas probes of ``tools/probe_mosaic.py`` (p0 ``:65`` ...
p11 ``:420``; the source notes give every line).  Arrays are ``[rows,
lanes]`` int32, lanes minor; ``idx`` is ``[k, lanes]`` and only its row 0
is read.  ``model`` planes are updated in place and default to zeros.
Inputs are non-negative, as the TPU probes made them.

    python -m llcomp_tpu_torch.probes.mosaic [p0 ... p11] [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import (Probe, check_i32, check_steps, decide24_plain,
               floor_mod_magic, i32, ints, is_cuda, launch, plane, row_bytes,
               row_store, row_store_plain, row_words, step_row, window,
               window_plain, zeros)
from . import main as _main

SRC = "probe_mosaic"


def _lanes(idx):
    return torch.arange(idx.shape[1], device=idx.device)


def _out(idx, rows=1):
    return torch.empty((rows, idx.shape[1]), dtype=torch.int32,
                       device=idx.device)


def p0_scalar_store_plain(idx):
    r = idx[0].long() % 64
    out = torch.zeros((64, idx.shape[1]), dtype=torch.int32,
                      device=idx.device)
    out[r, _lanes(idx)] = r.to(torch.int32)
    return out


def p0_scalar_store(idx):
    """Per-lane scalar store: out [64, lanes], out[r, l] = r for r =
    idx[0, l] mod 64, zeros elsewhere (the TPU left those cells
    uninitialised)."""
    idx = check_i32("idx", idx)
    if not is_cuda(idx):
        return p0_scalar_store_plain(idx)
    out = _out(idx, 64)
    launch(SRC, "llct_probe_p0", idx, out, idx.shape[1])
    p0_scalar_store.launches += 1
    return out


def p1_scalar_load_plain(idx, src):
    return window_plain(idx, src, 1, 0)


def p1_scalar_load(idx, src):
    """Per-lane scalar load: out [1, lanes], out[0, l] = src[idx[0, l], l]
    (idx clamped into src)."""
    return window(p1_scalar_load, SRC, "llct_probe_p1", idx, src, 1, 0)


def p2_row_load_blend_plain(idx, src):
    return window_plain(idx, src, 1, 0)


def p2_row_load_blend(idx, src):
    """The function of p1, which the TPU computed as a row load and a lane
    blend; on the GPU the same per-lane load."""
    return window(p2_row_load_blend, SRC, "llct_probe_p2", idx, src, 1, 0)


def p3_row_rmw_plain(idx, val, model=None):
    return row_store_plain(idx, val, model)


def p3_row_rmw(idx, val, model=None):
    """Per-lane row read-modify-write: model[idx[0, l] mod 8, l] = val[0,
    l]; out [8, lanes] = model[0:8]."""
    return row_store(p3_row_rmw, SRC, "llct_probe_p3", idx, val, model)


def p4_window_load_plain(idx, src):
    return window_plain(idx, src, 8, 0)


def p4_window_load(idx, src):
    """Per-lane 8-row window: out [8, lanes], out[i, l] = src[r + i, l], r =
    min(idx[0, l], rows - 8)."""
    return window(p4_window_load, SRC, "llct_probe_p4", idx, src, 8, 0)


def p5_sublane_gather32_plain(idx, src):
    return window_plain(idx, src, 1, 32)


def p5_sublane_gather32(idx, src):
    """Gather from the first 32 rows: out[0, l] = src[idx[0, l] mod 32,
    l]."""
    return window(p5_sublane_gather32, SRC, "llct_probe_p5", idx, src, 1, 32)


def p6_smem_staging_plain(idx):
    return i32(idx[:1].long() + 1)


def p6_smem_staging(idx):
    """Scalar staging through the TPU's SMEM, elementwise on the GPU:
    out[0, l] = idx[0, l] + 1."""
    idx = check_i32("idx", idx)
    if not is_cuda(idx):
        return p6_smem_staging_plain(idx)
    out = _out(idx)
    launch(SRC, "llct_probe_p6", idx, out, idx.shape[1])
    p6_smem_staging.launches += 1
    return out


def p7_symbol_step_cost_plain(idx, T=512, model=None):
    model = plane(model, idx.shape[1], idx.device, planes=2)
    x, lane = idx[0].long(), _lanes(idx)
    acc = torch.zeros_like(x)
    for s in range(T):
        r = step_row(x, s, model.shape[1] - 1)
        b, acc = decide24_plain(row_bytes(model[0, r, lane],
                                          model[1, r, lane]), acc)
        model[0, r, lane], model[1, r, lane] = row_words(b)
    return acc[None].to(torch.int32)


def p7_symbol_step_cost(idx, T=512, model=None):
    """T full symbol steps a lane: stage in the lane's model row (bytes 0-3
    from plane 0, 4-7 from plane 1 of ``model`` [2, rows, lanes]) at row
    (idx[0, l]*(s+1) + s*40503) mod (rows - 1), 24 stand-in decisions
    carrying acc, stage the row out.  out [1, lanes] = acc."""
    idx = check_i32("idx", idx)
    model = plane(model, idx.shape[1], idx.device, planes=2)
    check_steps("p7", T, model.shape[1], 2)
    if not is_cuda(idx, model):
        return p7_symbol_step_cost_plain(idx, T, model)
    out = _out(idx)
    launch(SRC, "llct_probe_p7", idx, model[0], model[1], out, idx.shape[1],
           model.shape[1], T)
    p7_symbol_step_cost.launches += 1
    return out


def p8_stage_only_cost_plain(idx, T=512, model=None):
    model = plane(model, idx.shape[1], idx.device)
    x, lane = idx[0].long(), _lanes(idx)
    carry = torch.zeros_like(x)
    for s in range(T):
        r = step_row(x, s, model.shape[0] - 1)
        w = model[r, lane].long()
        model[r, lane] = ((w + carry + 1) & 0xFFFF).to(torch.int32)
        carry = (carry + w) & 0x7FFF
    return carry[None].to(torch.int32)


def p8_stage_only_cost(idx, T=512, model=None):
    """T steps of staging alone: read the lane's word at p7's row, write
    (word + carry + 1) & 0xFFFF back, carry = (carry + word) & 0x7FFF.
    out [1, lanes] = carry."""
    idx = check_i32("idx", idx)
    model = plane(model, idx.shape[1], idx.device)
    check_steps("p8", T, model.shape[0], 2)
    if not is_cuda(idx, model):
        return p8_stage_only_cost_plain(idx, T, model)
    out = _out(idx)
    launch(SRC, "llct_probe_p8", idx, model, out, idx.shape[1],
           model.shape[0], T)
    p8_stage_only_cost.launches += 1
    return out


def _decisions_plain(idx, T):
    b = (idx[0].long() & 0xFF)[None].expand(8, -1).clone()
    acc = torch.zeros_like(b[0])
    for _ in range(T):
        b, acc = decide24_plain(b, acc)
    return acc[None].to(torch.int32)


def p9_decision_only_cost_plain(idx, T=512):
    return _decisions_plain(idx, T)


def p9_decision_only_cost(idx, T=512):
    """T steps of 24 decisions alone (the loop kept), on a row of 8 bytes
    idx[0, l] & 0xFF.  out [1, lanes] = acc."""
    idx = check_i32("idx", idx)
    check_steps("p9", T)
    if not is_cuda(idx):
        return _decisions_plain(idx, T)
    out = _out(idx)
    launch(SRC, "llct_probe_p9", idx, out, idx.shape[1], T)
    p9_decision_only_cost.launches += 1
    return out


def p10_decision_unrolled_plain(idx, T=512):
    return _decisions_plain(idx, T)


def p10_decision_unrolled(idx, T=512):
    """p9 with the 24 decisions unrolled: the same output."""
    idx = check_i32("idx", idx)
    check_steps("p10", T)
    if not is_cuda(idx):
        return _decisions_plain(idx, T)
    out = _out(idx)
    launch(SRC, "llct_probe_p10", idx, out, idx.shape[1], T)
    p10_decision_unrolled.launches += 1
    return out


def p11_stage_few_plain(idx, T=512, nstage=8, model=None):
    model = plane(model, idx.shape[1], idx.device)
    x = idx[0].long()
    k = max(0, min(nstage, idx.shape[1]))
    carry = torch.zeros_like(x)
    for s in range(T):
        r = step_row(x[:k], s, model.shape[0] - 1)
        carry[:k] = (carry[:k] + model[r, _lanes(idx)[:k]]) & 0x7FFF
    return carry[None].to(torch.int32)


def p11_stage_few(idx, T=512, nstage=8, model=None):
    """T steps in which only lanes below ``nstage`` read their word at p7's
    row: carry = (carry + word) & 0x7FFF; the plane is only read.  out [1,
    lanes] = carry (0 in the other lanes; in every lane where ``nstage`` <=
    0).  On CUDA a warp a staged lane sums its T words, the row's floor
    modulo by ``floor_mod_magic``'s constants."""
    idx = check_i32("idx", idx)
    model = plane(model, idx.shape[1], idx.device)
    check_steps("p11", T, model.shape[0], 2)
    if not is_cuda(idx, model):
        return p11_stage_few_plain(idx, T, nstage, model)
    out = _out(idx)
    mul, sh1, sh2, mc = floor_mod_magic(model.shape[0] - 1)
    launch(SRC, "llct_probe_p11", idx, model, out, idx.shape[1],
           model.shape[0], T, nstage, mul - (mul >> 31 << 32), sh1, sh2, mc)
    p11_stage_few.launches += 1
    return out


for _f in (p0_scalar_store, p1_scalar_load, p2_row_load_blend, p3_row_rmw,
           p4_window_load, p5_sublane_gather32, p6_smem_staging,
           p7_symbol_step_cost, p8_stage_only_cost, p9_decision_only_cost,
           p10_decision_unrolled, p11_stage_few):
    _f.launches = 0


def _idx(seed, lanes, rows, dev):
    return ints(seed, rows - 2, (8, lanes), dev)


def _src(seed, lanes, rows, dev):
    return ints(100 + seed, 1 << 20, (rows, lanes), dev)


def _idx_src(seed, lanes, rows, dev):
    return {"idx": _idx(seed, lanes, rows, dev),
            "src": _src(seed, lanes, rows, dev)}


PROBES = {p.name: p for p in (
    Probe("p0", "per-lane scalar store", p0_scalar_store,
          p0_scalar_store_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d)}),
    Probe("p1", "per-lane scalar load", p1_scalar_load, p1_scalar_load_plain,
          _idx_src),
    Probe("p2", "per-lane row load (TPU: + lane blend)", p2_row_load_blend,
          p2_row_load_blend_plain, _idx_src),
    Probe("p3", "per-lane row read-modify-write", p3_row_rmw,
          p3_row_rmw_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "val": ints(100 + s, 1 << 20, (1, n), d),
                              "model": zeros((r, n), d)}),
    Probe("p4", "per-lane (8, lanes) window load", p4_window_load,
          p4_window_load_plain, _idx_src),
    Probe("p5", "gather from 32 rows", p5_sublane_gather32,
          p5_sublane_gather32_plain, _idx_src),
    Probe("p6", "scalar staging (TPU: SMEM)", p6_smem_staging,
          p6_smem_staging_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d)}),
    Probe("p7", "full symbol steps", p7_symbol_step_cost,
          p7_symbol_step_cost_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "model": zeros((2, r, n), d)}, T=512),
    Probe("p8", "stage-only steps", p8_stage_only_cost,
          p8_stage_only_cost_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "model": zeros((r, n), d)}, T=512),
    Probe("p9", "decision-only steps", p9_decision_only_cost,
          p9_decision_only_cost_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d)}, T=512),
    Probe("p10", "decision-only steps, 24 decisions unrolled",
          p10_decision_unrolled, p10_decision_unrolled_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d)}, T=512),
    Probe("p11", "steps staging 8 lanes", p11_stage_few, p11_stage_few_plain,
          lambda s, n, r, d: {"idx": _idx(s, n, r, d),
                              "model": zeros((r, n), d)}, T=512),
)}


def main(argv=None) -> int:
    return _main(PROBES, argv, "python -m llcomp_tpu_torch.probes.mosaic")


if __name__ == "__main__":
    sys.exit(main())
