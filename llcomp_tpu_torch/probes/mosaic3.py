"""Probes pG and pH: a reduction over a whole block as a branch predicate,
and the stage cost split with and without a per-lane data window (kernels
in ``csrc/probe_mosaic3.cu``).

Replace the Pallas probes of ``tools/probe_mosaic3.py`` (pG ``:48``, pH
``:76``).  Arrays are ``[rows, lanes]`` int32, lanes minor.  pH's model
plane is updated in place and defaults to zeros.  Inputs are
non-negative, as the TPU probes made them.

    python -m llcomp_tpu_torch.probes.mosaic3 [pG pHw pHn] [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import (Probe, check_i32, check_steps, i32, ints, is_cuda,
               launch, plane, zeros)
from . import main as _main

SRC = "probe_mosaic3"
MAX_LANES = 1024        # pH: the TPU probe's bound on lanes, one thread each
GATE_WORDS = 32768      # pG: the words one block holds in registers
DATA_ROWS = 1000        # pH's windows b..b+7, b = r mod 992, lie below this


def pG_scalar_gate_plain(x):
    return i32(x.long() + torch.where(x.max() > 100, 1, -1))


def _aligned_like(x):
    """An empty contiguous tensor of ``x``'s shape that starts at ``x``'s
    address mod 16, so that the kernel's 16-byte loads of x and stores to
    it line up (a contiguous view of x may start off a 16-byte
    boundary)."""
    buf = torch.empty(x.numel() + 3, dtype=x.dtype, device=x.device)
    off = (x.data_ptr() - buf.data_ptr()) // 4 % 4
    return buf[off:off + x.numel()].view(x.shape)


def pG_scalar_gate(x):
    """out = x + 1 if max(x) > 100 else x - 1, the max over all of ``x``
    (a block-wide reduction driving a branch), sums wrapping in 32 bits.
    On CUDA one block holds x in registers (one warp up to 1,024 words),
    so x holds at most ``GATE_WORDS`` words."""
    x = check_i32("x", x)
    if not 0 < x.numel() <= GATE_WORDS:
        raise ValueError(f"pG takes 1 to {GATE_WORDS} words, got "
                         f"{x.numel()}")
    if not is_cuda(x):
        return pG_scalar_gate_plain(x)
    out = _aligned_like(x)
    launch(SRC, "llct_probe_pG", x, out, x.numel())
    pG_scalar_gate.launches += 1
    return out


def pH_stage_plain(idx, data, T=256, window=True, model=None):
    lanes = idx.shape[1]
    model = plane(model, lanes, idx.device)
    lane = torch.arange(lanes, device=idx.device)
    rows8 = torch.arange(8, device=idx.device)[:, None]
    carry = torch.zeros((), dtype=torch.int64, device=idx.device)
    for s in range(T):
        r = (i32(idx[s % idx.shape[0]].long() + carry).long()
             % (model.shape[0] - 16)) & ~1
        wa, wb = model[r, lane].long(), model[r + 1, lane].long()
        part = (data[(r % 992)[None] + rows8, lane[None]].long().sum()
                if window else torch.zeros_like(carry))
        model[r, lane], model[r + 1, lane] = i32(wa + 1), i32(wb + 1)
        carry = i32(carry + i32(part).long()).long() % 1009
    return carry.to(torch.int32).expand(8, lanes).contiguous()


def pH_stage(idx, data, T=256, window=True, model=None):
    """T steps over all lanes with one scalar carry: lane l stages the
    words (r, r+1) of its model column in and out (+1 each), r = ((idx[s
    mod k, l] + carry) mod (rows - 16)) rounded down to even; with
    ``window`` it reads data[b:b+8, l], b = r mod 992; carry = (carry + the
    sum of all lanes' windows) mod 1009.  ``idx`` [k, lanes], ``data``
    [>= 1000, lanes]; out [8, lanes] = the last carry.  On CUDA the lanes
    are spread over one thread-block cluster (``csrc/probe_mosaic3.cu``);
    a cluster launch the card refuses raises."""
    idx = check_i32("idx", idx)
    data = check_i32("data", data, idx.shape[1])
    model = plane(model, idx.shape[1], idx.device)
    check_steps("pH", T, model.shape[0], 17)
    if idx.shape[1] > MAX_LANES or data.shape[0] < DATA_ROWS:
        raise ValueError(f"pH takes at most {MAX_LANES} lanes and data of at "
                         f"least {DATA_ROWS} rows, got {tuple(data.shape)}")
    if not idx.shape[0] or not idx.shape[1]:
        raise ValueError(f"pH: idx needs a row and a lane, got "
                         f"{tuple(idx.shape)}")
    if not is_cuda(idx, data, model):
        return pH_stage_plain(idx, data, T, window, model)
    out = torch.empty((8, idx.shape[1]), dtype=torch.int32, device=idx.device)
    launch(SRC, "llct_probe_pH", idx, data, model, out, idx.shape[1],
           idx.shape[0], model.shape[0], T, int(window))
    pH_stage.launches += 1
    return out


pG_scalar_gate.launches = 0
pH_stage.launches = 0


def _gate(seed, lanes, rows, dev):
    """(8, lanes) values below 90 (even seeds) or 110 (odd seeds): both
    branches, as the TPU probe's inputs."""
    return {"x": ints(seed, 90 + 20 * (seed % 2), (8, lanes), dev)}


def _stage(window):
    def make(seed, lanes, rows, dev):
        return {"idx": ints(100 + seed, rows - 16, (64, lanes), dev),
                "data": ints(200 + seed, 1 << 20, (1024, lanes), dev),
                "window": window, "model": zeros((rows, lanes), dev)}
    return make


PROBES = {p.name: p for p in (
    Probe("pG", "block max as a branch predicate", pG_scalar_gate,
          pG_scalar_gate_plain, _gate),
    Probe("pHw", "stage steps with an 8-row data window", pH_stage,
          pH_stage_plain, _stage(True), T=256),
    Probe("pHn", "stage steps without the window", pH_stage, pH_stage_plain,
          _stage(False), T=256),
)}


def main(argv=None) -> int:
    return _main(PROBES, argv, "python -m llcomp_tpu_torch.probes.mosaic3")


if __name__ == "__main__":
    sys.exit(main())
