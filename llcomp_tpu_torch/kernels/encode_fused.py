"""Kernel 1: the fused stream-order encoder (CUDA), and its plain version.

Replaces ``llcomp_tpu/pallas/encode_fused.py::_make_fused_kernel``.  Per lane
and in stream order, each live symbol's up-to-24 decisions go through the
adaptive model and the carry-less range coder, and the coded bytes land in
the lane's row of the output.  The TPU kernel's workarounds (NSUB sublane
packing, the SMEM scalar bridge, the register marker FIFO and its flushes,
``FusedOverflow``) have no counterpart: on the GPU one thread owns one lane,
its model row lives in device memory and it writes its own bytes.

The kernel is bound by each lane's serial chain, not by bytes.  It keeps
every global load off that chain: packed symbols are loaded two ring turns
ahead and model words two symbols ahead into an unrolled register ring,
with equal-hash forwarding so that each symbol codes with the word a
sequential walk reads; a symbol's 8 state-table entries are looked up
together; bytes leave 32 bits at a time; a block holds one lane, so a warp
runs one lane's decisions, not the union of 32.  The source note in
``csrc/encode_fused.cu`` has the details, the measurements behind the
look-ahead depth and the lanes a block, and what is left.

Input ``xs`` is the packed word ``live<<25 | hash<<12 | (diff+1274)`` per
symbol (``encode.precompute``), symbol-major ``[n_sym, S]``.  ``init`` is the
model's start: None (zeros) or a ``[121, 8]`` u8 bucket table (the static
prior for primed containers, or the stored seed): context row h starts at
``init[h % 121]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..coder import Encoder
from ..core import tables, transform
from ..core.config import REV2
from . import build

_NS = REV2.num_states
_P = ctypes.c_void_p
_I = ctypes.c_int


def _model_start(init, S: int, device) -> torch.Tensor:
    """[S, num_states] u8 model: zeros or ``init[h % 121]`` per context row."""
    if init is None:
        return torch.zeros((S, _NS), dtype=torch.uint8, device=device)
    full = tables.prior_full_from(np.asarray(init), _NS, REV2.substates)
    return torch.from_numpy(full).to(device)[None].repeat(S, 1)


def _symbol_fields(x: torch.Tensor):
    """Packed words -> (live, hash, diff, |diff|, exponent e)."""
    live = ((x >> 25) & 1).to(torch.bool)
    h = (x >> 12) & 0x1FFF
    d = (x & 0xFFF) - 1274
    ad = d.abs()
    return live, h, d, ad, transform.ilog2(ad.clamp(min=1), max_bits=12)


def encode_fused_plain(xs: torch.Tensor, init, outcap: int):
    """The kernel's function in plain torch, vectorised over lanes, with
    Python loops over symbols and decisions.  -> (out [S, outcap] u8,
    lens [S] int32, ovf [S] bool)."""
    n_sym, S = xs.shape
    dev = xs.device
    x = xs.to(torch.int64)
    live, h, d, ad, e = _symbol_fields(x)
    nbins = torch.where(ad != 0, 2 * e + 3, 1) * live
    steps = nbins.amax(dim=1).tolist() if S else [0] * n_sym
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    model = _model_start(init, S, dev)
    enc = Encoder(S, outcap, dev)
    for i in range(n_sym):
        for k in range(steps[i]):
            ctx, bit = transform.decision(k, d[i], ad[i], e[i])
            valid = nbins[i] > k
            idx = (h[i] * 8 + ctx)[:, None]
            st = model.gather(1, idx)[:, 0].to(torch.int64)
            f = fused[st]
            ns = torch.where(bit == 1, f >> 16, f >> 8) & 0xFF
            model.scatter_(1, idx, torch.where(valid, ns, st)
                           .to(torch.uint8)[:, None])
            enc.put(bit, f & 0xFF, valid)
    return enc.finish()


def _upload(arr: np.ndarray, dev) -> torch.Tensor:
    """A host table on ``dev`` through pinned memory, ordered on the current
    stream without a host wait (a pageable copy would sync the stream)."""
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)


_TABLES: dict = {}     # (table name, device index) -> the table on that card


def _table(name: str, dev: torch.device) -> torch.Tensor:
    """``tables.<name>`` as int32 on the CUDA device ``dev``, uploaded by
    the first call for that card and kept: the tables are constants, so
    later launches queue no copy for them."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if (name, index) not in _TABLES:
        _TABLES[name, index] = torch.from_numpy(
            getattr(tables, name).astype(np.int32)).to(
                torch.device("cuda", index))
    return _TABLES[name, index]


def encode_fused_async(xs: torch.Tensor, init, outcap: int):
    """``encode_fused`` without its overflow check: -> (bytes [S, outcap]
    u8, lengths [S] int32, overflow flags [S]).  On CUDA nothing waits for
    the kernel: it runs on the current stream (``encode_lanes_pipelined``
    overlaps batches this way) and the caller reads the flags once it has
    synced.  The kernel launches on ``xs``'s device, made current for the
    launch.  Counts the launch in ``encode_fused.launches``."""
    if xs.dim() != 2 or xs.dtype != torch.int32:
        raise ValueError(f"xs must be [n_sym, S] int32, got {tuple(xs.shape)} "
                         f"{xs.dtype}")
    n_sym, S = xs.shape
    if not xs.is_cuda:
        return encode_fused_plain(xs, init, outcap)
    if outcap % 4:
        raise ValueError(f"outcap must be a multiple of 4, got {outcap}")
    xs = xs.contiguous()
    dev = xs.device
    fn = build.load("encode_fused", "llct_encode_fused",
                    [_P] * 7 + [_I] * 3 + [_P])
    with torch.cuda.device(dev):      # the launch runs on the current device
        fused = _table("FUSED", dev)
        init_t = None if init is None else _upload(tables.pack_u64(init), dev)
        model = torch.empty((S, _NS), dtype=torch.uint8, device=dev)
        out = torch.empty((S, outcap), dtype=torch.uint8, device=dev)
        lens = torch.empty(S, dtype=torch.int32, device=dev)
        ovf = torch.empty(S, dtype=torch.int32, device=dev)
        rc = fn(xs.data_ptr(), fused.data_ptr(),
                None if init_t is None else init_t.data_ptr(),
                model.data_ptr(), out.data_ptr(), lens.data_ptr(),
                ovf.data_ptr(), n_sym, S, outcap,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "encode_fused")
    encode_fused.launches += 1
    return out, lens, ovf


def encode_fused(xs: torch.Tensor, init, outcap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode ``S`` lanes: ``xs`` [n_sym, S] int32 -> (bytes [S, outcap] u8,
    lengths [S] int32).

    A CUDA ``xs`` launches the kernel (``outcap`` a multiple of 4: it stores
    32-bit words) and counts the launch in ``encode_fused.launches``; a CPU
    ``xs`` runs ``encode_fused_plain``.  Raises if a lane's bytes overflow
    ``outcap``.
    """
    out, lens, ovf = encode_fused_async(xs, init, outcap)
    if bool(ovf.any()):
        raise RuntimeError(f"encoded stream overflowed outcap={outcap}")
    return out, lens


encode_fused.launches = 0
