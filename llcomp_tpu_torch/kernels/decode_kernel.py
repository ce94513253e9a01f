"""Kernel 2: the decoder (CUDA), and its plain version.

Replaces ``llcomp_tpu/pallas/decode_kernel.py::_make_kernel_blocked`` and its
per-symbol twin ``::_make_kernel``: one kernel takes every geometry, odd
strides (``W*C % 8 != 0``) and ``C > 8`` included.  The TPU kernels'
workarounds (the NSUB lane-group packing, the 3-row VMEM line ring, the
per-symbol byte windows, the SMEM scalar bridge, the deferred write-back)
have no counterpart: one thread owns one lane and reads neighbours back from
its own output planes.

The kernel is bound by each lane's serial chain.  Only the model load stays
on it, and only for C = 1: a symbol's hash is known once the sample C
symbols back is, so its model word is loaded C - 1 symbols ahead (with
equal-hash forwarding, as in kernel 1); the rows above are loaded a ring
turn ahead and the lane's own last samples stay in registers; a symbol's 8
state-table entries are looked up together; stream bytes are read 16 at a
time; a block holds one lane up to 8 blocks a SM and the fewest lanes
(a power of two) that keep 8 a SM past that: a warp runs the union of its
lanes' decisions, yet at 2,048 lanes 2 lanes a block ran faster.  The
kernel is templated on C in {1, 2, 3, 4}; any other C launches its generic
instantiation.  ``decode.instances`` counts launches by instantiation.  The
source note in ``csrc/decode_kernel.cu`` has the details and what is left.

Output planes are symbol-major ``[n_sym, S]`` int32 post-RCT values (the
caller applies ``transform.rct_inverse``), and ``err [S]`` int32 is the
sticky per-lane corruption flag.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..coder import Decoder, wrap32
from ..core import tables
from ..core.config import REV2
from . import build
from .encode_fused import _model_start, _table, _upload

_NS = REV2.num_states
_P = ctypes.c_void_p
_I = ctypes.c_int
_ZF, _EXP, _MANT, _SIGN, _DONE = 0, 1, 2, 3, 4


def decode_plain(data: torch.Tensor, lens: torch.Tensor, H: int, W: int,
                 C: int, init) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, vectorised over lanes, with
    Python loops over symbols and decisions (the JAX kernels' 24-step phase
    machine).  -> (planes [n_sym, S] int32, err [S] int32)."""
    S = data.shape[0]
    dev = data.device
    n_sym = H * W * C
    stride = W * C
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    q11 = torch.from_numpy(tables.QUANT11.astype(np.int64)).to(dev)
    q5 = torch.from_numpy(tables.QUANT5.astype(np.int64)).to(dev)
    model = _model_start(init, S, dev)
    dec = Decoder(data, lens)
    planes = torch.zeros((n_sym, S), dtype=torch.int64, device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    full = torch.full((S,), 128, dtype=torch.int64, device=dev)

    def quant(tab, x):
        return tab[x.clamp(-128, 127) & 0xFF]

    for s in range(n_sym):
        y, x = divmod(s // C, W)
        up_x = planes[s - stride] if y > 0 else None
        l = planes[s - C] if x > 0 else (up_x if y > 0 else full)
        t = up_x if y > 0 else l
        L = planes[s - 2 * C] if x > 1 else l
        tl = planes[s - stride - C] if y > 0 and x > 0 else t
        tr = planes[s - stride + C] if y > 0 and x < W - 1 else t
        T = planes[s - 2 * stride] if y > 1 else t
        hsh = (quant(q11, wrap32(l - tl)) + quant(q11, wrap32(tl - t)) * 11
               + quant(q11, wrap32(t - tr)) * 121
               + quant(q5, wrap32(L - l)) * 605
               + quant(q5, wrap32(T - t)) * 3025)
        grad = wrap32(l + t - tl)
        predict = torch.maximum(torch.minimum(l, t),
                                torch.minimum(torch.maximum(l, t), grad))
        neg = hsh < 0
        base = torch.where(neg, -hsh, hsh) * 8

        phase = torch.full((S,), _ZF, dtype=torch.int64, device=dev)
        value = torch.zeros_like(phase)
        e = torch.zeros_like(phase)
        mrem = torch.zeros_like(phase)
        for _ in range(REV2.max_bins_per_symbol):
            act = phase != _DONE
            if not bool(act.any()):
                break
            ctx = torch.where(phase == _EXP, (e + 1).clamp(max=4), 0)
            ctx = torch.where(phase == _MANT, (5 + e - mrem).clamp(max=6), ctx)
            ctx = torch.where(phase == _SIGN, 7, ctx)
            idx = (base + ctx)[:, None]
            st = model.gather(1, idx)[:, 0].to(torch.int64)
            f = fused[st]
            bit = dec.get(f & 0xFF, act)
            ns = torch.where(bit, f >> 16, f >> 8) & 0xFF
            model.scatter_(1, idx, torch.where(act, ns, st)
                           .to(torch.uint8)[:, None])
            b = bit.to(torch.int64)
            is_zf = act & (phase == _ZF)
            is_exp = act & (phase == _EXP)
            is_mant = act & (phase == _MANT)
            is_sign = act & (phase == _SIGN)
            value = torch.where(is_zf, 1 - b, value)
            value = torch.where(is_mant, 2 * value + b, value)
            value = torch.where(is_sign & bit, -value, value)
            e2 = torch.where(is_exp & bit, e + 1, e)
            err |= is_exp & (e2 > 31)
            last_mant = is_mant & (mrem == 1)
            mrem = torch.where(is_exp & ~bit, e2,
                               torch.where(is_mant, mrem - 1, mrem))
            nphase = torch.where(is_zf, torch.where(bit, _DONE, _EXP), phase)
            nphase = torch.where(is_exp & ~bit,
                                 torch.where(e2 > 0, _MANT, _SIGN), nphase)
            nphase = torch.where(last_mant, _SIGN, nphase)
            phase = torch.where(is_sign, _DONE, nphase)
            e = e2
        err |= phase != _DONE
        planes[s] = wrap32(predict + torch.where(neg, -value, value))
    return planes.to(torch.int32), err.to(torch.int32)


def instance(C: int) -> str:
    """The kernel instantiation that decodes ``C`` channels."""
    return f"C{C}" if C <= 4 else "generic"


def decode(data: torch.Tensor, lens: torch.Tensor, H: int, W: int, C: int,
           init) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode ``S`` lanes of ``H x W x C`` samples from zero-padded stream
    bytes ``data`` [S, cap] u8 with lengths ``lens`` [S] int32 ->
    (planes [n_sym, S] int32, err [S] int32).  Bytes at or past
    ``min(len, cap)`` read as 0.

    CUDA tensors launch the kernel on their device, made current for the
    launch, with the constant tables kept on the card and the start table
    through pinned memory (no host wait), counted
    in ``decode.launches`` and, by instantiation, in ``decode.instances``;
    CPU tensors run ``decode_plain``.
    """
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"data must be [S, cap] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    S, cap = data.shape
    if lens.shape != (S,) or lens.dtype != torch.int32:
        raise ValueError("lens must be [S] int32")
    if not data.is_cuda:
        return decode_plain(data, lens, H, W, C, init)
    if C < 1:
        raise ValueError(f"C must be at least 1, got {C}")
    data = data.contiguous()
    lens = lens.contiguous()
    dev = data.device
    fn = build.load("decode_kernel", "llct_decode", [_P] * 9 + [_I] * 5 + [_P])
    with torch.cuda.device(dev):      # the launch runs on the current device
        if cap % 16 or data.data_ptr() % 16:  # rows of aligned 16-byte words
            wide = torch.zeros((S, -(-cap // 16) * 16), dtype=torch.uint8,
                               device=dev)
            wide[:, :cap] = data
            lens, data, cap = lens.clamp(max=cap), wide, wide.shape[1]
        tabs = [_table(t, dev) for t in ("FUSED", "QUANT11", "QUANT5")]
        init_t = (None if init is None else
                  _upload(tables.pack_u64(init), dev))
        model = torch.empty((S, _NS), dtype=torch.uint8, device=dev)
        planes = torch.empty((H * W * C, S), dtype=torch.int32, device=dev)
        err = torch.empty(S, dtype=torch.int32, device=dev)
        rc = fn(data.data_ptr(), lens.data_ptr(),
                *(t.data_ptr() for t in tabs),
                None if init_t is None else init_t.data_ptr(),
                model.data_ptr(), planes.data_ptr(), err.data_ptr(), S, cap,
                H, W, C, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode")
    decode.launches += 1
    decode.instances[instance(C)] += 1
    return planes, err


decode.launches = 0
decode.instances = dict.fromkeys(["C1", "C2", "C3", "C4", "generic"], 0)
