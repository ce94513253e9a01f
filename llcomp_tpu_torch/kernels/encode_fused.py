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
``init[h % 121]``; a table needs 8 substates.

``cfg`` is the codec configuration (``core.config``): the plain version
reads its contexts (``transform.binarize``) and its model of
``cfg.num_states`` bytes, and the kernel is built once a cfg
(``config.defines``, ``csrc/codec_cfg.cuh``) and counted by build in
``encode_fused.by_cfg``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..coder import Encoder
from ..core import config, tables, transform
from ..core.config import REV2, CodecConfig
from . import build

_BLOCK = 64        # symbols whose decisions the plain version lays out at once
_P = ctypes.c_void_p
_I = ctypes.c_int


def model_bytes(cfg: CodecConfig = REV2) -> int:
    """Device bytes of one lane's model in kernels 1 and 2."""
    return 8 * config.model_words(cfg)


def _model_start(init, S: int, device, cfg: CodecConfig = REV2
                 ) -> torch.Tensor:
    """[S, cfg.num_states] u8 model: zeros or ``init[h % 121]`` per context
    row (8 substates)."""
    if init is None:
        return torch.zeros((S, cfg.num_states), dtype=torch.uint8,
                           device=device)
    full = tables.prior_full_from(np.asarray(init), cfg.num_states,
                                  cfg.substates)
    return torch.from_numpy(full).to(device)[None].repeat(S, 1)


def _symbol_fields(x: torch.Tensor):
    """Packed words -> (live, hash, diff, |diff|, exponent e)."""
    live = ((x >> 25) & 1).to(torch.bool)
    h = (x >> 12) & 0x1FFF
    d = (x & 0xFFF) - 1274
    ad = d.abs()
    return live, h, d, ad, transform.ilog2(ad.clamp(min=1), max_bits=12)


def encode_fused_plain(xs: torch.Tensor, init, outcap: int,
                       cfg: CodecConfig = REV2):
    """The kernel's function in plain torch, vectorised over lanes, with
    Python loops over symbols and decisions (each symbol's decisions laid
    out at once by ``transform.binarize``).  -> (out [S, outcap] u8, lens
    [S] int32, ovf [S] bool): a lane's bytes past ``outcap`` are not
    written, its length counts them and its flag is set."""
    n_sym, S = xs.shape
    dev = xs.device
    live, h, d, ad, e = _symbol_fields(xs.to(torch.int64))
    nbins = torch.where(ad != 0, 2 * e + 3, 1) * live
    steps = nbins.amax(dim=1).tolist() if S else [0] * n_sym
    fused = torch.from_numpy(tables.FUSED.astype(np.int64)).to(dev)
    model = _model_start(init, S, dev, cfg).to(torch.int64)
    enc = Encoder(S, outcap, dev)
    for i in range(n_sym):
        if i % _BLOCK == 0:      # the next block's decisions, [K, S] each
            blk = slice(i, i + _BLOCK)
            ctx, bit, valid = (t.view(-1, S, t.shape[1]).transpose(1, 2)
                               for t in transform.binarize(d[blk], cfg))
            idx_b = (h[blk, None] * cfg.substates + ctx).unsqueeze(3)
            one_b, valid_b = bit == 1, valid & live[blk, None]
        if not steps[i]:
            continue
        idx = idx_b[i % _BLOCK].unbind(0)
        one = one_b[i % _BLOCK].unbind(0)
        valid = valid_b[i % _BLOCK].unbind(0)
        for k in range(steps[i]):
            st = model.gather(1, idx[k])
            f = fused[st[:, 0]]
            ns = torch.where(one[k], f >> 16, f >> 8) & 0xFF
            model.scatter_(1, idx[k], torch.where(valid[k], ns, st[:, 0])
                           .unsqueeze(1))
            enc.put(one[k], f & 0xFF, valid[k])
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


def encode_fused_async(xs: torch.Tensor, init, outcap: int,
                       cfg: CodecConfig = REV2):
    """``encode_fused`` without its check of the rows: -> (bytes [S,
    outcap] u8, lengths [S] int32, flags [S]).  A lane whose stream passes
    its ``outcap``-byte row has its flag set and its full length counted;
    its bytes past the row are not written.  On CUDA nothing waits for the
    kernel: it runs on the current stream (``encode_lanes_pipelined``
    overlaps batches this way) and the caller reads the flags once it has
    synced.  The kernel launches on ``xs``'s device, made current for the
    launch.  Counts the launch in ``encode_fused.launches`` and in
    ``encode_fused.by_cfg`` under the build's defines.  A cfg whose build
    fails raises ``build.KernelCompileError``."""
    if xs.dim() != 2 or xs.dtype != torch.int32:
        raise ValueError(f"xs must be [n_sym, S] int32, got {tuple(xs.shape)} "
                         f"{xs.dtype}")
    config.check(cfg)
    config.check_start(cfg, init is not None)
    n_sym, S = xs.shape
    if not xs.is_cuda:
        return encode_fused_plain(xs, init, outcap, cfg)
    if outcap % 4:
        raise ValueError(f"outcap must be a multiple of 4, got {outcap}")
    xs = xs.contiguous()
    dev = xs.device
    defines = config.defines(cfg)
    fn = build.load("encode_fused", "llct_encode_fused",
                    [_P] * 7 + [_I] * 3 + [_P], defines)
    with torch.cuda.device(dev):      # the launch runs on the current device
        fused = _table("FUSED", dev)
        init_t = None if init is None else _upload(tables.pack_u64(init), dev)
        model = torch.empty((S, model_bytes(cfg)), dtype=torch.uint8,
                            device=dev)
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
    encode_fused.by_cfg[defines] = encode_fused.by_cfg.get(defines, 0) + 1
    return out, lens, ovf


def encode_fused(xs: torch.Tensor, init, outcap: int,
                 cfg: CodecConfig = REV2
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode ``S`` lanes: ``xs`` [n_sym, S] int32 -> (bytes [S, outcap] u8,
    lengths [S] int32).

    A CUDA ``xs`` launches the kernel (``outcap`` a multiple of 4: it stores
    32-bit words) and counts the launch in ``encode_fused.launches``; a CPU
    ``xs`` runs ``encode_fused_plain``.  Raises RuntimeError if a lane's
    stream passes its ``outcap``-byte row: ``outcap`` is a buffer, not a
    bound, and the lane loops (``encode``) code such lanes again at their
    counted length.
    """
    out, lens, ovf = encode_fused_async(xs, init, outcap, cfg)
    if bool(ovf.any()):
        raise RuntimeError(f"a stream overflowed its row of outcap={outcap} "
                           "bytes")
    return out, lens


encode_fused.launches = 0
encode_fused.by_cfg = {}      # config.defines(cfg) -> launches of that build
