"""NumPy bindings to the native host runtime (``native/llcomp_host.cpp``).

Port of ``llcomp_tpu/host.py``: headerless rev-2 streams, one a thread on
the CPU, the same bytes as the device engines.  ``api`` applies the
containers.  This is ``backend="native"``: no kernel runs here.

An encode writes into a buffer of ``llct_out_cap`` bytes (raw * 1.5 + 64),
which most streams fit.  The runtime counts a stream past its buffer and
returns the length it needed; such a stream is encoded again into a buffer
of that length.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .core import tables
from .native import load_library

# The hash-bucketed prior rows of primed containers (flag bit 0): the
# runtime takes the table by pointer, so the format data lives only in
# core/tables.py.
_PRIOR = np.ascontiguousarray(tables.PRIOR_TAB, dtype=np.uint8)


def _prior_tab(primed: bool, seed=None):
    """The [121, 8] start table of this call: the stored seed (flag bit 1),
    the static prior (flag bit 0) or None (zeros).  Callers hold the array
    while the runtime reads its pointer."""
    if seed is not None:
        return np.ascontiguousarray(seed, dtype=np.uint8)
    return _PRIOR if primed else None


def _ptr(tab):
    return tab.ctypes.data if tab is not None else None


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else (os.cpu_count() or 1)


def encode_stream(img: np.ndarray, primed: bool = False,
                  seed=None) -> bytes:
    """uint8 [H, W, C] -> headerless rev-2 stream."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W, C = img.shape
    lib = load_library()
    tab = _prior_tab(primed, seed)

    def run(cap: int) -> tuple[np.ndarray, int]:
        out = np.empty(cap, dtype=np.uint8)
        return out, lib.llct_encode_stream(img.ctypes.data, W, H, C,
                                           out.ctypes.data, cap, _ptr(tab))

    out, n = run(lib.llct_out_cap(W, H, C))
    if n > out.size:                  # past the buffer: again at its length
        out, n = run(n)
    if n == 0 or n > out.size:
        raise ValueError(f"native encode failed for shape {img.shape}")
    return out[:n].tobytes()


def decode_stream(data: bytes, shape: tuple[int, int, int],
                  primed: bool = False, seed=None) -> np.ndarray:
    """Headerless rev-2 stream -> uint8 [H, W, C]; ValueError if corrupt."""
    H, W, C = shape
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((H, W, C), dtype=np.uint8)
    tab = _prior_tab(primed, seed)
    rc = load_library().llct_decode_stream(
        buf.ctypes.data if buf.size else None, buf.size, W, H, C,
        out.ctypes.data, _ptr(tab))
    if rc != 0:
        raise ValueError("corrupt stream (native decoder)")
    return out


def decode_streams(streams: list[bytes], shape: tuple[int, int, int],
                   n_threads: int = 0, primed: bool = False,
                   seed=None) -> np.ndarray:
    """Equal-geometry streams -> [S, H, W, C], one stream a worker thread
    (``n_threads`` 0: one a CPU).  ValueError if any stream is corrupt."""
    H, W, C = shape
    S = len(streams)
    bufs = [np.frombuffer(s, dtype=np.uint8) for s in streams]
    out = np.empty((S, H, W, C), dtype=np.uint8)
    datas = (ctypes.c_void_p * S)(*[b.ctypes.data if b.size else None
                                    for b in bufs])
    lens = (ctypes.c_size_t * S)(*[b.size for b in bufs])
    outs = (ctypes.c_void_p * S)(*[out[s].ctypes.data for s in range(S)])
    tab = _prior_tab(primed, seed)
    failures = load_library().llct_decode_batch(
        datas, lens, S, W, H, C, outs, _threads(n_threads), _ptr(tab))
    if failures:
        raise ValueError(f"corrupt stream(s): {failures} of {S} failed")
    return out


def _encode_batch(imgs: np.ndarray, cap: int, n_threads: int, tab
                  ) -> tuple[np.ndarray, np.ndarray]:
    """One ``llct_encode_batch`` into buffers of ``cap`` bytes -> (buffers
    [S, cap] u8, each stream's length [S], above ``cap`` where it did not
    fit)."""
    S, H, W, C = imgs.shape
    bufs = np.empty((S, cap), dtype=np.uint8)
    srcs = (ctypes.c_void_p * S)(*[imgs[s].ctypes.data for s in range(S)])
    outs = (ctypes.c_void_p * S)(*[bufs[s].ctypes.data for s in range(S)])
    out_lens = (ctypes.c_size_t * S)()
    load_library().llct_encode_batch(srcs, S, W, H, C, outs, cap, out_lens,
                                     _threads(n_threads), _ptr(tab))
    return bufs, np.array(out_lens, dtype=np.int64)


def encode_images(imgs: np.ndarray, n_threads: int = 0,
                  primed: bool = False, seed=None) -> list[bytes]:
    """Equal-shaped images [S, H, W, C] -> one stream each, one image a
    worker thread.  Streams that pass the common buffer are encoded again,
    together, into buffers of the longest one's length."""
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    S, H, W, C = imgs.shape
    tab = _prior_tab(primed, seed)
    cap = load_library().llct_out_cap(W, H, C)
    bufs, lens = _encode_batch(imgs, cap, n_threads, tab)
    streams = [bufs[s, : lens[s]].tobytes() for s in range(S)]
    redo = np.flatnonzero(lens > cap)
    if redo.size:
        bufs, again = _encode_batch(imgs[redo], int(lens[redo].max()),
                                    n_threads, tab)
        if not np.array_equal(again, lens[redo]):
            raise ValueError("native batch encode failed")
        for k, s in enumerate(redo):
            streams[s] = bufs[k, : again[k]].tobytes()
    if not lens.all():
        raise ValueError("native batch encode failed")
    return streams


def expand_slots(meta: np.ndarray, runs: np.ndarray) -> bytes:
    """Slot records (``emit | carry<<1 | head<<8`` and run lengths) -> the
    byte stream; the native twin of ``coder.expand_slots``."""
    meta = np.ascontiguousarray(meta, dtype=np.int32)
    runs = np.ascontiguousarray(runs, dtype=np.int32)
    cap = int(meta.size + runs[meta & 1 == 1].sum()) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = load_library().llct_expand_slots(meta.ctypes.data, runs.ctypes.data,
                                         meta.size, out.ctypes.data, cap)
    return out[:n].tobytes()
