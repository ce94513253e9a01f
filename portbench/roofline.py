"""The yardstick of the kernels' rooflines, frozen.

A copy of the arithmetic of the repository's ``chip_smoke.py`` (``bound``,
``HBM_BYTES_PER_S``, ``INT_OPS_PER_S``, the ``OPS_*`` counts and the bytes
and operations of kernels 1 and 2 in its phase 5), kept here so that a
change to the program cannot move it.  The decisions are counted from the
benchmark's own reference (``reference.decisions``), so they read the same
work whatever codes it.
"""
from __future__ import annotations

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once)
# over the H100 SXM's 3.35 TB/s, and its 32-bit integer operations over
# the card's int32 rate: 64 results a clock an SM (the CUDA C++
# Programming Guide's arithmetic throughput table, compute capability 9.0:
# add, multiply, shift, logic, compare) x 132 SMs x the SXM part's 1,980
# MHz boost clock = 16.7 T/s.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations a step, estimated from the kernels' loop bodies as
# floors (no count of the compiled instructions backs them): binarising
# a decision (its context and bit), the model state's update (byte out,
# state table, byte in), the coder's put (range split, select, compare), a
# record's packing; a symbol's unpacking and model-row access in encode,
# its neighbours, hash and prediction in decode.
OPS_DECISION, OPS_STATE, OPS_CODER, OPS_RECORD = 6, 6, 8, 4
OPS_SYMBOL_ENC, OPS_SYMBOL_DEC = 10, 40


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and bound_by of a kernel that must move ``n_bytes`` and do
    ``n_ops`` integer operations on this card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


def encode_bound(lanes: int, symbols: int, n_dec: int,
                 stream_bytes: int) -> dict:
    """Kernel 1 (``encode_fused``): packed int32 symbols in, the streams'
    bytes and a length a lane out."""
    return bound(4 * symbols + stream_bytes + 4 * lanes,
                 n_dec * (OPS_DECISION + OPS_STATE + OPS_CODER)
                 + symbols * OPS_SYMBOL_ENC)


def decode_bound(lanes: int, symbols: int, n_dec: int,
                 stream_bytes: int) -> dict:
    """Kernel 2 (``decode_kernel``): the streams' bytes and a length a
    lane in, int32 planes and a flag a lane out."""
    return bound(stream_bytes + 4 * lanes + 4 * symbols + 4 * lanes,
                 n_dec * (OPS_DECISION + OPS_STATE + OPS_CODER)
                 + symbols * OPS_SYMBOL_DEC)
