"""Kernels 3 and 6's chunk partition on the CPU.

The walks' plain versions cut each lane at its context runs into chunks
(``encode_kernels.chunk_bounds``), as the kernels do, and walk the chunks
at once.  Here they run against the JAX package's Pallas kernels (interpret
mode, one 1,024-lane group), which walk every lane whole, on synthetic seg
patterns (``chip_smoke.seg_cases``) at several chunk counts, T + 1 among
them (T smaller than the count).  Exact equality.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seg_cases, walk_pieces, walk_probs_xs, walk_symbols_xs
from llcomp_tpu.pallas import encode_kernels as pk
from llcomp_tpu_torch.core import tables
from llcomp_tpu_torch.kernels import encode_kernels as ek

S = pk.GROUP                   # one lane group of the JAX kernels
T_PROBS, N_SYMS, K = 1024, 512, 20
CHUNKS = [1, 2, 7, 32, "T + 1"]
PATTERNS = list(seg_cases(32, 4))


def _chunks(c, T: int) -> int:
    return T + 1 if c == "T + 1" else c


def _jax_lane_major(a: np.ndarray) -> jnp.ndarray:
    """The port's lane-minor [T, S] -> the JAX kernels' [1, T, 8, 128]."""
    return pk.to_groups(jnp.asarray(np.ascontiguousarray(a.T)))


def _minor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(pk.from_groups(a)).T))


@pytest.fixture(scope="module")
def probs_cases():
    """pattern -> (xs [T, S], the JAX kernel's probs)."""
    out = {}
    for name, seg in seg_cases(T_PROBS, S).items():
        xs = walk_probs_xs(seg)
        out[name] = (torch.from_numpy(xs),
                     _minor(pk.walk_probs(_jax_lane_major(xs))))
    return out


@pytest.fixture(scope="module")
def symbol_cases():
    """pattern -> (xs [n, S], reset table, the JAX kernel's lo and hi):
    primed reset rows, and a stored seed on every other pattern."""
    seed = (np.arange(121 * 8).reshape(121, 8) * 37 % 128).astype(np.uint8)
    out = {}
    for i, (name, seg) in enumerate(seg_cases(N_SYMS, S).items()):
        xs = walk_symbols_xs(seg)
        init = seed if i % 2 else tables.PRIOR_TAB
        lo, hi = pk.walk_symbols(_jax_lane_major(xs), K, True,
                                 seed if i % 2 else None)
        out[name] = (torch.from_numpy(xs), init, _minor(lo), _minor(hi))
    return out


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_walk_probs_plain_equals_jax_at_chunk_counts(probs_cases, pattern,
                                                     chunks):
    xs, want = probs_cases[pattern]
    got = ek.walk_probs_plain(xs, chunks=_chunks(chunks, T_PROBS))
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_walk_symbols_plain_equals_jax_at_chunk_counts(symbol_cases, pattern,
                                                       chunks):
    xs, init, lo_j, hi_j = symbol_cases[pattern]
    lo, hi = ek.walk_symbols_plain(xs, K, init,
                                   chunks=_chunks(chunks, N_SYMS))
    assert torch.equal(lo, lo_j) and torch.equal(hi, hi_j)


def test_symbol_cases_hold_dead_symbols_and_cut_decisions(symbol_cases):
    """The kernel 3 inputs exercise what they are for: dead symbols (all
    their quads 0) and symbols of more than K decisions (cut at K)."""
    xs, _, lo, hi = symbol_cases["random runs, one-run tail"]
    x = xs.to(torch.int64)
    dead = ((x >> 13) & 1) == 0
    ad = ((x & 0xFFF) - 1274).abs()
    assert dead.any() and (~dead & (ad >= 512)).any()   # 2e + 3 >= 21
    quads = torch.stack([lo, hi]).reshape(2, N_SYMS, K // 4, S)
    assert (quads.permute(1, 3, 0, 2)[dead] == 0).all()
    last = (quads[1, :, -1] >> 19) & 1                   # record K - 1
    assert bool(last[~dead & (ad >= 512)].all())


@pytest.mark.parametrize("chunks", [1, 7, 64])
def test_chunk_bounds_partition_every_lane(chunks):
    """Each entry is walked by exactly one chunk: chunk c starts at the
    first seg at or after c*L (chunk 0 at 0) and ends where chunk c + 1
    starts (the last at T)."""
    for T in (1, 63, 64, 65, 300):
        for name, seg in seg_cases(T, 9).items():
            seg_t = torch.from_numpy(np.ascontiguousarray(seg))
            start, end = ek.chunk_bounds(seg_t, chunks)
            assert (start[0] == 0).all() and (end[-1] == T).all()
            assert torch.equal(end[:-1], start[1:])
            assert (start <= end).all(), (T, name)
            L = -(-T // chunks)
            for c in range(1, chunks):
                for s in range(9):
                    after = np.flatnonzero(seg[c * L:, s]) + c * L
                    want = after[0] if len(after) else T
                    assert int(start[c, s]) == min(want, T), (T, name, c)
            piece, walk = walk_pieces(seg_t, chunks)
            assert walk <= L + piece


def test_build_reads_the_walks_compile_time_shape():
    """The plain versions' default chunk count comes from the kernels'
    sources (``build.constant``); a name a source lacks raises."""
    from llcomp_tpu_torch.kernels import build

    for name in ("walk_probs", "walk_symbols"):
        assert all(build.constant(name, c) >= 1
                   for c in ("kChunks", "kWarps", "kDepth"))
    with pytest.raises(build.KernelCompileError):
        build.constant("walk_probs", "kNoSuchConstant")
