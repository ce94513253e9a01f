"""The sort-chain encode engine (``encode_lanes(engine="sort")``) on the CPU.

Each stage, and kernels 3 and 4 through their plain versions, against the
JAX package's sort chain on the same inputs: its Pallas kernels in interpret
mode on 1,024-lane padded groups, mapped to the port's layouts with
``from_groups``.  The engine against the JAX engine (``engine="pallas"``),
the port's fused engine and the oracle.  Exact equality throughout.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from llcomp_tpu import encode as jenc
from llcomp_tpu import oracle
from llcomp_tpu import seed as jseed
from llcomp_tpu.core import tables as jtables
from llcomp_tpu.pallas import encode_kernels as pk
from llcomp_tpu_torch import coder, decode, encode
from llcomp_tpu_torch.core import tables
from chip_smoke import CODERS, SPLIT_SHIPPED, coder_cases, coder_depth
from llcomp_tpu_torch.kernels import encode_kernels as ek
from tests.conftest import make_noise, make_photo

MODES = ("unprimed", "primed", "seeded")
K_CHAIN = 24      # the stage tests' K: covers every symbol with a spare quad


def _mixed_lanes():
    return np.stack([make_photo(4, 8, seed=i) for i in range(2)]
                    + [np.full((4, 8, 3), 42, np.uint8), make_noise(4, 8)])


def _minor(a, S: int) -> torch.Tensor:
    """JAX [G, T, 8, 128] -> the port's lane-minor [T, S]."""
    return torch.from_numpy(np.array(np.asarray(pk.from_groups(a))[:S].T))


def _major(a, S: int) -> torch.Tensor:
    """JAX [G, T, 8, 128] -> the port's lane-major [S, T]."""
    return torch.from_numpy(np.array(np.asarray(pk.from_groups(a))[:S]))


def _kw(mode: str, stored_seed) -> dict:
    return {"primed": mode == "primed",
            "seed": stored_seed if mode == "seeded" else None}


def _jax_walk(xs_g, K: int, mode: str, stored_seed):
    kw = _kw(mode, stored_seed)
    return pk.walk_symbols(xs_g, K, mode != "unprimed", kw["seed"])


@pytest.fixture(scope="module")
def stored_seed():
    return jseed.derive(make_photo(16, 8, seed=21))


@pytest.fixture(scope="module")
def chain(stored_seed):
    """The JAX sort chain on the mixed lanes, stage by stage, per mode."""
    lanes = _mixed_lanes()
    n_sym = int(np.prod(lanes.shape[1:]))
    _, h_g, d_g, counts, _ = jenc._launch_stage_counts(lanes)
    xs_g, orig_g = jenc._stage_sym_sort(h_g, d_g, n_sym)
    quad_max = int(counts[2])
    Tq = min(h_g.shape[1] * K_CHAIN,
             jenc._bucket(quad_max, quantum=2048) * 4) // 4
    out = {"S": len(lanes), "n_sym": n_sym, "h": h_g, "d": d_g,
           "counts": tuple(int(c) for c in counts), "xs": xs_g,
           "orig": orig_g, "Tq": Tq}
    for mode in MODES:
        lo, hi = _jax_walk(xs_g, K_CHAIN, mode, stored_seed)
        qlo, qhi = jenc._stage_compact(lo, hi, orig_g, K_CHAIN, Tq)
        kp, fin = pk.coder_scan_off_q(qlo, qhi)
        kp_fin, lens = jenc._stage_finish(fin)
        cap = jenc._outcap(n_sym)
        out[mode] = {"lo": lo, "hi": hi, "qlo": qlo, "qhi": qhi, "kp": kp,
                     "fin": fin, "kp_fin": kp_fin, "lens": lens, "cap": cap,
                     "bytes": jenc._stage_expand_only(kp, kp_fin, cap)}
    return out


def test_stage_count_equals_jax(chain):
    """On JAX's padded residuals (symbol and lane padding count one
    decision each, as there)."""
    d = _major(chain["d"], pk.GROUP)
    assert encode.stage_count(d) == chain["counts"]
    assert chain["counts"][1] == 19
    assert encode.slots_per_symbol(19) == 20
    assert [encode.slots_per_symbol(m) for m in (1, 4, 5, 23, 30)] == \
        [4, 4, 8, 24, 24]


@pytest.mark.parametrize("shape", [(4, 8, 3), (3, 5, 1), (2, 6, 4)])
def test_stage_sym_sort_equals_jax(shape):
    """On JAX's padded arrays: dead padding symbols sort last."""
    lanes = np.stack([make_photo(*shape, seed=5), make_noise(*shape, seed=6),
                      np.full(shape, 9, np.uint8)])
    S, n_sym = len(lanes), int(np.prod(shape))
    _, h_g, d_g, _, _ = jenc._launch_stage_counts(lanes)
    xs_g, orig_g = jenc._stage_sym_sort(h_g, d_g, n_sym)
    xs, origsym = encode.stage_sym_sort(_major(h_g, S), _major(d_g, S), n_sym)
    assert h_g.shape[1] > n_sym
    assert torch.equal(xs, _minor(xs_g, S))
    assert torch.equal(origsym, _major(orig_g, S))


@pytest.mark.parametrize("K", [4, 8, 24])
@pytest.mark.parametrize("mode", MODES)
def test_walk_plain_equals_jax(chain, K, mode, stored_seed):
    """K 4 and 8 cut this batch's symbols short (up to 19 decisions)."""
    S = chain["S"]
    lo_j, hi_j = ((chain[mode]["lo"], chain[mode]["hi"]) if K == K_CHAIN
                  else _jax_walk(chain["xs"], K, mode, stored_seed))
    init = encode._start_table(**_kw(mode, stored_seed))
    lo, hi = ek.walk_symbols(_minor(chain["xs"], S), K, init)
    assert torch.equal(lo, _minor(lo_j, S))
    assert torch.equal(hi, _minor(hi_j, S))


@pytest.mark.parametrize("mode", MODES)
def test_stage_compact_equals_jax(chain, mode):
    S, st = chain["S"], chain[mode]
    qlo, qhi = encode.stage_compact(_minor(st["lo"], S), _minor(st["hi"], S),
                                    _major(chain["orig"], S), K_CHAIN,
                                    chain["Tq"])
    assert torch.equal(qlo, _minor(st["qlo"], S))
    assert torch.equal(qhi, _minor(st["qhi"], S))


@pytest.mark.parametrize("mode", MODES)
def test_coder_plain_equals_jax(chain, mode):
    S, st = chain["S"], chain[mode]
    kp, fin = ek.coder_scan_off_q(_minor(st["qlo"], S), _minor(st["qhi"], S))
    assert torch.equal(kp, _minor(st["kp"], S))
    assert torch.equal(fin, _minor(st["fin"], S))


def _records(qlo_g: np.ndarray, qhi_g: np.ndarray) -> np.ndarray:
    """JAX quads [1, Tq, 8, 128] -> their records [1, 4 * Tq, 8, 128] in
    stream order."""
    rec = np.stack([qlo_g & 0x3FF, qlo_g >> 10, qhi_g & 0x3FF, qhi_g >> 10],
                   axis=2)
    return rec.reshape(1, -1, *qlo_g.shape[2:])


@pytest.mark.parametrize("case", ["skewed", "0xFF runs",
                                  "Tq off the quad depth", "dead lanes"])
def test_coder_plain_equals_jax_on_skewed_records(case):
    """Random records, bits P(1) = 0.97 on half the lanes: long deferred
    runs and carries.  The other cases: P(1) = 0.99 on every lane with
    probabilities 7..63 (deferred runs of 0xFF bytes past a hundred); Tq =
    201 quads, off every multiple of the kernel's quad depths and
    hand-overs (JAX codes the same quads followed by dead ones); lanes all
    dead and a dead tail of a different length in every other lane, ending
    inside a quad (dead records in a live quad, dead quads 0)."""
    rng = np.random.default_rng(3)
    shape = (1, 256, 8, 128)
    p1 = np.where(np.arange(128) % 2 == 0, 0.97, 0.5)
    probs = (7, 248)
    if case == "0xFF runs":
        p1, probs = np.full(128, 0.99), (7, 64)

    def pair():
        recs = [(rng.random(shape) < 0.9).astype(np.int32) << 9
                | (rng.random(shape) < p1).astype(np.int32) << 8
                | rng.integers(*probs, shape, dtype=np.int32)
                for _ in range(2)]
        return recs[0] | recs[1] << 10

    qlo_g, qhi_g = pair(), pair()
    S, Tq = 48, 201 if case == "Tq off the quad depth" else 256
    qlo_g[:, Tq:] = qhi_g[:, Tq:] = 0
    if case == "dead lanes":          # port lane l is qlo_g[0, :, 0, l]
        rec = _records(qlo_g, qhi_g)
        rec[0, :, 0, :10] = 0
        for lane in range(10, S):
            rec[0, 1024 - (lane * 37) % 700:, 0, lane] = 0
        qlo_g = rec[:, 0::4] | rec[:, 1::4] << 10
        qhi_g = rec[:, 2::4] | rec[:, 3::4] << 10
    kp_g, fin_g = pk.coder_scan_off_q(qlo_g, qhi_g)
    qlo, qhi = _minor(qlo_g, S)[:Tq], _minor(qhi_g, S)[:Tq]
    kp, fin = ek.coder_scan_off_q(qlo, qhi)
    assert torch.equal(kp, _minor(kp_g, S)[:4 * Tq])
    assert torch.equal(fin, _minor(fin_g, S))
    carried = (kp != coder.KP_SILENT) & ((kp & 0x100) != 0)
    assert carried.any()
    if case == "0xFF runs":
        _, runs, _ = ek.coder_scan_plain(_minor(_records(qlo_g, qhi_g), S))
        assert (runs > 100).any()
    if case == "dead lanes":
        assert (kp[:, :10] == coder.KP_SILENT).all()
        assert torch.equal(fin[:, :10], torch.tensor(
            [[0], [0xFF00], [-1], [0], [0]], dtype=torch.int32).expand(5, 10))
        rec = torch.stack([qlo & 0x3FF, qlo >> 10, qhi & 0x3FF, qhi >> 10])
        assert ((rec == 0).any(0) & (rec != 0).any(0))[:, 10:].any()


@pytest.mark.parametrize("name", list(CODERS))
def test_build_reads_the_coders_ring_depths(name):
    """Kernel 7's ring depth and the split coders' (kernels 4 and 8)
    hand-over batch (kernel 4's in quads) and stages come from
    ``coder_scan.cu`` (``build.constant``), the split copies' shipped
    constants (``chip_smoke.SPLIT_SHIPPED``) are the source's, and each
    coder's ragged cases (``chip_smoke.coder_cases``, which the GPU run
    holds the kernels to) straddle them: rows below and above the rows in
    flight, rows off every multiple of them, rows either side of a
    hand-over and past the input's reuse."""
    from llcomp_tpu_torch.kernels import build

    per = CODERS[name][1]
    D = coder_depth(name)
    assert D == build.constant("coder_scan", CODERS[name][0]) // per >= 1
    rows = {args[0].shape[0] for args in coder_cases(name).values()}
    assert min(rows) < max(D, 2) and max(rows) > D
    assert any(T % D for T in rows) or D == 1
    if name != "coder_scan_off":
        assert SPLIT_SHIPPED == {c: build.constant("coder_scan", c)
                                 for c in SPLIT_SHIPPED}
        B = build.constant("coder_scan", "kBatch") // per
        stages = build.constant("coder_scan", "kInStages")
        assert B >= 2 and {B - 1, B + 1, stages * B + 1} <= rows
    for args in coder_cases(name).values():
        assert all(a.dtype == np.int32 and a.shape == args[0].shape
                   for a in args) and len(args) == (2 if per == 4 else 1)


@pytest.mark.parametrize("mode", MODES)
def test_finish_and_expansion_equal_jax(chain, mode):
    S, st = chain["S"], chain[mode]
    kp_fin, lens = coder.finish_steps_off(_minor(st["fin"], S))
    assert torch.equal(kp_fin, _minor(st["kp_fin"], S))
    assert torch.equal(lens, _minor(st["lens"], S)[0])
    got = coder.expand_kp(_minor(st["kp"], S), kp_fin, st["cap"])
    assert torch.equal(got, _major(st["bytes"], S))


@pytest.mark.parametrize("mode", MODES)
def test_engine_equals_jax_sort_chain(mode, stored_seed):
    lanes = _mixed_lanes()
    kw = _kw(mode, stored_seed)
    got = encode.encode_lanes(lanes, device="cpu", engine="sort", **kw)
    assert got == jenc.encode_lanes(lanes, engine="pallas", **kw)


@pytest.mark.parametrize("shape", [(1, 24, 3), (12, 1, 3), (3, 5, 4),
                                   (5, 6, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_engine_equals_fused_and_oracle(shape, mode, stored_seed):
    """1-row and 1-column stripes, RGBA and grayscale; photo, noise and
    flat lanes in one batch."""
    lanes = np.stack([make_photo(*shape, seed=3), make_noise(*shape, seed=4),
                      np.full(shape, 200, np.uint8)])
    kw = _kw(mode, stored_seed)
    got = encode.encode_lanes(lanes, device="cpu", engine="sort", **kw)
    assert got == encode.encode_lanes(lanes, device="cpu", **kw)
    for lane, stream in zip(lanes, got):
        assert stream == oracle.encode_planes(oracle.rct_forward(lane), **kw)
    out = decode.decode_lanes(got, shape, device="cpu", **kw)
    np.testing.assert_array_equal(out, lanes)


def test_lane_chunking_byte_identical(monkeypatch):
    lanes = np.stack([make_photo(2, 4, seed=600 + i) for i in range(5)])
    want = encode.encode_lanes(lanes, device="cpu", engine="sort")
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES", 1)  # one lane per chunk
    assert encode.encode_lanes(lanes, device="cpu", engine="sort") == want
    assert want[4] == oracle.encode(lanes[4])[6:]


def test_format_bounds_raise():
    """n_sym * 24 < 2^25 and outcap < 2^21; a stripe past either raises
    before any work, naming the bound."""
    encode.check_sort_bounds(1_397_376)          # the largest that fits
    with pytest.raises(ValueError, match=r"outcap < 2\^21"):
        encode.encode_lanes(np.zeros((1, 1, 465_793, 3), np.uint8),
                            device="cpu", engine="sort")
    with pytest.raises(ValueError, match=r"n_sym\*24 < 2\^25"):
        encode.encode_lanes(np.zeros((2, 1, 466_034, 3), np.uint8),
                            device="cpu", engine="sort")


def test_reset_rows_and_state_table_equal_jax_operands(stored_seed):
    """The walk's reset rows are the JAX walk's plo/phi operands (the prior
    rows PRIOR_LO121/HI121, or the seed packed the same way), and the fused
    state table holds its prob / next-state tables."""
    for init, (lo, hi) in (
            (tables.PRIOR_TAB, (jtables.PRIOR_LO121, jtables.PRIOR_HI121)),
            (stored_seed, (None, None))):
        rows = ek.reset_rows(init, "cpu").numpy()
        if lo is None:
            t = stored_seed.astype(np.int64)
            lo = t[:, 0] | t[:, 1] << 8 | t[:, 2] << 16 | t[:, 3] << 24
            hi = t[:, 4] | t[:, 5] << 8 | t[:, 6] << 16 | t[:, 7] << 24
        np.testing.assert_array_equal(rows[:121] & 0xFFFFFFFF,
                                      lo[:121].astype(np.int64) & 0xFFFFFFFF)
        np.testing.assert_array_equal(rows[:121] >> 32,
                                      hi[:121].astype(np.int64) & 0xFFFFFFFF)
        assert not rows[121:].any()
    assert not ek.reset_rows(None, "cpu").any()
    np.testing.assert_array_equal(tables.FUSED & 0xFF, pk._PROB_B[0])
    np.testing.assert_array_equal(tables.FUSED >> 8 & 0xFF, pk._NS0_B[0])
    np.testing.assert_array_equal(tables.FUSED >> 16, pk._NS1_B[0])


def test_seed_states_past_the_state_machine_raise():
    """A seed value above 127 names no state: both engines and the decoder
    reject it (the CUDA kernels would index past their 128-entry table)."""
    lanes = _mixed_lanes()[:1]
    bad = tables.PRIOR_TAB.copy()
    bad[5, 3] = 200
    for engine in encode.ENGINES:
        with pytest.raises(ValueError, match="above 127"):
            encode.encode_lanes(lanes, seed=bad, device="cpu", engine=engine)
    with pytest.raises(ValueError, match="above 127"):
        decode.decode_lanes([b"\0"], lanes.shape[1:], seed=bad, device="cpu")
    with pytest.raises(ValueError, match=r"\[121, 8\]"):
        encode.encode_lanes(lanes, seed=bad[:8], device="cpu")


def test_engine_and_device_are_checked(monkeypatch):
    lanes = _mixed_lanes()[:1]
    with pytest.raises(ValueError, match="engine"):
        encode.encode_lanes(lanes, device="cpu", engine="lockstep")
    with pytest.raises(ValueError, match="multiple of 4"):
        ek.walk_symbols(torch.zeros((2, 3), dtype=torch.int32), K=6)
    with pytest.raises(ValueError, match="int32"):
        ek.coder_scan_off_q(torch.zeros((2, 3)), torch.zeros((2, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode.encode_lanes(lanes, device="cuda", engine="sort")


def test_stage_hook_sees_every_stage_in_order():
    """``_encode_sort``'s hook gets each stage's outputs in order; they chain
    into one another and into the engine's bytes."""
    lanes = _mixed_lanes()
    seen = []
    out, lens = encode._encode_sort(
        torch.from_numpy(lanes), encode.REV2, tables.PRIOR_TAB,
        lambda stage, *o: seen.append((stage, o)))
    made = dict(seen)
    assert [s for s, _ in seen] == ["precompute and counts", "sym sort", "walk",
                                    "compact sort", "coder",
                                    "finish and expansion"]
    K, Tq = made["precompute and counts"]
    lo, hi = ek.walk_symbols_plain(made["sym sort"][0], K, tables.PRIOR_TAB)
    assert torch.equal(lo, made["walk"][0]) and torch.equal(hi, made["walk"][1])
    assert made["compact sort"][0].shape == (Tq, len(lanes))
    assert made["finish and expansion"][0] is out
    assert [out[s, : lens[s]].numpy().tobytes() for s in range(len(lanes))] \
        == encode.encode_lanes(lanes, primed=True, device="cpu", engine="sort")


def test_rev2_symbols_hold_at_most_19_decisions():
    """Channels at 0 or 255 give residuals of +-510 at most: 19 decisions,
    K = 20, below the MAX_SLOTS that ``lane_bytes`` sizes a lane by."""
    r = np.random.default_rng(5).integers(0, 2, (3, 6, 9, 3), dtype=np.uint8)
    h, diff = encode._hash_diff(torch.from_numpy(r * 255), encode.REV2)
    assert int(diff.abs().max()) == 510
    _, sym_max, _ = encode.stage_count(diff)
    assert sym_max == 19 and encode.slots_per_symbol(sym_max) == 20
    n = 12_288
    assert encode.lane_bytes(n, "sort") >= encode.SORT_SLOT_BYTES \
        * encode.slots_per_symbol(sym_max) * n
