"""The sort engine's decision variant (``encode_lanes(engine="sort",
variant="decision")``) and the slot-record coder on the CPU.

Each stage, and kernels 5-8 through their plain versions, against the JAX
package's decision chain (``LLCT_ENCODE_VARIANT=decision``) on the same
inputs: its Pallas kernels in interpret mode on 1,024-lane padded groups,
mapped to the port's layouts with ``from_groups``.  The engine against the
JAX engine, the port's symbol variant and fused engine, and the oracle.
Exact equality throughout.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EDGE_RESIDUALS
from llcomp_tpu import coder as jcoder
from llcomp_tpu import encode as jenc
from llcomp_tpu import oracle
from llcomp_tpu.pallas import encode_kernels as pk
from llcomp_tpu_torch import coder, decode, encode
from llcomp_tpu_torch.core import tables
from llcomp_tpu_torch.kernels import encode_kernels as ek
from tests.conftest import make_noise, make_photo
from tests.test_torch_sort_chain import _major, _minor, _mixed_lanes

STAGES = ["precompute and counts", "build", "fwd sort", "walk xs", "walk",
          "back sort", "coder", "finish and expansion"]


@pytest.fixture(scope="module")
def chain():
    """The JAX decision chain on the mixed lanes, stage by stage (as the
    else branch of ``_launch_stage_rest`` runs it)."""
    lanes = _mixed_lanes()
    n_sym = int(np.prod(lanes.shape[1:]))
    _, h_g, d_g, counts, _ = jenc._launch_stage_counts(lanes)
    total_max, sym_max, _ = (int(c) for c in counts)
    K = encode.decision_slots(sym_max)
    stream_g = pk.build_stream(h_g, d_g, n_sym, K)
    Tc = min(h_g.shape[1] * K, jenc._bucket(total_max, quantum=8192))
    skey_g, spay_g = jenc._stage_fwd_sort(stream_g)
    skey_g, spay_g = skey_g[:, :Tc], spay_g[:, :Tc]
    xs_g = jenc._stage_walk_xs(skey_g, spay_g)
    probs_g = pk.walk_probs(xs_g)
    cx_g = jenc._stage_back_sort(skey_g, spay_g, probs_g)
    kp_g, fin_g = pk.coder_scan_off(cx_g)
    meta_g, runs_g, fin4_g = pk.coder_scan(cx_g)
    kp_fin, lens = jenc._stage_finish(fin_g)
    cap = jenc._outcap(n_sym)
    return {"lanes": lanes, "S": len(lanes), "n_sym": n_sym, "h": h_g,
            "d": d_g, "counts": (total_max, sym_max), "K": K, "Tc": Tc,
            "stream": stream_g, "skey": skey_g, "spay": spay_g, "xs": xs_g,
            "probs": probs_g, "cx": cx_g, "kp": kp_g, "fin": fin_g,
            "meta": meta_g, "runs": runs_g, "fin4": fin4_g, "lens": lens,
            "cap": cap, "bytes": jenc._stage_expand_only(kp_g, kp_fin, cap)}


def test_decision_slots_equal_jax_buckets(chain):
    """K of the decision variant: 8, 16 or 24 (`encode.py:568`); the mixed
    batch's noise lane needs 24."""
    d = _major(chain["d"], pk.GROUP)
    total, sym_max, _ = encode.stage_count(d)
    assert (total, sym_max) == chain["counts"] and chain["K"] == 24
    assert [encode.decision_slots(m) for m in (1, 8, 9, 16, 17, 19)] == \
        [8, 8, 16, 16, 24, 24]


@pytest.mark.parametrize("K", [8, 16, 24])
def test_build_stream_plain_equals_jax(chain, K):
    """K 8 and 16 cut this batch's longest symbols (19 decisions) short;
    padding symbols past n_sym are -1."""
    S, n_sym = chain["S"], chain["n_sym"]
    want = chain["stream"] if K == chain["K"] else pk.build_stream(
        chain["h"], chain["d"], n_sym, K)
    got = ek.build_stream(_major(chain["h"], S), _major(chain["d"], S),
                          n_sym, K)
    assert torch.equal(got, _major(want, S))
    assert chain["counts"][1] > K or K == 24
    assert (got.reshape(S, -1, K)[:, n_sym:] == -1).all()


def test_build_stream_plain_equals_jax_on_random_symbols():
    """Every hash and residual at random, up to +-4095 (the exponent's
    11-bit clip), zeros among them, and padding past n_sym."""
    rng = np.random.default_rng(11)
    shape = (1, 64, 8, 128)
    h_g = rng.integers(0, 8000, shape, dtype=np.int32)
    d_g = rng.integers(-4095, 4096, shape, dtype=np.int32)
    d_g[:, ::5] = 0
    want = pk.build_stream(jnp.asarray(h_g), jnp.asarray(d_g), 50, 24)
    got = ek.build_stream(_major(h_g, pk.GROUP), _major(d_g, pk.GROUP), 50,
                          24)
    assert torch.equal(got, _major(want, pk.GROUP))


@pytest.mark.parametrize("K", [8, 16, 24])
@pytest.mark.parametrize("n_pad, n_sym", [(192, 150), (320, 320)],
                         ids=["n_sym inside a tile", "n_pad off 128"])
def test_build_stream_plain_equals_jax_on_edge_residuals(K, n_pad, n_sym):
    """Kernel 5's plain version against the JAX builder (interpret mode)
    with every residual of ``EDGE_RESIDUALS`` on every lane of a group; K
    8 and 16 cut the long symbols short.  Neither 192 nor 320 symbols is a
    whole number of the CUDA kernel's 128-symbol tiles; n_sym 150 ends
    inside the second tile, and its padding symbols are -1."""
    rng = np.random.default_rng(K + n_pad)
    shape = (1, n_pad, 8, 128)
    h_g = rng.integers(0, 8000, shape, dtype=np.int32)
    d_g = rng.choice(EDGE_RESIDUALS, shape)
    assert set(np.unique(d_g[:, :n_sym])) == set(EDGE_RESIDUALS)
    want = pk.build_stream(jnp.asarray(h_g), jnp.asarray(d_g), n_sym, K)
    got = ek.build_stream_plain(_major(h_g, pk.GROUP),
                                _major(d_g, pk.GROUP), n_sym, K)
    assert torch.equal(got, _major(want, pk.GROUP))


def test_stage_fwd_sort_equals_jax(chain):
    """The Tc prefix of the sorted slots, padding slots (context _BIG)
    included."""
    S = chain["S"]
    skey, spay = encode.stage_fwd_sort(_major(chain["stream"], S), chain["Tc"])
    assert torch.equal(skey, _major(chain["skey"], S))
    assert torch.equal(spay, _major(chain["spay"], S))
    assert (skey == 1 << 22).any()


def test_stage_walk_xs_equals_jax(chain):
    S = chain["S"]
    xs = encode.stage_walk_xs(_major(chain["skey"], S),
                              _major(chain["spay"], S))
    assert torch.equal(xs, _minor(chain["xs"], S))


def test_walk_probs_plain_equals_jax(chain):
    """Whole arrays: the padding entries' probabilities too."""
    S = chain["S"]
    assert torch.equal(ek.walk_probs(_minor(chain["xs"], S)),
                       _minor(chain["probs"], S))


def test_stage_back_sort_equals_jax(chain):
    S = chain["S"]
    cx = encode.stage_back_sort(_major(chain["skey"], S),
                                _major(chain["spay"], S),
                                _minor(chain["probs"], S))
    assert torch.equal(cx, _minor(chain["cx"], S))


def test_coder_scan_off_plain_equals_jax(chain):
    S = chain["S"]
    kp, fin = ek.coder_scan_off(_minor(chain["cx"], S))
    assert torch.equal(kp, _minor(chain["kp"], S))
    assert torch.equal(fin, _minor(chain["fin"], S))


def test_coder_scan_plain_equals_jax(chain):
    S = chain["S"]
    meta, runs, fin = ek.coder_scan(_minor(chain["cx"], S))
    assert torch.equal(meta, _minor(chain["meta"], S))
    assert torch.equal(runs, _minor(chain["runs"], S))
    assert torch.equal(fin, _minor(chain["fin4"], S))


@pytest.mark.parametrize("case", ["skewed", "0xFF runs", "odd T",
                                  "dead lanes"])
def test_coders_plain_equal_jax_on_skewed_records(case):
    """Random records, bits P(1) = 0.97 on half the lanes: long deferred
    runs and carries, in both coders.  The other cases: P(1) = 0.99 on
    every lane with probabilities 7..63 (deferred runs of 0xFF bytes past
    a hundred); T = 777, off the JAX kernel's 512-step chunk (JAX codes
    the same records followed by dead ones); lanes all dead and a dead
    tail of a different length in every other lane."""
    rng = np.random.default_rng(4)
    shape = (1, 1024, 8, 128)
    p1 = np.where(np.arange(128) % 2 == 0, 0.97, 0.5)
    probs = (7, 248)
    if case == "0xFF runs":
        p1, probs = np.full(128, 0.99), (7, 64)
    xs_g = ((rng.random(shape) < 0.9).astype(np.int32) << 9
            | (rng.random(shape) < p1).astype(np.int32) << 8
            | rng.integers(*probs, shape, dtype=np.int32))
    S, T = 40, 777 if case == "odd T" else 1024
    xs_g[:, T:] = 0
    if case == "dead lanes":          # port lane l is xs_g[0, :, 0, l]
        xs_g[0, :, 0, :10] = 0
        for lane in range(10, S):
            xs_g[0, 1024 - (lane * 37) % 700:, 0, lane] = 0
    kp_g, fin_g = pk.coder_scan_off(jnp.asarray(xs_g))
    meta_g, runs_g, fin4_g = pk.coder_scan(jnp.asarray(xs_g))
    xs = _minor(xs_g, S)[:T]
    kp, fin = ek.coder_scan_off(xs)
    assert torch.equal(kp, _minor(kp_g, S)[:T])
    assert torch.equal(fin, _minor(fin_g, S))
    meta, runs, fin4 = ek.coder_scan(xs)
    assert torch.equal(meta, _minor(meta_g, S)[:T])
    assert torch.equal(runs, _minor(runs_g, S)[:T])
    assert torch.equal(fin4, _minor(fin4_g, S))
    assert ((kp != coder.KP_SILENT) & ((kp & 0x100) != 0)).any()
    assert ((meta & 3) == 3).any() and (runs > 2).any()
    if case == "0xFF runs":
        assert (runs > 100).any()
    if case == "dead lanes":
        assert (kp[:, :10] == coder.KP_SILENT).all()
        assert torch.equal(fin[:, :10], torch.tensor(
            [[0], [0xFF00], [-1], [0], [0]], dtype=torch.int32).expand(5, 10))


def test_finish_steps_equal_jax(chain):
    S = chain["S"]
    fin4 = _minor(chain["fin4"], S)
    want_meta, want_runs = jcoder.finish_steps(
        tuple(jnp.asarray(r.numpy()) for r in fin4))
    meta, runs = coder.finish_steps(fin4)
    assert torch.equal(meta, torch.from_numpy(np.array(want_meta)))
    assert torch.equal(runs, torch.from_numpy(np.array(want_runs)))


def test_expand_slots_equals_jax_on_random_slot_records():
    """The records of the JAX package's device-expansion test: random emits,
    carries, heads and runs; whole byte rows and lengths."""
    rng = np.random.default_rng(7)
    S, T, outcap = 4, 256, 640
    emit = rng.random((S, T)) < 0.3
    meta = (emit.astype(np.int32)
            | (rng.integers(0, 2, (S, T)) << 1)
            | (rng.integers(0, 256, (S, T)) << 8)).astype(np.int32)
    runs = np.where(emit, rng.integers(0, 3, (S, T)), 0).astype(np.int32)
    want, want_lens = jcoder.expand_slots_on_device(
        jnp.asarray(meta), jnp.asarray(runs), outcap)
    got, lens = coder.expand_slots(torch.from_numpy(meta.T.copy()),
                                   torch.from_numpy(runs.T.copy()),
                                   outcap=outcap)
    assert torch.equal(lens, torch.from_numpy(np.array(want_lens)))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_slot_records_expand_to_the_chain_bytes(chain):
    """Kernel 8's records, flushed and expanded, give the decision chain's
    streams: the same bytes as kernel 7's offset records."""
    S, cap = chain["S"], chain["cap"]
    meta, runs, fin4 = ek.coder_scan(_minor(chain["cx"], S))
    mf, rf = coder.finish_steps(fin4)
    got, lens = coder.expand_slots(torch.cat([meta, mf]),
                                   torch.cat([runs, rf]), outcap=cap)
    assert torch.equal(lens, _minor(chain["lens"], S)[0])
    want = _major(chain["bytes"], S)
    for s in range(S):
        assert torch.equal(got[s, : lens[s]], want[s, : lens[s]])


def _engine_lanes(shape):
    return np.stack([make_photo(*shape, seed=3), make_noise(*shape, seed=4),
                     np.full(shape, 200, np.uint8)])


@pytest.mark.parametrize("shape", [None, (5, 6, 1), (3, 5, 4)])
def test_engine_equals_jax_decision_chain(shape, monkeypatch):
    """The mixed batch, grayscale and RGBA; the JAX engine under
    LLCT_ENCODE_VARIANT=decision."""
    lanes = _mixed_lanes() if shape is None else _engine_lanes(shape)
    monkeypatch.setenv("LLCT_ENCODE_VARIANT", "decision")
    want = jenc.encode_lanes(lanes, engine="pallas")
    assert encode.encode_lanes(lanes, device="cpu", engine="sort",
                               variant="decision") == want


@pytest.mark.parametrize("shape", [(4, 8, 3), (1, 24, 3), (12, 1, 3),
                                   (3, 5, 4), (5, 6, 1)])
def test_engine_equals_symbol_fused_and_oracle(shape):
    """Photo, noise and flat lanes; 1-row and 1-column stripes, RGBA and
    grayscale; the streams decode back."""
    lanes = _engine_lanes(shape)
    got = encode.encode_lanes(lanes, device="cpu", engine="sort",
                              variant="decision")
    assert got == encode.encode_lanes(lanes, device="cpu", engine="sort")
    assert got == encode.encode_lanes(lanes, device="cpu")
    for lane, stream in zip(lanes, got):
        assert stream == oracle.encode_planes(oracle.rct_forward(lane))
    np.testing.assert_array_equal(
        decode.decode_lanes(got, shape, device="cpu"), lanes)


def test_decision_variant_arguments_are_checked():
    lanes = _mixed_lanes()[:1]
    for kw in ({"primed": True}, {"seed": tables.PRIOR_TAB}):
        with pytest.raises(ValueError, match="no primed or seeded"):
            encode.encode_lanes(lanes, device="cpu", engine="sort",
                                variant="decision", **kw)
    with pytest.raises(ValueError, match="engine='sort'"):
        encode.encode_lanes(lanes, device="cpu", variant="decision")
    with pytest.raises(ValueError, match="variant"):
        encode.encode_lanes(lanes, device="cpu", engine="sort",
                            variant="quad")
    with pytest.raises(ValueError, match="int32"):
        ek.coder_scan(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="positive"):
        ek.build_stream(torch.zeros((1, 2), dtype=torch.int32),
                        torch.zeros((1, 2), dtype=torch.int32), 2, K=0)


def test_position_bound_raises():
    """n_sym * K < 2^20: checked on the bound itself (a stripe that large
    is too slow to encode here)."""
    encode.check_decision_bounds(43_690, 24)        # 1,048,560 slots
    encode.check_decision_bounds(131_071, 8)
    encode.check_decision_bounds(12_288, 24)        # the bench stripe
    for n_sym, K in ((43_691, 24), (65_536, 16), (131_072, 8)):
        with pytest.raises(ValueError, match=r"n_sym\*K < 2\^20"):
            encode.check_decision_bounds(n_sym, K)


def test_fwd_sort_keeps_positions_just_under_2_20():
    """One lane of 2^20 - 8 slots, random contexts and bits, a padding
    tail: every position comes back once, with its context and bit, in
    (context, position) order."""
    T = (1 << 20) - 8
    rng = np.random.default_rng(9)
    stream = rng.integers(0, 1 << 17, T).astype(np.int32)
    stream[T - 5000:] = -1
    skey, spay = encode.stage_fwd_sort(torch.from_numpy(stream)[None], T)
    pos = (spay[0] & 0xFFFFF).long()
    assert torch.equal(torch.sort(pos).values, torch.arange(T))
    src = torch.from_numpy(stream).long()[pos]
    live = src >= 0
    assert live.sum() == T - 5000 and live[: T - 5000].all()
    assert torch.equal(skey[0].long(), torch.where(live, src >> 1, 1 << 22))
    assert torch.equal((spay[0] >> 20).long(), src & 1)
    order = skey[0].long() << 20 | pos
    assert (order[1:] > order[:-1]).all()


def test_stage_hook_sees_every_stage_in_order():
    """``_encode_decision``'s hook gets each stage's outputs in order; they
    chain into one another and into the engine's bytes."""
    lanes = _mixed_lanes()
    seen = []
    out, lens = encode._encode_decision(
        torch.from_numpy(lanes), encode.REV2, None,
        lambda stage, *o: seen.append((stage, o)))
    made = dict(seen)
    assert [s for s, _ in seen] == STAGES
    K, total, h, diff = made["precompute and counts"]
    assert torch.equal(ek.build_stream_plain(h, diff, h.shape[1], K),
                       made["build"][0])
    assert made["fwd sort"][0].shape == (len(lanes), total)
    assert torch.equal(ek.walk_probs_plain(made["walk xs"][0]),
                       made["walk"][0])
    kp, fin = ek.coder_scan_off_plain(made["back sort"][0])
    assert torch.equal(kp, made["coder"][0]) and torch.equal(fin,
                                                             made["coder"][1])
    assert made["finish and expansion"][0] is out
    assert [out[s, : lens[s]].numpy().tobytes() for s in range(len(lanes))] \
        == encode.encode_lanes(lanes, device="cpu", engine="sort",
                               variant="decision")


def test_lane_chunking_byte_identical(monkeypatch):
    lanes = np.stack([make_photo(2, 4, seed=700 + i) for i in range(5)])
    want = encode.encode_lanes(lanes, device="cpu", engine="sort",
                               variant="decision")
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES", 1)  # one lane per chunk
    assert encode.lanes_per_chunk(8 * 3, "sort", "decision") == 1
    assert encode.encode_lanes(lanes, device="cpu", engine="sort",
                               variant="decision") == want
    assert want[4] == oracle.encode(lanes[4])[6:]


def test_lane_bytes_counts_the_decision_variant():
    n = 12_288
    assert encode.lane_bytes(n, "sort", "decision") >= \
        encode.DECISION_SLOT_BYTES * encode.MAX_SLOTS * n
    assert encode.lane_bytes(n, "sort") == encode.lane_bytes(n, "sort",
                                                             "symbol")
