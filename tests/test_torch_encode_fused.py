"""Kernel 1's plain version (through llcomp_tpu_torch.encode.encode_lanes on
the CPU) against the JAX package's fused Pallas engine in interpret mode and
against the NumPy oracle.  Exact stream bytes throughout."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import repeat_lanes
from llcomp_tpu import encode as jenc
from llcomp_tpu import oracle
from llcomp_tpu import seed as jseed
from llcomp_tpu_torch import coder, encode
from llcomp_tpu_torch.kernels import encode_fused as ef
from tests.conftest import make_noise, make_photo


def _mixed_lanes():
    return np.stack([make_photo(4, 8, seed=i) for i in range(2)]
                    + [np.full((4, 8, 3), 42, np.uint8), make_noise(4, 8)])


@pytest.fixture(scope="module")
def stored_seed():
    return jseed.derive(make_photo(16, 8, seed=21))


@pytest.mark.parametrize("mode", ["unprimed", "primed", "seeded"])
def test_equals_jax_fused_engine(mode, stored_seed):
    lanes = _mixed_lanes()
    kw = {"primed": mode == "primed",
          "seed": stored_seed if mode == "seeded" else None}
    want = jenc.encode_lanes(lanes, engine="fused", **kw)
    got = encode.encode_lanes(lanes, device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("shape", [(1, 24, 3), (12, 1, 3), (3, 5, 4),
                                   (5, 6, 1), (2, 7, 2)])
@pytest.mark.parametrize("mode", ["unprimed", "primed", "seeded"])
def test_equals_oracle(shape, mode, stored_seed):
    """1-row and 1-column stripes, RGBA, grayscale and C=2; photo and noise
    lanes in one batch."""
    lanes = np.stack([make_photo(*shape, seed=3), make_noise(*shape, seed=4)])
    seed = stored_seed if mode == "seeded" else None
    got = encode.encode_lanes(lanes, primed=mode == "primed", seed=seed,
                              device="cpu")
    for lane, stream in zip(lanes, got):
        want = oracle.encode_planes(oracle.rct_forward(lane),
                                    primed=mode == "primed", seed=seed)
        assert stream == want


# the geometries kernels 1 and 2 treat specially: C = 1 (no model word
# ahead in decode), C = 2 and C = 5 (decode's last templated and its generic
# instantiation), a one-row and a one-column stripe
SPECIAL_SHAPES = [(6, 40, 1), (5, 24, 2), (4, 12, 5), (1, 96, 3), (80, 1, 3)]


@pytest.mark.parametrize("shape", SPECIAL_SHAPES)
def test_special_lanes_equal_jax_fused_engine(shape):
    """Photo, noise and hash-repeating lanes: unprimed through
    ``encode_lanes``, primed straight through the plain version with a dead
    tail on every lane, which codes nothing."""
    lanes = np.stack([make_photo(*shape, seed=5), make_noise(*shape, seed=6)]
                     + repeat_lanes(shape))
    want = jenc.encode_lanes(lanes, engine="fused")
    assert encode.encode_lanes(lanes, device="cpu") == want
    want = jenc.encode_lanes(lanes, engine="fused", primed=True)
    xs = encode.precompute(torch.from_numpy(lanes)).t().contiguous()
    dead = torch.cat([xs, xs[:9] & ~(1 << 25)])
    out, lens, ovf = ef.encode_fused_plain(
        dead, encode._start_table(True, None), encode.outcap(dead.shape[0]))
    assert not ovf.any()
    assert [out[s, : lens[s]].numpy().tobytes()
            for s in range(len(lanes))] == want


def test_lane_chunking_byte_identical(monkeypatch):
    lanes = np.stack([make_photo(2, 4, seed=600 + i) for i in range(5)])
    want = encode.encode_lanes(lanes, device="cpu")
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES", 1)  # one lane per chunk
    assert encode.encode_lanes(lanes, device="cpu") == want
    assert want[4] == oracle.encode(lanes[4])[6:]


def test_skips_dead_symbols_and_raises_on_overflow():
    lanes = np.stack([make_noise(3, 4, seed=i) for i in range(2)])
    xs = encode.precompute(torch.from_numpy(lanes)).t().contiguous()
    out, lens = ef.encode_fused(xs, None, encode.outcap(xs.shape[0]))
    dead = torch.cat([xs, xs & ~(1 << 25)])      # dead padding is not coded
    out2, lens2 = ef.encode_fused(dead, None, encode.outcap(dead.shape[0]))
    assert torch.equal(lens, lens2)
    for s in range(2):
        assert torch.equal(out[s, : lens[s]], out2[s, : lens2[s]])
    with pytest.raises(RuntimeError, match="overflow"):
        ef.encode_fused(xs, None, 16)
    _, _, ovf = ef.encode_fused_plain(xs, None, 16)
    assert ovf.all()
    with pytest.raises(ValueError):
        ef.encode_fused(xs.long(), None, 64)


def test_vector_coder_equals_oracle_coder():
    """The lane-vectorised range coder against oracle.RangeEncoder on skewed
    random decisions, which make long deferred runs and carries."""
    rng = np.random.default_rng(0)
    S, T = 6, 3000
    probs = rng.integers(7, 248, (T, S))
    p1 = np.where(np.arange(S) % 2 == 0, 0.97, 0.5)
    bits = (rng.random((T, S)) < p1).astype(np.int64)
    valid = rng.random((T, S)) < 0.9
    enc = coder.Encoder(S, 2 * T, "cpu")
    for t in range(T):
        enc.put(torch.from_numpy(bits[t]), torch.from_numpy(probs[t]),
                torch.from_numpy(valid[t]))
    out, lens, ovf = enc.finish()
    assert not ovf.any()
    carried = 0
    for s in range(S):
        ref = oracle.RangeEncoder()
        for t in range(T):
            if valid[t, s]:
                ref.put(int(bits[t, s]), int(probs[t, s]))
        want = ref.finish()
        assert out[s, : lens[s]].numpy().tobytes() == want
        carried += want.count(0)
    assert carried  # a carried run writes zero bytes
