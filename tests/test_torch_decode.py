"""Kernel 2's plain version (through llcomp_tpu_torch.decode.decode_lanes on
the CPU) against the JAX package's Pallas decode kernels in interpret mode
(the per-symbol kernel, and the blocked kernel via LLCT_DECODE_FORCE_BLOCKED)
and the NumPy oracle.  Exact pixels and equal bad-lane lists throughout."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import repeat_lanes
from llcomp_tpu import decode as jdec
from llcomp_tpu import oracle
from llcomp_tpu import seed as jseed
from llcomp_tpu_torch import coder, decode
from llcomp_tpu_torch.kernels import decode_kernel as dk
from tests.conftest import make_noise, make_photo
from tests.test_native import _malicious_stream


def _faulty_streams(lanes, **kw):
    """Oracle streams of ``lanes`` with lane 1 truncated, lane 2 corrupted
    (tests/test_pallas.py's unterminated exponent), lane 3 garbage-tailed
    and lane 4 bit-flipped."""
    streams = [oracle.encode_planes(oracle.rct_forward(x), **kw)
               for x in lanes]
    streams[1] = streams[1][: len(streams[1]) // 2]
    streams[2] = _malicious_stream()
    streams[3] = streams[3] + bytes(range(7, 250, 3))
    streams[4] = bytes(b ^ 0x21 for b in streams[4])
    return streams


def _compare(streams, shape, **kw):
    want, want_bad = jdec.decode_lanes(streams, shape, engine="pallas",
                                       errors="report", **kw)
    got, bad = decode.decode_lanes(streams, shape, errors="report",
                                   device="cpu", **kw)
    assert bad == want_bad
    for i in range(len(streams)):
        if i not in bad:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"lane {i}")
    return got, bad


@pytest.mark.parametrize("blocked", [False, True])
def test_faulty_streams_equal_jax_kernels(blocked, monkeypatch):
    if blocked:
        monkeypatch.setenv("LLCT_DECODE_FORCE_BLOCKED", "1")
    lanes = [make_photo(4, 8, seed=i) for i in range(5)] + [
        make_noise(4, 8, seed=2), np.full((4, 8, 3), 9, np.uint8)]
    got, bad = _compare(_faulty_streams(lanes), (4, 8, 3))
    assert 2 in bad
    for i in (0, 5, 6):
        np.testing.assert_array_equal(got[i], lanes[i])


@pytest.mark.parametrize("shape", [(7, 5, 1), (3, 3, 3)])
def test_odd_strides_equal_jax_kernel(shape):
    lanes = [make_photo(*shape, seed=i) for i in range(5)] + [
        make_noise(*shape, seed=3)]
    got, _ = _compare(_faulty_streams(lanes), shape)
    np.testing.assert_array_equal(got[0], lanes[0])
    np.testing.assert_array_equal(got[5], lanes[5])


@pytest.mark.parametrize("mode", ["primed", "seeded"])
def test_primed_and_seeded_equal_jax_kernel(mode, monkeypatch):
    monkeypatch.setenv("LLCT_DECODE_FORCE_BLOCKED", "1")
    img = make_photo(16, 8, seed=13)
    kw = ({"primed": True} if mode == "primed"
          else {"seed": jseed.derive(img)})
    lanes = [img[:4], img[4:8], img[8:12], img[12:]] + [
        make_noise(4, 8, seed=5)]
    streams = _faulty_streams(lanes, **kw)
    got, _ = _compare(streams, (4, 8, 3), **kw)
    np.testing.assert_array_equal(got[0], lanes[0])


@pytest.mark.parametrize("shape", [(1, 16, 3), (9, 1, 3), (2, 3, 4),
                                   (3, 4, 2)])
def test_roundtrip_equals_oracle(shape):
    lanes = np.stack([make_photo(*shape, seed=8), make_noise(*shape, seed=9)])
    streams = [oracle.encode(x)[6:] for x in lanes]
    np.testing.assert_array_equal(
        decode.decode_lanes(streams, shape, device="cpu"), lanes)
    with pytest.raises(ValueError, match="lanes \\[1\\]"):
        decode.decode_lanes([streams[0], _malicious_stream()], shape,
                            device="cpu")


# C = 1 (no model word ahead in kernel 2), C = 2 and C = 5 (its last
# templated and its generic instantiation), a one-row and a one-column stripe
SPECIAL_SHAPES = [(6, 40, 1), (5, 24, 2), (4, 12, 5), (1, 96, 3), (80, 1, 3)]


@pytest.mark.parametrize("shape", SPECIAL_SHAPES)
def test_special_lanes_equal_jax_kernels(shape, monkeypatch):
    """Hash-repeating lanes (model-word forwarding), C = 2 and C = 5, one
    row and one column, and streams cut inside a 16-byte word; the JAX
    blocked kernel where the stride allows it, else its per-symbol one."""
    monkeypatch.setenv("LLCT_DECODE_FORCE_BLOCKED", "1")
    lanes = [make_photo(*shape, seed=5), make_noise(*shape, seed=6)] + \
        repeat_lanes(shape)
    streams = [oracle.encode(x)[6:] for x in lanes]
    streams[0] = streams[0][: 16 * (len(streams[0]) // 32) + 7]
    streams[1] = streams[1][:45]
    assert all(len(s) % 16 for s in streams[:2])
    got, _ = _compare(streams, shape)
    for i in range(2, len(lanes)):
        np.testing.assert_array_equal(got[i], lanes[i])


def test_lane_chunking_identical(monkeypatch):
    lanes = [make_photo(2, 4, seed=i) for i in range(3)]
    streams = [oracle.encode(x)[6:] for x in lanes] + [_malicious_stream()]
    want = decode.decode_lanes(streams, (2, 4, 3), errors="report",
                               device="cpu")
    monkeypatch.setattr(decode, "LANE_BUDGET_BYTES", 1)
    got = decode.decode_lanes(streams, (2, 4, 3), errors="report",
                              device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == [3]


def test_planes_hold_post_rct_values_and_input_checks():
    img = make_photo(3, 4, seed=1)
    data, lens = decode._pack([oracle.encode(img)[6:]])
    planes, err = dk.decode(torch.from_numpy(data), torch.from_numpy(lens),
                            3, 4, 3, None)
    assert planes.dtype == torch.int32 and planes.shape == (36, 1)
    np.testing.assert_array_equal(planes[:, 0].numpy(),
                                  oracle.rct_forward(img).reshape(-1))
    assert int(err[0]) == 0
    with pytest.raises(ValueError):
        dk.decode(torch.from_numpy(data).int(), torch.from_numpy(lens),
                  3, 4, 3, None)


def test_vector_decoder_equals_oracle_decoder():
    """Reads past a lane's length are zeros; random byte soups decode to the
    same bits as oracle.RangeDecoder.  (A first byte below 0xFF keeps
    low < range, where the oracle's unbounded ints and int32 agree.)"""
    rng = np.random.default_rng(1)
    S, T = 4, 400
    blobs = [(rng.integers(0, 256, n) % np.where(np.arange(n) == 0, 255, 256))
             .astype(np.uint8).tobytes() for n in (0, 3, 40, 200)]
    data, lens = decode._pack(blobs)
    dec = coder.Decoder(torch.from_numpy(data), torch.from_numpy(lens))
    probs = rng.integers(7, 248, (T, S))
    got = np.stack([dec.get(torch.from_numpy(probs[t]),
                            torch.ones(S, dtype=torch.bool)).numpy()
                    for t in range(T)])
    for s in range(S):
        ref = oracle.RangeDecoder(blobs[s])
        want = [ref.get(int(probs[t, s])) for t in range(T)]
        np.testing.assert_array_equal(got[:, s], want)
