"""Every codec configuration the JAX package honours, in the port (CPU).

The configurations are ``chip_smoke.CFG_CASES``: REV2, the small model
(666 hashes), e_lim 3 / r_lim 5 / sign_ctx 6, 4 substates (the mantissa and
the sign share context 3), 16 substates (two model words a hash) and
revision 3.  Each is held against ``llcomp_tpu``: kernel 1's plain version
against ``oracle.encode_planes``, kernel 2's against ``oracle.decode`` (a
cut stream reads zeros past its end), ``api.compress``'s single streams
against ``oracle.encode``, its sliced containers against
``llcomp_tpu.api.compress(backend="jax")`` (the XLA engines on the CPU),
and the lane paths round-trip.  Invalid configurations raise ValueError
naming their field.  Tolerance: exact bytes and pixels.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from chip_smoke import (CFG_CASES, CFG_GOLDEN_SHA, _malicious_stream,
                        bench_images, bench_lanes)
from llcomp_tpu import api as japi
from llcomp_tpu import oracle
from llcomp_tpu.core.config import CodecConfig as JaxConfig
from llcomp_tpu_torch import (api, container, corpus, decode, distributed,
                              encode, parallel)
from llcomp_tpu_torch.core import config, tables, transform
from llcomp_tpu_torch.core.config import REV2, CodecConfig
from llcomp_tpu_torch.kernels import decode_kernel as dk
from llcomp_tpu_torch.kernels import encode_fused as ef
from tests.conftest import make_photo

NAMES = list(CFG_CASES)
EIGHT = [n for n in NAMES if CodecConfig(**CFG_CASES[n]).substates == 8]
# the lanes the JAX package's engines were run on under each cfg
LANES = (np.random.default_rng(0).integers(0, 40, (3, 8, 12, 3))
         + np.arange(12)[None, None, :, None] * 4).astype(np.uint8)
SEED = np.roll(tables.PRIOR_TAB, 7, axis=0)   # a stored seed unlike the prior


def cfgs(name: str) -> tuple[CodecConfig, JaxConfig]:
    return CodecConfig(**CFG_CASES[name]), JaxConfig(**CFG_CASES[name])


def _xs(lanes: np.ndarray, cfg: CodecConfig) -> torch.Tensor:
    return encode.precompute(torch.from_numpy(lanes), cfg).t().contiguous()


def _cut(out: torch.Tensor, lens: torch.Tensor) -> list[bytes]:
    return [out[s, : int(lens[s])].numpy().tobytes() for s in range(len(lens))]


def _oracle_streams(lanes, jc, **start) -> list[bytes]:
    return [oracle.encode_planes(oracle.rct_forward(lane), jc, **start)
            for lane in lanes]


@pytest.mark.parametrize("name", NAMES)
def test_plain_encoder_equals_oracle(name):
    cfg, jc = cfgs(name)
    out, lens, ovf = ef.encode_fused_plain(_xs(LANES, cfg), None, 1024, cfg)
    assert not ovf.any()
    assert _cut(out, lens) == _oracle_streams(LANES, jc)


@pytest.mark.parametrize("name", NAMES)
def test_plain_decoder_exact_and_flags(name):
    """decode_plain: exact on the oracle's streams; a stream cut short
    decodes as the oracle decodes it (zeros past the end), unflagged; a
    stream built to run past the decision cap is flagged."""
    cfg, jc = cfgs(name)
    lanes = LANES[:, :4]
    H, W, C = lanes.shape[1:]
    streams = _oracle_streams(lanes, jc)
    cut = streams[1][: len(streams[1]) // 3]
    data, n = decode._pack([streams[0], cut, _malicious_stream()])
    planes, err = dk.decode_plain(torch.from_numpy(data), torch.from_numpy(n),
                                  H, W, C, None, cfg)
    imgs = transform.rct_inverse(planes.t().reshape(3, H, W, C)).numpy()
    np.testing.assert_array_equal(imgs[0], lanes[0])
    header = bytes([jc.magic, C, W, 0, H, 0])
    np.testing.assert_array_equal(imgs[1], oracle.decode(header + cut, jc))
    assert err.tolist() == [0, 0, 1]


@pytest.mark.parametrize("name", NAMES)
def test_single_stream_equals_oracle(name):
    cfg, jc = cfgs(name)
    img = make_photo(6, 10, seed=3)
    blob = api.compress(img, cfg=cfg, device="cpu")
    assert blob == oracle.encode(img, jc)
    np.testing.assert_array_equal(api.decompress(blob, cfg, device="cpu"),
                                  img)


@pytest.mark.parametrize("name", NAMES)
def test_sliced_equals_jax_package(name):
    """Unprimed, unseeded containers equal the JAX package's XLA engines'
    (the JAX package's primed path is wrong off 8 substates); the auto
    policy round-trips and neither primes nor seeds off 8 substates."""
    cfg, jc = cfgs(name)
    img = make_photo(12, 10, seed=5)
    blob = api.compress(img, slices=3, cfg=cfg, device="cpu", primed=False,
                        seeded=False)
    assert blob == japi.compress(img, slices=3, cfg=jc, primed=False,
                                 seeded=False, backend="jax")
    np.testing.assert_array_equal(api.decompress(blob, cfg, device="cpu"),
                                  img)
    auto = api.compress(img, slices="auto", cfg=cfg, device="cpu")
    flags = container.unpack_sliced(auto, cfg)[5]
    if cfg.substates != 8:
        assert not flags & (container.FLAG_PRIMED | container.FLAG_SEEDED)
    np.testing.assert_array_equal(api.decompress(auto, cfg, device="cpu"),
                                  img)


@pytest.mark.parametrize("name", EIGHT)
def test_primed_and_seeded_lanes_equal_oracle(name):
    cfg, jc = cfgs(name)
    lanes = LANES[:2, :4]
    H, W, C = lanes.shape[1:]
    for start in ({"primed": True}, {"seed": SEED}):
        streams = encode.encode_lanes(lanes, cfg, device="cpu", **start)
        assert streams == _oracle_streams(lanes, jc, **start)
        np.testing.assert_array_equal(
            decode.decode_lanes(streams, (H, W, C), cfg, device="cpu",
                                **start), lanes)


@pytest.mark.parametrize("name", NAMES)
def test_lane_paths_round_trip(name):
    """reencode_slice, the corpus, parallel on a list of CPU devices and
    compress_image_pod (no process group: one rank) under the cfg."""
    cfg, _ = cfgs(name)
    img, img2 = make_photo(8, 6, seed=7), make_photo(4, 6, seed=8)
    blob = api.compress(img, slices=2, cfg=cfg, device="cpu", primed=False,
                        seeded=False)
    assert api.reencode_slice(blob, 1, img[4:], cfg, device="cpu") == blob
    blobs, _ = corpus.compress_corpus([img, img2], slice_h=4, cfg=cfg,
                                      device="cpu", tile_w=0)
    for got, want in zip(corpus.decompress_corpus(blobs, cfg, device="cpu"),
                         (img, img2)):
        np.testing.assert_array_equal(got, want)
    mesh = ["cpu", "cpu"]
    sharded = parallel.compress_sharded(img, mesh, slices=2, cfg=cfg)
    np.testing.assert_array_equal(
        parallel.decompress_sharded(sharded, mesh, cfg), img)
    np.testing.assert_array_equal(api.decompress(sharded, cfg, device="cpu"),
                                  img)
    pod = distributed.compress_image_pod(img, slice_h=4, cfg=cfg,
                                         primed=False, device="cpu")
    assert pod == blob


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_cfg_goldens_equal_oracle(name):
    """chip_smoke.CFG_GOLDEN_SHA: the first 4 lanes of the bench batch
    (8x512x3 stripes of the seeded photo images), unprimed, under each cfg,
    as llcomp_tpu.oracle codes them."""
    _, jc = cfgs(name)
    lanes = bench_lanes(bench_images(100)[:1])[:4]
    streams = _oracle_streams(lanes, jc)
    assert hashlib.sha256(b"".join(streams)).hexdigest() == \
        CFG_GOLDEN_SHA[name]


@st.composite
def _cfg_and_lanes(draw):
    subs = draw(st.integers(1, 16))
    e_lim = draw(st.integers(0, 20 if subs > 11 else subs - 1))
    cfg = CodecConfig(
        revision=draw(st.integers(1, 255)), large_model=draw(st.booleans()),
        e_lim=e_lim, r_lim=draw(st.integers(0, 24)),
        sign_ctx=draw(st.integers(0, subs - 1)), substates=subs,
        max_bins_per_symbol=draw(st.integers(23, 40)))
    try:
        config.check(cfg)
    except ValueError:
        assume(False)
    shape = (draw(st.integers(1, 3)), draw(st.integers(1, 3)),
             draw(st.integers(1, 5)), draw(st.integers(1, 4)))
    flat = draw(st.binary(min_size=int(np.prod(shape)),
                          max_size=int(np.prod(shape))))
    lanes = np.frombuffer(flat, dtype=np.uint8).reshape(shape).copy()
    if draw(st.booleans()):            # smooth lanes: long zero runs
        lanes = (lanes // 64 * 4 + 100).astype(np.uint8)
    return cfg, lanes


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.filter_too_much,
                                 HealthCheck.too_slow])
@given(_cfg_and_lanes())
def test_plain_encoder_equals_oracle_on_drawn_cfgs(case):
    cfg, lanes = case
    jc = JaxConfig(**{f: getattr(cfg, f) for f in (
        "revision", "large_model", "e_lim", "r_lim", "sign_ctx", "substates",
        "max_bins_per_symbol")})
    out, lens, _ = ef.encode_fused_plain(_xs(lanes, cfg), None,
                                         encode.max_stream_bytes(
                                             lanes[0].size, cfg) + 3, cfg)
    assert _cut(out, lens) == _oracle_streams(lanes, jc)


_IMG = make_photo(8, 8, seed=1)
_SUB16 = CodecConfig(substates=16, e_lim=8, r_lim=12, sign_ctx=15)
INVALID = {
    "revision 0": (lambda: api.compress(_IMG, cfg=CodecConfig(revision=0),
                                        device="cpu"), "revision"),
    "revision 256": (lambda: config.check(CodecConfig(revision=256)),
                     "revision"),
    "substates 0": (lambda: config.check(CodecConfig(
        substates=0, e_lim=0, r_lim=0, sign_ctx=0)), "substates"),
    "e_lim -1": (lambda: encode.encode_lanes(
        _IMG[None], CodecConfig(e_lim=-1), device="cpu"), "e_lim"),
    "e_lim 8": (lambda: config.check(CodecConfig(e_lim=8)), "e_lim"),
    "r_lim 8": (lambda: decode.decode_lanes(
        [b""], (8, 8, 3), CodecConfig(r_lim=8), device="cpu"), "r_lim"),
    "sign_ctx 8": (lambda: api.decompress(
        b"\x79\x03\x08\x00\x08\x00", CodecConfig(sign_ctx=8), device="cpu"),
        "sign_ctx"),
    "max_bins 22": (lambda: config.check(CodecConfig(max_bins_per_symbol=22)),
                    "max_bins_per_symbol"),
    "primed at 16 substates": (lambda: api.compress(
        _IMG, slices=2, cfg=_SUB16, primed=True, device="cpu"), "substates"),
    "seeded at 16 substates": (lambda: api.compress(
        _IMG, slices=2, cfg=_SUB16, primed=False, seeded=True,
        device="cpu"), "substates"),
    "seed lanes at 16 substates": (lambda: encode.encode_lanes(
        _IMG[None], _SUB16, seed=SEED, device="cpu"), "substates"),
    "primed corpus at 16 substates": (lambda: corpus.compress_corpus(
        [_IMG], 4, _SUB16, primed=True, device="cpu"), "substates"),
    "native at e_lim 3": (lambda: api.compress(
        _IMG, cfg=CodecConfig(e_lim=3), backend="native"), "native"),
    "sort primed at 16 substates": (lambda: encode.encode_lanes(
        _IMG[None], _SUB16, primed=True, device="cpu", engine="sort"),
        "substates"),
}


@pytest.mark.parametrize("case", INVALID)
def test_invalid_cfg_raises_naming_its_field(case):
    call, field = INVALID[case]
    with pytest.raises(ValueError, match=field):
        call()


def test_auto_backend_and_defines():
    """'auto' takes the device engine for a cfg other than REV2; REV2 and a
    cfg differing only in revision build with no define (the rev-2
    kernels); each other field is one define, the hash count beside the
    small model's."""
    e3 = CodecConfig(e_lim=3, r_lim=5, sign_ctx=6)
    assert api._resolve_backend("auto", "cpu", single=True, cfg=e3) == \
        ("torch", torch.device("cpu"))
    assert api._resolve_backend("auto", "cpu", single=True) == \
        ("native", None)
    assert config.defines(REV2) == config.defines(CodecConfig(revision=3)) \
        == ()
    assert config.defines(e3) == ("-DLLCT_E_LIM=3", "-DLLCT_R_LIM=5",
                                  "-DLLCT_SIGN_CTX=6")
    assert config.defines(CodecConfig(large_model=False)) == (
        "-DLLCT_LARGE_MODEL=0", "-DLLCT_NUM_HASHES=666")
    assert ef.model_bytes(REV2) == REV2.num_states == 63_408
    assert ef.model_bytes(CodecConfig(large_model=False)) == 666 * 8
    assert ef.model_bytes(_SUB16) == 2 * 7926 * 8
    assert encode.max_stream_bytes(10, CodecConfig(
        max_bins_per_symbol=32)) == 321
