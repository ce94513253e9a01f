"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test skips (the kernels have no CPU
build).  Run on a GPU host with
``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the shared
conftest imports JAX, which a GPU host need not have).  Tolerance: exact.
"""
from __future__ import annotations

import contextlib
import functools
import json
import re

import numpy as np
import pytest
import torch

from chip_smoke import (CODERS, EDGE_RESIDUALS, P11_TAGS, PG_TAGS, PG_WORDS,
                        PH_CLUSTERS, PROBE_TAGS, REDUCE_TAGS, STAGE_DEPTHS,
                        WALK_LANES, at_offset, build_variant, coder_cases,
                        coder_depth, off_record_cases, p7_hazard_cases,
                        p9_hazard_idx, p11_cases, p11_inputs, pack_quads,
                        pF_hazard_cases, pG_cases, reduce_cases, repeat_lanes,
                        running, skewed_recs, walk_case_errs, walk_steps)
from chip_smoke import (MIXED, OVERFLOW_SEED, _flip_slice, _malicious_stream,
                        make_image, overflow_batches, sanitize,
                        sanitizer_status)
from chip_smoke import (CFG_BATCHES, CFG_CASES, _cfg_start, cfg_sort_case,
                        codec_batches, codec_case)
from chip_smoke import bench_images, bench_lanes
from llcomp_tpu_torch import (api, coder, container, corpus, decode, encode,
                              graft_entry, host, parallel, probes, profiling,
                              seed)
from llcomp_tpu_torch import device as devmod
from llcomp_tpu_torch.core import config
from llcomp_tpu_torch.core.config import REV2, CodecConfig
from llcomp_tpu_torch.kernels import build
from llcomp_tpu_torch.kernels import decode_kernel as dk
from llcomp_tpu_torch.kernels import encode_fused as ef
from llcomp_tpu_torch.kernels import encode_kernels as ek
from llcomp_tpu_torch.probes import mosaic, mosaic2, mosaic3, reduce

pytestmark = pytest.mark.cuda
PROBES = {k: p for m in (mosaic, mosaic2, mosaic3, reduce)
          for k, p in m.PROBES.items()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _lanes(shape, n=5):
    rng = np.random.default_rng(sum(shape))
    walk = np.cumsum(rng.integers(-5, 6, (n, *shape)), axis=2) + 120
    lanes = np.clip(walk, 0, 255).astype(np.uint8)
    lanes[-1] = rng.integers(0, 256, shape, dtype=np.uint8)
    return lanes


@pytest.mark.parametrize("shape", [(4, 16, 3), (7, 5, 1), (1, 40, 4),
                                   (20, 1, 3)])
@pytest.mark.parametrize("primed", [False, True])
def test_kernels_equal_plain(dev, shape, primed):
    lanes = _lanes(shape)
    init = encode._start_table(primed, None)
    xs = encode.precompute(torch.from_numpy(lanes).to(dev)).t().contiguous()
    cap = encode.outcap(xs.shape[0])
    before = ef.encode_fused.launches
    out, lens = ef.encode_fused(xs, init, cap)
    assert ef.encode_fused.launches == before + 1
    out_p, lens_p, ovf = ef.encode_fused_plain(xs, init, cap)
    assert torch.equal(lens, lens_p) and not ovf.any()
    streams = []
    for s in range(len(lanes)):
        assert torch.equal(out[s, : lens[s]], out_p[s, : lens[s]])
        streams.append(out[s, : lens[s]].cpu().numpy().tobytes())
    streams[0] = streams[0][: len(streams[0]) // 2]
    streams[1] = bytes(b ^ 0x33 for b in streams[1])
    data, n = decode._pack(streams)
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(n).to(dev)
    planes, err = dk.decode(d, ln, *shape, init)
    planes_p, err_p = dk.decode_plain(d, ln, *shape, init)
    assert torch.equal(err, err_p) and torch.equal(planes, planes_p)


@pytest.mark.parametrize("name", list(CFG_CASES))
def test_cfg_builds_equal_plain(dev, name):
    """Kernels 1 and 2 built for each cfg, held against their plain
    versions on phase 12's runs of phase 3's batches (dead tails, flipped
    and cut streams, a stream past the cap, garbage past the lengths)."""
    cfg = CodecConfig(**CFG_CASES[name])
    batches = codec_batches()
    d = config.defines(cfg)
    before = (ef.encode_fused.by_cfg.get(d, 0), dk.decode.by_cfg.get(d, 0))
    for batch in CFG_BATCHES:
        for mode, init in _cfg_start(cfg, batch):
            r = codec_case(torch, dev, batch, batches[batch], mode, init, cfg)
            assert r["encode"] == 0 and r["decode"] == 0, (batch, mode)
    assert ef.encode_fused.by_cfg[d] > before[0]
    assert dk.decode.by_cfg[d] > before[1]


@pytest.mark.parametrize("name", list(CFG_CASES))
def test_cfg_sort_builds_equal_plain(dev, name):
    """Kernels 3 and 5 built for each cfg, held against their plain
    versions on phase 13's runs of phase 3's batches (the engine's inputs
    and a dead tail; primed and seeded at 8 substates), the sort engine's
    streams equal to kernel 1's; each build's launch count rises."""
    cfg = CodecConfig(**CFG_CASES[name])
    batches = codec_batches()
    d = config.defines(cfg)
    before = (ek.walk_symbols.by_cfg.get(d, 0),
              ek.build_stream.by_cfg.get(d, 0))
    for batch in CFG_BATCHES:
        for mode, init in _cfg_start(cfg, batch):
            r = cfg_sort_case(torch, dev, batch, batches[batch], mode, init,
                              cfg)
            assert r["walk"] == 0 and r["build"] == 0, (batch, mode)
    assert ek.walk_symbols.by_cfg[d] > before[0]
    assert ek.build_stream.by_cfg[d] > before[1]


@pytest.mark.parametrize("wrapper", ["walk_symbols", "build_stream"])
def test_cfg_sort_wrapper_refuses_an_invalid_cfg(dev, wrapper):
    """A cfg that config.check refuses (sign context 8 at 8 substates)
    raises on a CUDA tensor, naming sign_ctx, before any build runs."""
    bad = CodecConfig(sign_ctx=8)
    x = torch.zeros((8, 2), dtype=torch.int32, device=dev)
    before = ek.walk_symbols.launches + ek.build_stream.launches
    with pytest.raises(ValueError, match="sign_ctx"):
        if wrapper == "walk_symbols":
            ek.walk_symbols(x, 8, None, bad)
        else:
            ek.build_stream(x, x, 8, 8, bad)
    assert ek.walk_symbols.launches + ek.build_stream.launches == before


def test_second_cfg_sort_build_keeps_the_first(dev, monkeypatch):
    """Two cfg builds of kernels 3 and 5 stand side by side in _build/:
    loading the first again after the second was built runs no
    compiler, and each codes its cfg's bytes."""
    e3 = CodecConfig(e_lim=3, r_lim=5, sign_ctx=6)
    sub16 = CodecConfig(substates=16, e_lim=8, r_lim=12, sign_ctx=15)
    for name in ("walk_symbols", "build_stream"):
        a, b = (build.build(name, config.defines(c)) for c in (e3, sub16))
        assert a != b and a.exists() and b.exists()
    for name in ("coder_scan", "walk_probs"):     # the engine's other builds
        build.build(name)
    monkeypatch.setattr(build, "_libs", {})

    def no_compiler(*args, **kwargs):
        raise AssertionError(f"a build ran again: {args}")

    monkeypatch.setattr(build.subprocess, "run", no_compiler)
    lanes = _lanes((4, 16, 3))
    for cfg in (e3, sub16):
        want = encode.encode_lanes(lanes, cfg, device="cpu")
        for variant in encode.VARIANTS:
            assert encode.encode_lanes(lanes, cfg, device=dev, engine="sort",
                                       variant=variant) == want
        for name in ("walk_symbols", "build_stream"):
            assert (name, config.defines(cfg)) in build._libs


def test_second_cfg_build_keeps_the_first(dev, monkeypatch):
    """Builds of two cfgs stand side by side in _build/: loading the first
    again after the second was built runs no compiler."""
    first = config.defines(CodecConfig(e_lim=3, r_lim=5, sign_ctx=6))
    second = config.defines(CodecConfig(large_model=False))
    for name in ("encode_fused", "decode_kernel"):
        a, b = build.build(name, first), build.build(name, second)
        assert a != b and a.exists() and b.exists()
    monkeypatch.setattr(build, "_libs", {})

    def no_compiler(*args, **kwargs):
        raise AssertionError(f"a build ran again: {args}")

    monkeypatch.setattr(build.subprocess, "run", no_compiler)
    lanes = _lanes((4, 16, 3))
    for defines, cfg in ((first, CodecConfig(e_lim=3, r_lim=5, sign_ctx=6)),
                         (second, CodecConfig(large_model=False))):
        xs = encode.precompute(torch.from_numpy(lanes).to(dev),
                               cfg).t().contiguous()
        out, lens = ef.encode_fused(xs, None, encode.outcap(xs.shape[0]), cfg)
        want = encode.encode_lanes(lanes, cfg, device="cpu")
        assert [out[s, : lens[s]].cpu().numpy().tobytes()
                for s in range(len(lanes))] == want
        assert (("encode_fused", defines) in build._libs)


@pytest.mark.parametrize("shape,S", [((6, 24, 1), 1), ((5, 12, 2), 33),
                                     ((4, 6, 5), 130), ((1, 40, 3), 33),
                                     ((20, 1, 4), 130), ((2, 8, 3), 1101)])
def test_kernels_equal_plain_on_special_lanes(dev, shape, S):
    """Kernels 1 and 2 on hash-repeating lanes, C from 1 to 5 (every
    instantiation of kernel 2), ragged lane counts (1,101: past 8 one-lane
    blocks a SM, kernel 2 packs 2 lanes a block), a dead tail on every
    lane, a stream cut inside a 16-byte word and bytes past every length
    that are not zero."""
    imgs = list(_lanes(shape, 3)) + repeat_lanes(shape)
    lanes = np.stack([imgs[i % len(imgs)] for i in range(S)])
    init = encode._start_table(True, None)
    xs = encode.precompute(torch.from_numpy(lanes).to(dev)).t().contiguous()
    xs = torch.cat([xs, xs[:7] & ~(1 << 25)])
    cap = encode.outcap(xs.shape[0])
    out_p, lens_p, ovf = ef.encode_fused_plain(xs, init, cap)
    assert not ovf.any()
    out, lens = ef.encode_fused(xs, init, cap)
    assert torch.equal(lens, lens_p)
    for s in range(S):
        assert torch.equal(out[s, : lens[s]], out_p[s, : lens[s]])
    streams = [out_p[s, : lens_p[s]].cpu().numpy().tobytes()
               for s in range(S)]
    streams[0] = streams[0][: 16 * (len(streams[0]) // 32) + 7]
    data, n = decode._pack(streams)
    data[np.arange(data.shape[1])[None, :] >= n[:, None]] = 0xA5
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(n).to(dev)
    inst = dk.instance(shape[2])
    before = dk.decode.instances[inst]
    planes, err = dk.decode(d, ln, *shape, init)
    assert dk.decode.instances[inst] == before + 1
    planes_p, err_p = dk.decode_plain(d, ln, *shape, init)
    assert torch.equal(err, err_p) and torch.equal(planes, planes_p)
    if S > 1:
        assert not err[1:].any()


def test_decode_takes_unaligned_rows(dev):
    """Rows whose width is not a multiple of 16 (copied into aligned rows)
    and a length past the row, which reads as the row's end."""
    lanes = _lanes((4, 8, 3), 4)
    xs = encode.precompute(torch.from_numpy(lanes).to(dev)).t().contiguous()
    out, lens = ef.encode_fused(xs, None, encode.outcap(xs.shape[0]))
    width = int(lens.max()) - 5
    d = out[:, :width]
    ln = lens.clone()
    ln[0] = width + 100
    planes, err = dk.decode(d, ln, 4, 8, 3, None)
    planes_p, err_p = dk.decode_plain(d, ln, 4, 8, 3, None)
    assert torch.equal(err, err_p) and torch.equal(planes, planes_p)
    with pytest.raises(ValueError, match="multiple of 4"):
        ef.encode_fused(xs, None, 1026)


@pytest.mark.parametrize("shape", [(4, 16, 3), (7, 5, 1), (1, 40, 4),
                                   (20, 1, 3)])
@pytest.mark.parametrize("primed", [False, True])
def test_sort_kernels_equal_plain(dev, shape, primed):
    """Kernels 3 and 4 on the sort chain's own inputs for these lanes."""
    init = encode._start_table(primed, None)
    h, diff = encode._hash_diff(torch.from_numpy(_lanes(shape)).to(dev), REV2)
    _, sym_max, quad_max = encode.stage_count(diff)
    K = encode.slots_per_symbol(sym_max)
    xs, origsym = encode.stage_sym_sort(h, diff, h.shape[1])
    before = ek.walk_symbols.launches
    lo, hi = ek.walk_symbols(xs, K, init)
    assert ek.walk_symbols.launches == before + 1
    lo_p, hi_p = ek.walk_symbols_plain(xs, K, init)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
    qlo, qhi = encode.stage_compact(lo, hi, origsym, K, quad_max)
    before = ek.coder_scan_off_q.launches
    kp, fin = ek.coder_scan_off_q(qlo, qhi)
    assert ek.coder_scan_off_q.launches == before + 1
    kp_p, fin_p = ek.coder_scan_off_q_plain(qlo, qhi)
    assert torch.equal(kp, kp_p) and torch.equal(fin, fin_p)


@pytest.mark.parametrize("K", [4, 8, 24])
def test_walk_kernel_equal_plain_on_random_symbols(dev, K):
    """Every field at random, decisions cut at K, a seeded reset table and a
    ragged last block of lanes."""
    rng = np.random.default_rng(K)
    n, S = 48, 100
    xs = (rng.integers(0, 128, (n, S)) << 14 | rng.integers(0, 2, (n, S)) << 13
          | (rng.random((n, S)) < 0.3).astype(np.int64) << 12
          | rng.integers(1274 - 300, 1274 + 301, (n, S)))
    xs = torch.from_numpy(xs.astype(np.int32)).to(dev)
    init = rng.integers(0, 128, (121, 8)).astype(np.uint8)
    lo, hi = ek.walk_symbols(xs, K, init)
    lo_p, hi_p = ek.walk_symbols_plain(xs, K, init)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


def test_coder_kernel_equal_plain_on_skewed_bits(dev):
    """Skewed bits make long deferred runs and carries."""
    rng = np.random.default_rng(1)
    Tq, S = 1500, 70
    p1 = np.where(np.arange(S) % 2 == 0, 0.97, 0.5)
    recs = ((rng.random((4 * Tq, S)) < 0.9).astype(np.int64) << 9
            | (rng.random((4 * Tq, S)) < p1).astype(np.int64) << 8
            | rng.integers(7, 248, (4 * Tq, S))).reshape(Tq, 2, 2, S)
    qlo = torch.from_numpy((recs[:, 0, 0] | recs[:, 0, 1] << 10)
                           .astype(np.int32)).to(dev)
    qhi = torch.from_numpy((recs[:, 1, 0] | recs[:, 1, 1] << 10)
                           .astype(np.int32)).to(dev)
    kp, fin = ek.coder_scan_off_q(qlo, qhi)
    kp_p, fin_p = ek.coder_scan_off_q_plain(qlo, qhi)
    assert torch.equal(kp, kp_p) and torch.equal(fin, fin_p)
    assert bool(((kp != coder.KP_SILENT) & ((kp & 0x100) != 0)).any())


@pytest.mark.parametrize("mode", ["unprimed", "primed", "seeded"])
def test_sort_engine_cuda_bytes_equal_cpu_and_fused(dev, mode):
    lanes = _lanes((6, 16, 3), 6)
    kw = {"primed": mode == "primed",
          "seed": seed.derive(lanes[0], device=dev) if mode == "seeded"
          else None}
    walks, coders = ek.walk_symbols.launches, ek.coder_scan_off_q.launches
    fused = ef.encode_fused.launches
    got = encode.encode_lanes(lanes, device="cuda", engine="sort", **kw)
    assert ek.walk_symbols.launches == walks + 1
    assert ek.coder_scan_off_q.launches == coders + 1
    assert ef.encode_fused.launches == fused
    assert got == encode.encode_lanes(lanes, device="cpu", engine="sort", **kw)
    assert got == encode.encode_lanes(lanes, device="cuda", **kw)


@pytest.mark.parametrize("shape", [(4, 16, 3), (7, 5, 1), (1, 40, 4),
                                   (20, 1, 3)])
def test_decision_kernels_equal_plain(dev, shape):
    """Kernels 5-8 on the decision variant's own inputs for these lanes."""
    h, diff = encode._hash_diff(torch.from_numpy(_lanes(shape)).to(dev), REV2)
    total, sym_max, _ = encode.stage_count(diff)
    K = encode.decision_slots(sym_max)
    n = h.shape[1]
    counts = [k.launches for k in (ek.build_stream, ek.walk_probs,
                                   ek.coder_scan_off, ek.coder_scan)]
    stream = ek.build_stream(h, diff, n, K)
    assert torch.equal(stream, ek.build_stream_plain(h, diff, n, K))
    skey, spay = encode.stage_fwd_sort(stream, total)
    xs = encode.stage_walk_xs(skey, spay)
    probs = ek.walk_probs(xs)
    assert torch.equal(probs, ek.walk_probs_plain(xs))
    cx = encode.stage_back_sort(skey, spay, probs)
    kp, fin = ek.coder_scan_off(cx)
    kp_p, fin_p = ek.coder_scan_off_plain(cx)
    assert torch.equal(kp, kp_p) and torch.equal(fin, fin_p)
    meta, runs, fin4 = ek.coder_scan(cx)
    meta_p, runs_p, fin4_p = ek.coder_scan_plain(cx)
    assert torch.equal(meta, meta_p) and torch.equal(runs, runs_p)
    assert torch.equal(fin4, fin4_p)
    assert [k.launches for k in (ek.build_stream, ek.walk_probs,
                                 ek.coder_scan_off, ek.coder_scan)] \
        == [c + 1 for c in counts]


@pytest.mark.parametrize("S", WALK_LANES)
@pytest.mark.parametrize("name", ["walk_symbols", "walk_probs"])
def test_walk_kernels_equal_plain_on_seg_patterns(dev, name, S):
    """Kernels 3 and 6 against their plain versions on the synthetic seg
    patterns (``chip_smoke.seg_cases``: a seg on every entry, on entry 0
    only, on none, runs across chunks, a seg on every chunk start, random
    runs before a one-run tail; kernel 3 with dead symbols and primed or
    seeded reset rows) at T of C - 1, C, C + 1 and 5C + 3 (C the shipped
    chunk count) and ragged lane counts, every launch counted."""
    wrapper = getattr(ek, name)
    for T in walk_steps(build.constant(name, "kChunks")):
        before = wrapper.launches
        errs = walk_case_errs(torch, name, T, S, dev)
        assert wrapper.launches == before + len(errs)
        assert errs == dict.fromkeys(errs, 0), (T, errs)


@pytest.mark.parametrize("K", [1, 8, 24])
def test_build_kernel_equal_plain_on_random_symbols(dev, K):
    """Residuals up to +-4095 (the exponent's 11-bit clip), padding symbols
    past n_sym, and a lane count off the warp size."""
    rng = np.random.default_rng(K)
    S, n_pad, n_sym = 37, 50, 44
    h = torch.from_numpy(rng.integers(0, 8000, (S, n_pad), dtype=np.int32))
    d = torch.from_numpy(rng.integers(-4095, 4096, (S, n_pad), dtype=np.int32))
    d[:, ::7] = 0
    got = ek.build_stream(h.to(dev), d.to(dev), n_sym, K)
    assert torch.equal(got.cpu(), ek.build_stream_plain(h, d, n_sym, K))


@pytest.mark.parametrize("live", ["cut", "none", "all"])
@pytest.mark.parametrize("S", [1, 37, 1101])
@pytest.mark.parametrize("K", [1, 3, 8, 12, 16, 24, 25])
def test_build_kernel_equal_plain_on_tiles(dev, K, S, live):
    """Kernel 5 against its plain version: its K 8, 16 and 24
    instantiations and the generic one (16-byte stores at K 12, scalar at
    K 1, 3 and 25); 200 symbols a lane, off the 128-symbol tile; n_sym
    ending inside the second tile, every symbol dead, every symbol live;
    residuals at the exponent's edges; one launch counted."""
    rng = np.random.default_rng(K * S)
    n_pad = 200
    n_sym = {"cut": 150, "none": 0, "all": n_pad}[live]
    h = torch.from_numpy(rng.integers(0, 8000, (S, n_pad), dtype=np.int32))
    d = torch.from_numpy(rng.choice(EDGE_RESIDUALS, (S, n_pad)))
    before = ek.build_stream.launches
    got = ek.build_stream(h.to(dev), d.to(dev), n_sym, K)
    assert ek.build_stream.launches == before + 1
    assert torch.equal(got.cpu(), ek.build_stream_plain(h, d, n_sym, K))


def test_build_kernel_takes_more_lanes_than_a_grid_row(dev):
    """70,000 lanes, past the 65,535 blocks of a grid's second dimension:
    the grid is one dimension of lanes x tiles."""
    rng = np.random.default_rng(70)
    h = torch.from_numpy(rng.integers(0, 8000, (70_000, 3), dtype=np.int32))
    d = torch.from_numpy(rng.choice(EDGE_RESIDUALS, (70_000, 3)))
    got = ek.build_stream(h.to(dev), d.to(dev), 2, 8)
    assert torch.equal(got.cpu(), ek.build_stream_plain(h, d, 2, 8))


@functools.lru_cache(maxsize=None)
def _copy(source: str, tag: str):
    """The copy ``tag`` of ``csrc/<source>.cu`` (``chip_smoke.VARIANTS``),
    built once."""
    return build_variant((source, tag))[0]


def _under(source: str, tag: str):
    return (contextlib.nullcontext() if tag == "shipped"
            else running(source, _copy(source, tag)))


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("T", [1, 2, 33])
@pytest.mark.parametrize("lanes", [1, 33, 127, 129, 1024])
@pytest.mark.parametrize("copy", ["shipped",
                                  *(f"cluster {c}" for c in PH_CLUSTERS)])
def test_pH_equals_plain_at_every_cluster_size(dev, copy, lanes, T, window):
    """pH, shipped and at each cluster size (``chip_smoke``'s copies),
    against ``pH_stage_plain`` at lane counts around the partitions of
    the lanes over a cluster (blocks with no live lane among them), a
    300-row plane of random words: output and plane exact, one launch
    counted."""
    p = PROBES["pHw"]
    a = p.make(lanes, lanes, 300, dev)
    a.update(T=T, window=window)
    rng = np.random.default_rng(lanes + T)
    a["model"] = torch.from_numpy(rng.integers(
        -2**31, 2**31, a["model"].shape, dtype=np.int32)).to(dev)
    ref = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in a.items()}
    before = mosaic3.pH_stage.launches
    with _under("probe_mosaic3", copy):
        out = mosaic3.pH_stage(**a)
    assert mosaic3.pH_stage.launches == before + 1
    assert torch.equal(out, p.plain(**ref))
    assert torch.equal(a["model"], ref["model"])


def test_walk_and_coders_equal_plain_on_random_records(dev):
    """Random walk inputs (seg at random) and coder records with skewed
    bits: long deferred runs and carries; slot records expand to the
    offset coder's bytes."""
    rng = np.random.default_rng(2)
    T, S = 3000, 70
    xs = (rng.integers(0, 2, (T, S)) | (rng.random((T, S)) < 0.1) << 1)
    xs = torch.from_numpy(xs.astype(np.int32)).to(dev)
    assert torch.equal(ek.walk_probs(xs), ek.walk_probs_plain(xs))
    p1 = np.where(np.arange(S) % 2 == 0, 0.97, 0.5)
    recs = ((rng.random((T, S)) < 0.9).astype(np.int64) << 9
            | (rng.random((T, S)) < p1).astype(np.int64) << 8
            | rng.integers(7, 248, (T, S)))
    cx = torch.from_numpy(recs.astype(np.int32)).to(dev)
    kp, fin = ek.coder_scan_off(cx)
    kp_p, fin_p = ek.coder_scan_off_plain(cx)
    assert torch.equal(kp, kp_p) and torch.equal(fin, fin_p)
    assert bool(((kp != coder.KP_SILENT) & ((kp & 0x100) != 0)).any())
    meta, runs, fin4 = ek.coder_scan(cx)
    meta_p, runs_p, fin4_p = ek.coder_scan_plain(cx)
    assert torch.equal(meta, meta_p) and torch.equal(runs, runs_p)
    assert torch.equal(fin4, fin4_p)
    kp_fin, lens = coder.finish_steps_off(fin)
    want = coder.expand_kp(kp, kp_fin, int(lens.max()))
    mf, rf = coder.finish_steps(fin4)
    got, lens2 = coder.expand_slots(torch.cat([meta, mf]),
                                    torch.cat([runs, rf]),
                                    outcap=int(lens.max()))
    assert torch.equal(lens2, lens) and torch.equal(got, want)


def _coder_equals_plain(name: str, args, dev) -> tuple:
    """Coder ``name`` (a key of ``CODERS``) on the card against its plain
    version on the CPU, on the int32 arrays ``args``: every output equal;
    -> the plain outputs."""
    kernel, plain = getattr(ek, name), getattr(ek, f"{name}_plain")
    cpu = tuple(torch.from_numpy(a) for a in args)
    before = kernel.launches
    got = kernel(*(a.to(dev) for a in cpu))
    assert kernel.launches == before + 1
    want = plain(*cpu)
    assert len(got) == len(want)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    return want


@pytest.mark.parametrize("name", list(CODERS))
@pytest.mark.parametrize("S", [1, 33, 130, 1101])
@pytest.mark.parametrize("steps", ["1", "D-1", "D+1", "5D+3", "B-1", "B+1"])
def test_coder_off_kernel_equal_plain_on_ragged_T(dev, name, steps, S):
    """Kernels 4, 7 and 8 on T rows around their ring depth D (T = 1 and D
    - 1 below it, D + 1 and 5D + 3 off every multiple of it; kernel 4's
    rows are quads of records) and around the hand-over of B rows between
    the split coders' warps, ragged lane counts."""
    D, per = coder_depth(name), CODERS[name][1]
    B = build.constant("coder_scan", "kBatch") // per
    T = {"1": 1, "D-1": max(D - 1, 1), "D+1": D + 1, "5D+3": 5 * D + 3,
         "B-1": max(B - 1, 1), "B+1": B + 1}[steps]
    recs = skewed_recs(T * per, S, seed=T + S)
    _coder_equals_plain(name, pack_quads(recs) if per == 4
                        else (recs.astype(np.int32),), dev)


@pytest.mark.parametrize("name", list(CODERS))
@pytest.mark.parametrize("case", ["0xFF runs", "dead lanes and tails"])
def test_coder_off_kernel_equal_plain_on_runs_and_dead_lanes(dev, name,
                                                              case):
    """Deferred runs of 0xFF bytes past a hundred, resolved by carries and
    emits; lanes all dead (no byte, the start state in fin) and a dead
    tail of a different length in every lane (inside a quad for kernel
    4)."""
    want = _coder_equals_plain(name, coder_cases(name)[case], dev)
    if case == "0xFF runs":
        recs = off_record_cases(coder_depth(name))[case]
        _, runs, _ = ek.coder_scan_plain(torch.from_numpy(
            recs.astype(np.int32)))
        assert (runs > 100).any()
    else:
        fin = want[-1]
        start = torch.tensor([0, 0xFF00, -1, 0, 0][:len(fin)],
                             dtype=torch.int32)
        assert (fin[:, :10].T == start).all()
        if name != "coder_scan":
            assert (want[0][:, :10] == coder.KP_SILENT).all()


def test_decision_variant_cuda_bytes_equal_cpu_and_fused(dev):
    lanes = _lanes((6, 16, 3), 6)
    before = {k: k.launches for k in (ek.build_stream, ek.walk_probs,
                                      ek.coder_scan_off, ek.walk_symbols,
                                      ek.coder_scan_off_q, ef.encode_fused)}
    got = encode.encode_lanes(lanes, device="cuda", engine="sort",
                              variant="decision")
    moved = {k.__name__: k.launches - n for k, n in before.items()}
    assert moved == {"build_stream": 1, "walk_probs": 1, "coder_scan_off": 1,
                     "walk_symbols": 0, "coder_scan_off_q": 0,
                     "encode_fused": 0}
    assert got == encode.encode_lanes(lanes, device="cpu", engine="sort",
                                      variant="decision")
    assert got == encode.encode_lanes(lanes, device="cuda")


def test_api_cuda_bytes_equal_cpu(dev):
    img = _lanes((24, 16, 3), 1)[0]
    blob = api.compress(img, slices="auto", device="cuda")
    assert blob == api.compress(img, slices="auto", device="cpu")
    np.testing.assert_array_equal(api.decompress(blob, device="cuda"), img)


@pytest.mark.parametrize("key", list(PROBES))
def test_probe_kernel_equals_plain(dev, key):
    """Each probe at the TPU probes' shape (128 lanes, a 15,872-row plane
    of random words, its own T): outputs and planes exact, on a case that
    tells (the output differs across lanes or a plane changes), one launch
    counted."""
    p = PROBES[key]
    before = p.fn.launches
    r = probes.run_probe(p, dev, reps=0)
    assert r["err"] == 0 and p.fn.launches == before + 1 and r["telling"]


@pytest.mark.parametrize("key", ["p7", "p8", "p11", "pF", "pHw", "pHn"])
def test_staging_probes_equal_plain_on_random_planes(dev, key):
    """Planes of random words over the whole int32 range (wrapping sums),
    100 lanes (a ragged warp), a 300-row plane so that rows repeat."""
    p = PROBES[key]
    a = p.make(3, 100, 300, dev)
    a["T"] = 64
    rng = np.random.default_rng(len(key))
    a["model"] = torch.from_numpy(rng.integers(
        -2**31, 2**31, a["model"].shape, dtype=np.int32)).to(dev)
    ref = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in a.items()}
    assert torch.equal(p.fn(**a), p.plain(**ref))
    assert torch.equal(a["model"], ref["model"])


# the source of each stepped probe's kernel, and the ring depth constant
# of p7, p8 and pF
STEPPED = {"p7": ("probe_mosaic", "kRowDepth"),
           "p8": ("probe_mosaic", "kStageDepth"),
           "pF": ("probe_mosaic2", "kPairDepth")}


def _stepped_equals_plain(dev, key: str, idx: np.ndarray, rows: int, T: int,
                          copy: str = "shipped") -> None:
    """Stepped probe ``key`` (p7, p8 or pF; shipped, or its copy ``copy``)
    on ``idx`` [1, lanes] and its planes of ``rows`` rows of random words
    against its plain version: output and planes exact, one launch
    counted."""
    p = PROBES[key]
    rng = np.random.default_rng(rows + T + idx.shape[1])
    shape = ((2,) if key == "p7" else ()) + (rows, idx.shape[1])
    model = torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                          dtype=np.int32))
    ref = model.clone()
    model = model.to(dev)
    before = p.fn.launches
    with _under(STEPPED[key][0], copy):
        out = p.fn(idx=torch.from_numpy(idx).to(dev), T=T, model=model)
    assert p.fn.launches == before + 1
    want = p.plain(idx=torch.from_numpy(idx), T=T, model=ref)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(model.cpu(), ref)


@pytest.mark.parametrize("rows", [2, 3, 17, 15872])
def test_p7_equals_plain_where_rows_repeat(dev, rows):
    """p7's row ring where a pending row is stored again: planes of 2, 3
    and 17 rows (rows repeat within any ring depth), and the full plane
    with the lanes whose every step lands on row 7110 (x = 7110 and 7110 +
    15,871: x + 40503 is a multiple of 15,871), 64 steps."""
    idx = np.random.default_rng(rows).integers(0, 2**31, (1, 128),
                                                dtype=np.int32)
    if rows == 15872:
        idx[0, ::3], idx[0, 1::3] = 7110, 7110 + 15871
    _stepped_equals_plain(dev, "p7", idx, rows, 64)


@pytest.mark.parametrize("lanes", [1, 31, 33, 128, 1024])
@pytest.mark.parametrize("steps", ["0", "1", "D-1", "D", "D+1", "512"])
def test_p7_equals_plain_around_the_ring_depth(dev, steps, lanes):
    """p7 at T around its row ring's depth D (``kRowDepth``: the ring
    part full, full, and one past it) and at the probe's 512, a 17-row
    plane, at lane counts around a warp."""
    D = build.constant("probe_mosaic", "kRowDepth")
    T = (D + {"D-1": -1, "D": 0, "D+1": 1}[steps] if steps[0] == "D"
         else int(steps))
    idx = np.random.default_rng(lanes).integers(0, 2**31, (1, lanes),
                                                dtype=np.int32)
    _stepped_equals_plain(dev, "p7", idx, 17, T)


HAZARDS = {"p8": {name: case for name, *case
                  in p7_hazard_cases(STAGE_DEPTHS)},
           "pF": {name: case for name, *case in pF_hazard_cases()}}


@pytest.mark.parametrize("copy, key, case", [
    (copy, key, case) for key, cases in HAZARDS.items()
    for copy in ("shipped", *PROBE_TAGS[key]) for case in cases])
def test_staging_rings_equal_plain_where_rows_repeat(dev, key, case, copy):
    """p8 and pF, shipped and each copy (the serial step they replaced,
    other ring depths, p8's rows stepped by additions, pF on the split
    step), on their hazard cases: p8 on p7's (the 7110 lanes, planes of 2,
    3 and 17 rows, T around each of its ring depths), pF on
    ``chip_smoke.pF_hazard_cases`` (the 7107 lanes on pair 14,214 at
    every step, planes of 4, 6 and 36 rows, T around each depth), planes
    of random words: output and planes exact, one launch counted."""
    idx, rows, T = HAZARDS[key][case]
    _stepped_equals_plain(dev, key, idx, rows, T, copy)


@pytest.mark.parametrize("lanes", [33, 128])
@pytest.mark.parametrize("steps", ["0", "1", "D-1", "D", "D+1", "T"])
@pytest.mark.parametrize("key", ["p8", "pF"])
def test_staging_rings_equal_plain_around_the_ring_depth(dev, key, steps,
                                                         lanes):
    """p8 and pF at T around their ring's depth D (``kStageDepth``,
    ``kPairDepth``: the ring part full, full, and one past it) and at the
    probe's own T, on a plane where rows repeat (17 rows for p8, 36 for
    pF), at 33 and 128 lanes."""
    src, const = STEPPED[key]
    D = build.constant(src, const)
    T = (D + {"D-1": -1, "D": 0, "D+1": 1}[steps] if steps[0] == "D"
         else PROBES[key].T if steps == "T" else int(steps))
    idx = np.random.default_rng(lanes + T).integers(0, 2**31, (1, lanes),
                                                    dtype=np.int32)
    _stepped_equals_plain(dev, key, idx, 17 if key == "p8" else 36, T)


@pytest.mark.parametrize("lanes", [1, 33, 1024])
@pytest.mark.parametrize("T", [0, 1, 2, 512])
def test_p9_equals_plain_at_the_byte_edges(dev, T, lanes):
    """p9 on idx bytes 0xFF (the byte's step wraps to 0) and 0x00 and idx
    past 255 (only its low byte is read), then random words: output
    exact, one launch counted."""
    idx = torch.from_numpy(p9_hazard_idx(lanes))
    before = mosaic.p9_decision_only_cost.launches
    out = mosaic.p9_decision_only_cost(idx.to(dev), T)
    assert mosaic.p9_decision_only_cost.launches == before + 1
    assert torch.equal(out.cpu(), mosaic.p9_decision_only_cost_plain(idx, T))


@pytest.mark.parametrize("copy", ["shipped", *PROBE_TAGS["p10"]])
@pytest.mark.parametrize("lanes", [1, 33, 1024])
@pytest.mark.parametrize("T", [0, 1, 2, 512])
def test_p10_equals_plain_at_the_byte_edges(dev, T, lanes, copy):
    """p10, shipped and each copy (the serial step it replaced, the two
    steps not taken), on idx bytes 0xFF (the byte's step wraps to 0) and
    0x00 and idx past 255 (only its low byte is read), then random words:
    output exact, one launch counted."""
    idx = torch.from_numpy(p9_hazard_idx(lanes))
    before = mosaic.p10_decision_unrolled.launches
    with _under("probe_mosaic", copy):
        out = mosaic.p10_decision_unrolled(idx.to(dev), T)
    assert mosaic.p10_decision_unrolled.launches == before + 1
    assert torch.equal(out.cpu(), mosaic.p10_decision_unrolled_plain(idx, T))


@pytest.mark.parametrize("copy", ["shipped", *REDUCE_TAGS])
def test_reduce_equals_plain_on_every_case(dev, copy):
    """The reduce probe, shipped and each copy (a maximum on every slice,
    the design it replaced; one warp for the tile), on every
    ``chip_smoke.reduce_cases`` input (flushes at gaps of 4, of 5 and
    more, and none; rows past a multiple of 32; 1, 33 and 128 lanes;
    negative words): output exact, one launch a case counted."""
    for name, x in reduce_cases():
        x = torch.from_numpy(x)
        before = reduce.run.launches
        with _under("probe_reduce", copy):
            out = reduce.run(x.to(dev))
        assert reduce.run.launches == before + 1, name
        assert torch.equal(out.cpu(), reduce.run_plain(x)), name


P11_CASES = {name: case for name, *case in p11_cases()}


@pytest.mark.parametrize("copy", ["shipped", *P11_TAGS])
@pytest.mark.parametrize("case", list(P11_CASES))
def test_p11_equals_plain_on_every_case(dev, case, copy):
    """p11, shipped (a warp a staged lane) and each copy (the serial
    design it replaced, the register ring a lane), on
    ``chip_smoke.p11_cases`` (nstage -1, 0, 1, 8, 9, 33 and past the
    lanes; T 0, 1, 31, 32, 33 and 512; planes of 2, 3 and 300 rows of
    random words, idx over int32; 100, 128 and 1,024 lanes): output and
    plane exact, one launch counted."""
    lanes, rows, T, nstage = P11_CASES[case]
    idx, plane = p11_inputs(case, lanes, rows)
    model = torch.from_numpy(plane).to(dev)
    before = mosaic.p11_stage_few.launches
    with _under("probe_mosaic", copy):
        out = mosaic.p11_stage_few(torch.from_numpy(idx).to(dev), T, nstage,
                                   model)
    assert mosaic.p11_stage_few.launches == before + 1
    want = mosaic.p11_stage_few_plain(torch.from_numpy(idx), T, nstage,
                                      torch.from_numpy(plane.copy()))
    assert torch.equal(out.cpu(), want)
    assert torch.equal(model.cpu(), torch.from_numpy(plane))


PG_CASES = {name: (x, off) for name, x, off in pG_cases()}


@pytest.mark.parametrize("copy", ["shipped", *PG_TAGS])
@pytest.mark.parametrize("case", list(PG_CASES))
def test_pG_equals_plain_on_every_case(dev, case, copy):
    """pG, shipped (one warp of 16-byte loads up to 1,024 words) and each
    copy (one block of one word a thread, the design it replaced; 8 warps
    of one int4 a thread), on ``chip_smoke.pG_cases`` (maxima of exactly
    100 and 101, in the last word, in the first, INT32_MAX + 1 and
    INT32_MIN - 1; n of 1, 3, 1,024, 1,027 and 8,192 words; x 0, 1 and 3
    words past a 16-byte boundary, out at the same offset): output exact,
    one launch counted."""
    x, off = PG_CASES[case]
    xd = at_offset(torch, x, off)
    assert xd.data_ptr() % 16 == 4 * off
    before = mosaic3.pG_scalar_gate.launches
    with _under("probe_mosaic3", copy):
        out = mosaic3.pG_scalar_gate(xd)
    assert mosaic3.pG_scalar_gate.launches == before + 1
    assert out.data_ptr() % 16 == xd.data_ptr() % 16
    assert torch.equal(out.cpu(),
                       mosaic3.pG_scalar_gate_plain(torch.from_numpy(x)))


@pytest.mark.parametrize("n", list(PG_WORDS))
def test_pG_refuses_x_and_out_apart_mod_16(dev, n):
    """pG's entry point with x one word past a 16-byte boundary and out on
    one (no head brings both to a boundary) launches nothing and returns
    an error, which ``launch`` raises; out is left as it was."""
    x = np.random.default_rng(n).integers(-2**31, 2**31, PG_WORDS[n],
                                          dtype=np.int32)
    xd = at_offset(torch, x, 1)
    out = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    assert out.data_ptr() % 16 == 0
    with pytest.raises(RuntimeError, match="llct_probe_pG"):
        probes.launch(mosaic3.SRC, "llct_probe_pG", xd, out, n)
    assert not out.any()


@pytest.mark.parametrize("lanes", [1, 33, 130])
@pytest.mark.parametrize("key", ["p3", "pC"])
def test_row_store_equals_plain_on_random_planes(dev, key, lanes):
    """The row store on planes of random words: over eight calls every lane
    stores into each of its 8 rows once (lanes take different rows in a
    call); out and the whole plane exact, one word a lane changed."""
    p = PROBES[key]
    rng = np.random.default_rng(lanes)
    model = torch.from_numpy(rng.integers(-2**31, 2**31, (40, lanes),
                                          dtype=np.int32))
    ref = model.clone()
    model = model.to(dev)
    for r in range(8):
        idx = torch.from_numpy(
            (8 * rng.integers(0, 1 << 20, (1, lanes))
             + (r + np.arange(lanes)) % 8).astype(np.int32))
        val = torch.from_numpy(rng.integers(-2**31, 2**31, (1, lanes),
                                            dtype=np.int32))
        before = ref.clone()
        out = p.fn(idx=idx.to(dev), val=val.to(dev), model=model)
        want = p.plain(idx=idx, val=val, model=ref)
        assert torch.equal(out.cpu(), want)
        assert torch.equal(model.cpu(), ref)
        assert int((ref != before).sum()) <= lanes


PIPE_SHAPES = [(4, 16, 3), (7, 5, 1), (1, 40, 4), (20, 1, 3), (3, 9, 2)]


@pytest.mark.parametrize("n_batches", [1, 2, 3, 5])
@pytest.mark.parametrize("max_inflight", [1, 2, 4])
def test_pipelined_equals_encode_lanes(dev, monkeypatch, n_batches,
                                       max_inflight):
    """Each batch's streams equal encode_lanes on it, with the batches (of
    other shapes and lane counts) cut into pieces of at most 3 lanes."""
    batches = [np.concatenate([_lanes(shape), _lanes(shape)[: i + 1]])
               for i, shape in enumerate(PIPE_SHAPES[:n_batches])]
    tab = seed.derive(make_image(64, 64, 3, 5), device=dev)
    for kw in ({"primed": True}, {"seed": tab}, {}):
        want = [encode.encode_lanes(b, device=dev, **kw) for b in batches]
        assert want == [encode.encode_lanes(b, device=dev, engine="sort",
                                            **kw) for b in batches]
        before = ef.encode_fused.launches
        got = encode.encode_lanes_pipelined(batches, device=dev,
                                            max_inflight=max_inflight, **kw)
        assert got == want
        assert ef.encode_fused.launches == before + n_batches
        monkeypatch.setattr(encode, "LANE_BUDGET_BYTES", 3 * encode.lane_bytes(
            max(int(np.prod(s)) for s in PIPE_SHAPES), "fused"))
        assert encode.encode_lanes_pipelined(
            batches, device=dev, max_inflight=max_inflight, **kw) == want
        monkeypatch.undo()


@pytest.mark.parametrize("max_inflight", [1, 2])
@pytest.mark.parametrize("seeded", [False, True])
def test_lanes_past_their_row_are_coded_again_in_place(dev, monkeypatch,
                                                       max_inflight, seeded):
    """Noise lanes whose streams pass their outcap row, among photo lanes:
    kernel 1 flags them and counts their lengths; every lane loop on the card
    (pieces of at most 3 lanes in flight, two shards on the card,
    fused_tensors) gives the native runtime's streams."""
    lanes = overflow_batches()[MIXED][:24]
    init = OVERFLOW_SEED if seeded else None
    xs = encode._fused_input(torch.from_numpy(lanes).to(dev), REV2)
    _, lens, ovf = ef.encode_fused_async(xs, init, encode.outcap(xs.shape[0]))
    want = host.encode_images(lanes, seed=init)
    assert ovf.any() and not ovf.all()
    assert lens.tolist() == [len(w) for w in want]
    assert encode.encode_lanes(lanes, seed=init, device=dev) == want
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES",
                        3 * encode.lane_bytes(lanes[0].size, "fused"))
    assert encode.encode_lanes_pipelined(
        [lanes, lanes[::-1]], seed=init, device=dev,
        max_inflight=max_inflight) == [want, want[::-1]]
    monkeypatch.undo()
    assert parallel.encode_lanes_sharded(lanes, [dev, dev], seed=init) == want
    out, n = encode.fused_tensors(torch.from_numpy(lanes).to(dev), REV2, init)
    assert [out[s, : n[s]].cpu().numpy().tobytes()
            for s in range(len(lanes))] == want


@pytest.mark.parametrize("tile_w", [0, 10])
def test_reencode_slice_on_the_card_equals_the_cpu(dev, tile_w):
    img = make_image(16, 24, 3, 8)
    blob = api.compress(img, slices="auto", tile_w=tile_w, device="cpu")
    streams, W, H, C, sh, flags, _, tw = container.unpack_sliced(blob)
    k = len(streams) - 2
    broken = _flip_slice(blob, streams, k)
    assert api.decompress(broken, strict=False, device=dev)[1] == [k]
    y0, y1, x0, x1 = container.tile_regions(W, H, sh, tw)[k]
    before = ef.encode_fused.launches
    healed = api.reencode_slice(broken, k, img[y0:y1, x0:x1], device=dev)
    assert ef.encode_fused.launches == before + 1
    assert healed == blob == api.reencode_slice(broken, k,
                                                img[y0:y1, x0:x1],
                                                device="cpu")


def test_corpus_round_trip_on_the_card(dev):
    imgs = [make_image(16, 16, 3, 1), make_image(24, 16, 3, 2),
            make_image(13, 16, 3, 3), make_image(8, 8, 4, 4),
            make_image(8, 8, 1, 5)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8,
                                          max_lanes_per_batch=3, device=dev)
    assert stats.batches >= 4
    native, _ = corpus.compress_corpus(imgs, slice_h=8, max_lanes_per_batch=3,
                                       backend="native")
    assert blobs == native
    for a, b in zip(corpus.decompress_corpus(blobs, device=dev), imgs):
        np.testing.assert_array_equal(a, b)


def test_kernel_launches_lie_inside_their_stage_spans(dev, tmp_path):
    """One ``trace_to`` trace of a ``decompress_corpus`` and a
    ``compress_corpus``: every launch of kernels 1 and 2 (the host's launch
    call, joined to the kernel by its correlation id) lies inside an
    ``encode/fused_kernel`` or ``decode/kernel`` span, so the program's
    host spans and the device's events share one clock."""
    imgs = [make_image(16, 16, 3, 1), make_image(24, 16, 3, 2),
            make_image(13, 16, 3, 3)]
    blobs, _ = corpus.compress_corpus(imgs, slice_h=8, device=dev)
    corpus.decompress_corpus(blobs, device=dev)        # kernels built
    with profiling.trace_to(tmp_path) as path:
        outs = corpus.decompress_corpus(blobs, device=dev)
        again, _ = corpus.compress_corpus(imgs, slice_h=8, device=dev)
    assert again == blobs
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    ours = re.compile(r"\b(encode_fused_kernel|decode_kernel)\b")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and ours.search(e["name"])]
    assert {ours.search(e["name"])[1] for e in kernels} == {
        "encode_fused_kernel", "decode_kernel"}
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e["name"] in ("encode/fused_kernel", "decode/kernel")]
    for k in kernels:
        call = launches[k["args"]["correlation"]]
        assert any(a <= call["ts"] and call["ts"] + call["dur"] <= b
                   for a, b in spans), (k["name"], call["name"])


TWICE = ["cuda:0", "cuda:0"]


@pytest.mark.parametrize("start", ["unprimed", "primed", "seeded"])
def test_sharded_on_one_card_twice_equals_one_call(dev, start):
    """Two shards on cuda:0 (distinct side streams): the streams and pixels
    of one encode_lanes / decode_lanes call, one launch of kernels 1 and 2
    a shard, and a corrupt stream named by its global lane index."""
    lanes = np.concatenate([_lanes((8, 24, 3), n=40), _lanes((8, 24, 3))])
    kw = {"unprimed": {}, "primed": {"primed": True},
          "seeded": {"seed": seed.derive(make_image(64, 64, 3, 6),
                                         device=dev)}}[start]
    want = encode.encode_lanes(lanes, device=dev, **kw)
    e0, d0 = ef.encode_fused.launches, dk.decode.launches
    got = parallel.encode_lanes_sharded(lanes, TWICE, **kw)
    assert got == want and ef.encode_fused.launches == e0 + 2
    out = parallel.decode_lanes_sharded(got, (8, 24, 3), TWICE, **kw)
    np.testing.assert_array_equal(out, lanes)
    assert dk.decode.launches == d0 + 2
    if start == "unprimed":
        got[31] = _malicious_stream()
        with pytest.raises(ValueError, match=r"lanes \[31\]"):
            parallel.decode_lanes_sharded(got, (8, 24, 3), TWICE)


def test_sharded_shards_of_several_pieces_on_one_card_twice(dev,
                                                           monkeypatch):
    """Shards cut into pieces of 3 lanes (encode) and 1 lane (decode):
    several pieces of each shard in flight on distinct side streams, the
    streams and pixels of one call, one launch a piece."""
    lanes = np.concatenate([_lanes((8, 24, 3), n=40), _lanes((8, 24, 3))])
    want = encode.encode_lanes(lanes, device=dev)
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES",
                        3 * encode.lane_bytes(8 * 24 * 3, "fused"))
    monkeypatch.setattr(decode, "LANE_BUDGET_BYTES", 1)
    e0, d0 = ef.encode_fused.launches, dk.decode.launches
    got = parallel.encode_lanes_sharded(lanes, TWICE)
    assert got == want
    assert ef.encode_fused.launches == e0 + len(devmod.pieces(
        len(lanes), TWICE, 3))
    np.testing.assert_array_equal(
        parallel.decode_lanes_sharded(got, (8, 24, 3), TWICE), lanes)
    assert dk.decode.launches == d0 + len(lanes)


@pytest.mark.parametrize("slices", [8, "auto"])
def test_compress_sharded_on_the_card_equals_the_native_backend(dev, slices):
    img = make_image(96, 40, 3, 11)
    blob = parallel.compress_sharded(img, TWICE, slices=slices)
    if slices == "auto":
        assert container.unpack_sliced(blob)[4] == api.pick_slice_height(
            96, 40, 3, target_lanes=16)
    else:
        assert blob == api.compress(img, slices=slices, backend="native")
    np.testing.assert_array_equal(parallel.decompress_sharded(blob, TWICE),
                                  img)
    blobs, _ = corpus.compress_corpus([img, img[:40]], slice_h=8, mesh=TWICE)
    native, _ = corpus.compress_corpus([img, img[:40]], slice_h=8,
                                       backend="native", seeded=False)
    assert blobs == native


def test_dryrun_multichip_on_one_card_twice(dev):
    graft_entry.dryrun_multichip(2, mesh=TWICE)
    fn, args = graft_entry.entry(device="cuda")
    fn_c, args_c = graft_entry.entry(device="cpu")
    want, lens = fn_c(*args_c)
    out, n = fn(*args)
    assert torch.equal(n.cpu(), lens)
    for s in range(len(lens)):
        assert torch.equal(out[s, : lens[s]].cpu(), want[s, : lens[s]])


def test_sanitizer_child_on_kernels_1_and_2(dev):
    """``chip_smoke.py --sanitize-child`` on phase 3's runs of kernels 1
    and 2 (part 'codec', kernels 3 and 4 too): under compute-sanitizer's
    memcheck where it runs on this card, else under the guard allocator
    that stands in for it on global memory.  No error in the port's
    kernels, each output equal to its plain version, both kernels
    launched."""
    status = sanitizer_status()
    tool = ("guard" if status["version"] is None or status["refused"]
            else "memcheck")
    r = sanitize(tool, ("codec",))
    assert r["errors"] == 0, r
    assert r["launches"]["encode_fused"] and r["launches"]["decode_kernel"]


# p0 under the guard allocator, in a fresh process (the allocator is set
# before the first CUDA allocation): the shipped kernel, and copies built
# at run time (``chip_smoke.build_copy``) that write one word past out and
# that leave the cells off each lane's row unwritten
_GUARD_MUTANTS = """
import contextlib, ctypes, json
import torch
import chip_smoke as cs
so = cs.guard_library()
torch.cuda.memory.change_current_allocator(
    torch.cuda.memory.CUDAPluggableAllocator(
        str(so), "llct_guard_malloc", "llct_guard_free"))
g = ctypes.CDLL(str(so))
g.llct_guard_check.argtypes = [ctypes.c_char_p]
g.llct_guard_check.restype = ctypes.c_longlong
from llcomp_tpu_torch.probes import mosaic
stop = "  if (l >= lanes) return;\\n  const int32_t r = fmod_floor"
store = "  for (int i = 0; i < 64; ++i) out[i * n + l] = i == r ? r : 0;"
copies = {"past the end": [(stop, stop.replace(">=", ">"))],
          "unwritten": [(store, store.replace(
              "out[i * n + l] = i == r ? r : 0",
              "if (i == r) out[i * n + l] = r"))]}
idx = torch.randint(0, 1 << 30, (1, 33), dtype=torch.int32, device="cuda")
want = mosaic.p0_scalar_store_plain(idx.cpu())
res = {}
for tag in ("shipped", *copies):
    so = None if tag == "shipped" else cs.build_copy(
        "probe_mosaic", f"mutant {tag}", copies[tag])[0]
    with cs.running("probe_mosaic", so) if so else contextlib.nullcontext():
        out = mosaic.p0_scalar_store(idx)
    res[tag] = [g.llct_guard_check(tag.encode()),
                torch.equal(out.cpu(), want)]
print(json.dumps(res))
"""


def test_guard_allocator_tells_p0_copies_that_write_past_or_leave_out(dev):
    """The guard allocator (phase 11's stand-in for memcheck and
    initcheck): a copy of p0 that writes one word past out draws guard
    bytes at its launch; one that leaves cells unwritten draws none but
    returns the guard's fill there, so it differs from the plain version;
    the shipped p0 does neither."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _GUARD_MUTANTS], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(root)})
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["shipped"] == [0, True]
    assert res["past the end"][0] > 0 and "written past a block" in r.stderr
    assert res["unwritten"] == [0, False]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _all_kernels(dev) -> dict:
    """Kernels 1-8 and probe p7 on inputs on ``dev`` -> their outputs on the
    host, by kernel."""
    lanes = torch.from_numpy(_lanes((4, 16, 3), n=33)).to(dev)
    init = encode._start_table(True, None)
    made: dict = {}

    def keep(chain):
        def done(stage, *t):
            made[f"{chain} {stage}"] = [
                x.cpu() if isinstance(x, torch.Tensor) else x for x in t]
        return done

    xs = encode.precompute(lanes).t().contiguous()
    out, lens = ef.encode_fused(xs, init, encode.outcap(xs.shape[0]))
    made["k1"] = [out.cpu(), lens.cpu()]
    streams = [out[s, : lens[s]].cpu().numpy().tobytes()
               for s in range(len(lens))]
    data, n = decode._pack(streams)
    made["k2"] = [t.cpu() for t in dk.decode(
        torch.from_numpy(data).to(dev), torch.from_numpy(n).to(dev), 4, 16, 3,
        init)]
    encode._encode_sort(lanes, REV2, init, keep("k3-4"))
    encode._encode_decision(lanes, REV2, None, keep("k5-7"))
    made["k8"] = [t.cpu() for t in ek.coder_scan(
        made["k5-7 back sort"][0].to(dev))]
    p7 = PROBES["p7"]
    kw = {**p7.make(0, 128, probes.ROWS, dev), "T": 16}
    made["p7"] = [p7.fn(**kw).cpu(), kw["model"].cpu()]
    return made


def test_every_kernel_launches_on_its_tensors_device(two_cards):
    """Lanes on cuda:1 with cuda:0 current: kernels 1-8 and a probe give
    cuda:0's outputs (each launch runs under its tensors' device)."""
    d0, d1 = two_cards
    with torch.cuda.device(d0):
        want = _all_kernels(d0)
        got = _all_kernels(d1)
    assert got.keys() == want.keys()
    for k in want:
        for a, b in zip(got[k], want[k]):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), k
            else:
                assert a == b, k


@pytest.mark.parametrize("engine",
                         encode.ENGINES + tuple(encode.ENGINE_ALIASES))
def test_encode_engine_names_on_the_bench_batch(dev, engine):
    """``encode_lanes(imgs, REV2, engine)`` for each encode name, the JAX
    package's too, on the bench batch (1,024 lanes of 8x512x3, primed):
    the keyword spelling's streams, through the kernels that the alias
    table names."""
    lanes = bench_lanes(bench_images(100))
    port = encode.ENGINE_ALIASES.get(engine, engine)
    want = encode.encode_lanes(lanes, primed=True, device="cuda",
                               engine=port)
    before = (ef.encode_fused.launches, ek.walk_symbols.launches)
    assert encode.encode_lanes(lanes, REV2, engine, True) == want
    ran = (ef.encode_fused.launches - before[0],
           ek.walk_symbols.launches - before[1])
    assert (ran[0] > 0, ran[1] > 0) == (port == "fused", port == "sort")
