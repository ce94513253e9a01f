"""llcomp_tpu_torch.parallel on a list of CPU entries (the kernels' plain
versions, shard after shard) against llcomp_tpu.parallel on the 8-device
virtual CPU mesh, llcomp_tpu.oracle and llcomp_tpu.host: equal streams and
containers, exact pixels, the lanes' blocks and the corrupt lanes' global
indices; and corpus.compress_corpus(mesh=) against llcomp_tpu.corpus with
a mesh.  Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from chip_smoke import _malicious_stream
from llcomp_tpu import corpus as jcorpus
from llcomp_tpu import distributed as jdist
from llcomp_tpu import host as jhost
from llcomp_tpu import oracle
from llcomp_tpu import parallel as jpar
from llcomp_tpu import seed as jseed
from llcomp_tpu_torch import api, container, corpus, decode, encode, parallel
from llcomp_tpu_torch import device as devmod
from tests.conftest import make_photo

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jpar.make_mesh(8)


@pytest.mark.parametrize("S,shape", [(16, (8, 16, 3)), (11, (8, 8, 3))])
def test_sharded_encode_equals_the_oracle(S, shape):
    lanes = np.stack([make_photo(*shape, seed=i) for i in range(S)])
    got = parallel.encode_lanes_sharded(lanes, CPU8)
    assert got == [oracle.encode(lane)[6:] for lane in lanes]


def test_three_lanes_over_eight_devices():
    """Five of the eight shards are empty; no lane is padded or lost."""
    lanes = np.stack([make_photo(2, 8, seed=20 + i) for i in range(3)])
    assert parallel.shard_plan(3, 8)[3:] == [(3, 3)] * 5
    got = parallel.encode_lanes_sharded(lanes, CPU8)
    assert got == [oracle.encode(lane)[6:] for lane in lanes]
    np.testing.assert_array_equal(
        parallel.decode_lanes_sharded(got, (2, 8, 3), CPU8), lanes)


@pytest.mark.parametrize("start", ["primed", "seeded"])
def test_sharded_encode_primed_and_seeded(start):
    lanes = np.stack([make_photo(2, 8, seed=60 + i) for i in range(3)])
    kw = ({"primed": True} if start == "primed" else
          {"seed": jseed.derive(make_photo(16, 16, seed=61))})
    got = parallel.encode_lanes_sharded(lanes, CPU8, **kw)
    assert got == jhost.encode_images(lanes, **kw)
    np.testing.assert_array_equal(parallel.decode_lanes_sharded(
        got, (2, 8, 3), CPU8, **kw), lanes)


def test_sharded_decode_names_the_global_lanes_of_corrupt_streams():
    lanes = np.stack([make_photo(4, 8, seed=100 + i) for i in range(16)])
    streams = [oracle.encode(lane)[6:] for lane in lanes]
    np.testing.assert_array_equal(
        parallel.decode_lanes_sharded(streams, (4, 8, 3), CPU8), lanes)
    streams[13] = _malicious_stream()     # shard 6's second lane
    _, bad = decode.decode_lanes(streams, (4, 8, 3), errors="report",
                                 device="cpu")
    assert bad == [13]
    with pytest.raises(ValueError, match=r"lanes \[13\]"):
        parallel.decode_lanes_sharded(streams, (4, 8, 3), CPU8)
    with pytest.raises(ValueError, match=r"corrupt stream in lanes \[13\]"):
        parallel.decode_lanes_sharded(streams, (4, 8, 3), CPU8)


SLICED = make_photo(32, 16, seed=3)


@pytest.fixture(scope="module")
def jax_sliced(mesh8):
    return jpar.compress_sharded(SLICED, mesh8, slices=16)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_compress_sharded_equals_the_jax_mesh_at_every_mesh_size(jax_sliced,
                                                                  n):
    """slices=16: one container at 1, 2, 4 and 8 devices, the JAX
    package's on its 8-device mesh; exact through decompress_sharded."""
    img = SLICED
    blob = parallel.compress_sharded(img, ["cpu"] * n, slices=16)
    assert blob == jax_sliced
    np.testing.assert_array_equal(
        parallel.decompress_sharded(blob, ["cpu"] * n), img)


def test_auto_policy_past_the_seeding_threshold_equals_the_jax_mesh(mesh8):
    """512x79x3 (121,344 bytes, past the 120,000 of the seeding policy):
    8-row stripes for 8 lanes a device, primed and seeded, as the JAX
    package's compress_sharded shapes them on its 8-device mesh (of the
    images past the threshold, the one whose stripes cost the plain
    versions least)."""
    img = make_photo(512, 79, seed=5)
    blob = parallel.compress_sharded(img, CPU8)
    assert blob == jpar.compress_sharded(img, mesh8)
    streams, _, _, _, slice_h, flags = container.unpack_sliced(blob)[:6]
    assert slice_h == api.pick_slice_height(512, 79, 3, target_lanes=64)
    assert len(streams) == 64 and flags == (container.FLAG_SEEDED
                                            | container.FLAG_CRC)
    np.testing.assert_array_equal(api.decompress(blob, backend="native"),
                                  img)


def test_shards_of_several_pieces_equal_the_oracle(monkeypatch):
    """Shards cut into pieces of 2 lanes (encode) and 1 lane (decode) run
    through the one scheduler as single pieces do."""
    lanes = np.stack([make_photo(2, 8, seed=140 + i) for i in range(11)])
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES",
                        2 * encode.lane_bytes(2 * 8 * 3, "fused"))
    monkeypatch.setattr(decode, "LANE_BUDGET_BYTES", 1)
    got = parallel.encode_lanes_sharded(lanes, ["cpu"] * 3)
    assert got == [oracle.encode(lane)[6:] for lane in lanes]
    np.testing.assert_array_equal(
        parallel.decode_lanes_sharded(got, (2, 8, 3), ["cpu"] * 3), lanes)


def test_pieces_go_wave_by_wave_over_the_shard_plan():
    """Piece w of every shard before piece w + 1 of any."""
    assert devmod.pieces(11, ["a", "b", "c"], 2) == [
        ("a", 0, 2), ("b", 4, 6), ("c", 8, 10), ("a", 2, 4), ("b", 6, 8),
        ("c", 10, 11)]
    assert devmod.pieces(3, ["a"] * 8, 5) == [("a", 0, 1), ("a", 1, 2),
                                               ("a", 2, 3)]
    assert devmod.pieces(0, ["a", "b"], 4) == []


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_overlapped_holds_at_most_limit_pieces_a_device(limit):
    """The one scheduler: a device holds at most ``limit`` items, its
    oldest collected first, its first ``limit`` launched before any is
    collected; the results come back in the work's order, CPU items on no
    stream."""
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    work = [(devs[i % 2], (i,)) for i in range(7)]
    log, live = [], dict.fromkeys(devs, 0)

    def launch(i, dev, stream):
        assert stream is None
        live[dev] += 1
        assert live[dev] <= limit
        log.append(("launch", i))
        return i, dev

    def collect(i, dev):
        live[dev] -= 1
        log.append(("collect", i))
        return 10 * i

    assert devmod.overlapped(work, launch, collect, limit) == [
        10 * i for i in range(7)]
    done = [i for kind, i in log if kind == "collect"]
    for d in (0, 1):
        mine = [i for i in done if i % 2 == d]
        assert mine == sorted(mine)
        first = log.index(("collect", mine[0]))
        assert all(("launch", i) in log[:first] for i in mine[:limit])


def test_decompress_sharded_refuses_a_failing_crc():
    img = make_photo(8, 8, seed=4)
    blob = bytearray(parallel.compress_sharded(img, ["cpu"] * 2, slices=2))
    blob[-1] ^= 0x55
    with pytest.raises(ValueError, match=r"slices \[1\] \(crc mismatch\)"):
        parallel.decompress_sharded(bytes(blob), ["cpu"] * 2)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("S", [0, 1, 3, 8, 11, 16])
def test_shard_plan_blocks(S, n):
    """Device k's block is the span the JAX package's corpus_span gives
    process k: contiguous, in order, covering every lane once."""
    blocks = parallel.shard_plan(S, n)
    assert blocks == [jdist.corpus_span(S, k, n) for k in range(n)]
    assert [i for a, b in blocks for i in range(a, b)] == list(range(S))


@pytest.mark.parametrize("seeded", [True, None])
def test_corpus_with_a_mesh_equals_the_jax_corpus(mesh8, seeded):
    """seeded None: no seed under a mesh (the JAX policy); seeded True:
    the pooled seed in every container."""
    imgs = [make_photo(8, 16, seed=90 + i) for i in range(2)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=4, mesh=CPU8,
                                          seeded=seeded)
    want, _ = jcorpus.compress_corpus(imgs, slice_h=4, mesh=mesh8,
                                      seeded=seeded)
    assert blobs == want and stats.lanes == 4
    flags = container.unpack_sliced(blobs[0])[5]
    assert bool(flags & container.FLAG_SEEDED) == bool(seeded)
    outs = corpus.decompress_corpus(blobs, mesh=CPU8)
    for out, img in zip(outs, imgs):
        np.testing.assert_array_equal(out, img)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (None, 1, 2):
        with pytest.raises(RuntimeError, match="CUDA device"):
            parallel.make_mesh(n)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.encode_lanes_sharded(np.zeros((2, 1, 1, 3), np.uint8),
                                      ["cuda:0", "cuda:0"])
