"""llcomp_tpu_torch.corpus (device='cpu', the kernels' plain versions, and
the native runtime) against llcomp_tpu.corpus with backend='native': equal
blobs, exact round trips, the batch cap and the stats; and
encode.encode_lanes_pipelined against encode.encode_lanes and
llcomp_tpu.host.  Tolerance: exact."""
from __future__ import annotations

import numpy as np
import pytest

from llcomp_tpu import api as japi
from llcomp_tpu import container as jcont
from llcomp_tpu import corpus as jcorpus
from llcomp_tpu import host as jhost
from llcomp_tpu_torch import api, container, corpus, encode
from tests.conftest import make_photo


def _exact(outs, imgs):
    assert len(outs) == len(imgs)
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)


def test_mixed_sizes_equal_the_reference_and_round_trip():
    imgs = [make_photo(8, 8, seed=1), make_photo(12, 8, seed=2),
            make_photo(8, 4, seed=3), make_photo(7, 8, seed=4),   # ragged
            make_photo(4, 4, c=4, seed=5), make_photo(4, 4, c=1, seed=6)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=4, device="cpu")
    want, _ = jcorpus.compress_corpus(imgs, slice_h=4, backend="native")
    assert blobs == want
    assert stats.images == 6 and stats.batches == 5 and stats.lanes == 11
    _exact(corpus.decompress_corpus(blobs, device="cpu"), imgs)
    _exact(corpus.decompress_corpus(blobs, backend="native"), imgs)


def test_batch_cap():
    imgs = [make_photo(16, 2, seed=i) for i in range(4)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8,
                                          max_lanes_per_batch=3, device="cpu")
    assert stats.batches == 3 and stats.lanes == 8  # 8 lanes in caps of 3
    want, _ = jcorpus.compress_corpus(imgs, slice_h=8, max_lanes_per_batch=3,
                                      backend="native")
    assert blobs == want
    _exact(corpus.decompress_corpus(blobs, max_lanes_per_batch=3,
                                    device="cpu"), imgs)


def test_stats_fields():
    _, stats = corpus.compress_corpus([make_photo(16, 16)], slice_h=8,
                                      backend="native")
    d = stats.as_dict()
    assert d["images"] == 1 and d["pixels"] == 256 and d["lanes"] == 2
    assert d["bpp"] > 0 and d["mps"] > 0 and d["ratio"] == round(stats.ratio,
                                                                3)


def test_seeded_pooled_round_trip():
    """Photo corpora of large images store one pooled seed in every
    container; each container decodes alone."""
    imgs = [make_photo(256, 256, seed=30 + i) for i in range(3)]
    blobs, _ = corpus.compress_corpus(imgs, slice_h=8, backend="native")
    want, _ = jcorpus.compress_corpus(imgs, slice_h=8, backend="native")
    assert blobs == want
    seeds = set()
    for b in blobs:
        flags, seed_blob = container.unpack_sliced(b)[5:7]
        assert flags & container.FLAG_SEEDED and seed_blob
        seeds.add(seed_blob)
    assert len(seeds) == 1
    _exact(corpus.decompress_corpus(blobs, backend="native"), imgs)
    np.testing.assert_array_equal(api.decompress(blobs[1], backend="native"),
                                  imgs[1])


def test_tiled_members_and_mixed_decode():
    wide, small = make_photo(16, 48, seed=17), make_photo(8, 8, seed=18)
    for tile_w in (20, 0):
        blobs, _ = corpus.compress_corpus([wide, small], slice_h=8,
                                          tile_w=tile_w, backend="native")
        want, _ = jcorpus.compress_corpus([wide, small], slice_h=8,
                                          tile_w=tile_w, backend="native")
        assert blobs == want
        assert container.unpack_sliced(blobs[0])[7] == (20 if tile_w else 0)
        assert container.unpack_sliced(blobs[1])[7] == 0
    mixed = [japi.compress(wide, slices="auto", tile_w=20, backend="native"),
             japi.compress(wide, slices="auto", tile_w=0, backend="native")]
    _exact(corpus.decompress_corpus(mixed, backend="native"), [wide, wide])
    assert jcont.unpack_sliced(mixed[0])[7] == 20


def _batches():
    """Three batches of different shapes (and lane counts)."""
    return [np.stack([make_photo(4, 8, seed=i) for i in range(3)]),
            np.stack([make_photo(2, 6, c=1, seed=10 + i) for i in range(5)]),
            np.stack([make_photo(3, 5, c=4, seed=20 + i) for i in range(2)])]


@pytest.fixture(scope="module")
def each_batch():
    """``encode_lanes`` on each of ``_batches()``, primed: equal to the
    reference's native runtime, which shares no code with the pipeline."""
    got = [encode.encode_lanes(b, primed=True, device="cpu")
           for b in _batches()]
    assert got == [jhost.encode_images(b, primed=True) for b in _batches()]
    return got


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_pipelined_equals_encode_lanes_on_each_batch(monkeypatch, each_batch,
                                                     max_inflight):
    # pieces of at most 2 lanes: batches split across pieces in flight
    monkeypatch.setattr(encode, "LANE_BUDGET_BYTES",
                        2 * encode.lane_bytes(96, "fused"))
    got = encode.encode_lanes_pipelined(_batches(), primed=True,
                                        device="cpu",
                                        max_inflight=max_inflight)
    assert got == each_batch


def test_pipelined_arguments():
    batches = _batches()[:2]
    assert encode.encode_lanes_pipelined(batches, primed=True, device="cpu",
                                         engine="sort") == [
        encode.encode_lanes(b, primed=True, device="cpu", engine="sort")
        for b in batches]
    assert encode.encode_lanes_pipelined([], device="cpu") == []
    assert encode.pipeline_fits(12_288) and not encode.pipeline_fits(1 << 28)
    with pytest.raises(ValueError, match="max_inflight"):
        encode.encode_lanes_pipelined(batches, device="cpu", max_inflight=0)
    with pytest.raises(ValueError, match="lanes"):
        encode.encode_lanes_pipelined([batches[0][0]], device="cpu")
