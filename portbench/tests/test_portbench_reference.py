"""The reference against the program (``device="cpu"``) on tiny corpora,
and the harness's runs of each entry there."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY_IMAGES
from portbench import generate, judge, reference


@pytest.mark.parametrize("primed", [True, False])
def test_reference_equals_the_program(primed):
    from llcomp_tpu_torch import corpus

    images = generate.pool(TINY_IMAGES, 1, 77, torch.device("cpu"))[0]
    blobs, _ = corpus.compress_corpus(images, slice_h=8, primed=primed,
                                      seeded=False, device="cpu")
    work = {"slice_h": 8, "primed": primed, "seeded": False}
    for img, blob in zip(images, blobs):
        H, W, C = img.shape
        streams = [reference.encode_stripe(img[y0:y1], primed)
                   for y0, y1, _, _ in reference.regions(H, W, 8)]
        assert reference.pack(streams, H, W, C, 8, judge.flags(work)) == blob
        assert reference.parse(blob) == streams
    outs = corpus.decompress_corpus(blobs, device="cpu")
    assert judge.pixels_off(outs, images) == 0


def test_parse_refuses_other_layouts():
    blob = reference.pack([b"ab", b"c"], 9, 4, 3, 8, reference.FLAG_CRC)
    assert reference.parse(blob) == [b"ab", b"c"]
    with pytest.raises(ValueError):
        reference.parse(blob + b"x")
    with pytest.raises(ValueError):
        reference.parse(blob[:7] + bytes([blob[7] | 8]) + blob[8:])


def test_containers_off_counts_each_fault():
    img = generate.pool(TINY_IMAGES, 1, 5, torch.device("cpu"))[0][0]
    H, W, C = img.shape
    work = {"slice_h": 8, "primed": True, "seeded": False}
    streams = [reference.encode_stripe(img[y0:y1], True)
               for y0, y1, _, _ in reference.regions(H, W, 8)]
    good = reference.pack(streams, H, W, C, 8, judge.flags(work))
    sample = [(0, 0, 8, 16)]

    def off(blob):
        return judge.containers_off([(0, 0)], lambda k: [blob], [[img]], work,
                                    sample)

    assert off(good) == 0
    assert off(reference.pack(streams + [b"x"], H, W, C, 8, 5)) == 1
    assert off(reference.pack(streams, H, W, C, 16, 5)) == 1      # the head
    assert off(good[:-1] + bytes([good[-1] ^ 1])) == 1   # stale crc
    altered = [streams[0], bytes([streams[1][0] ^ 1]) + streams[1][1:]]
    assert off(reference.pack(altered, H, W, C, 8, 5)) == 1       # a stream
    assert off(b"LLCT") == 1
    assert judge.containers_off([(0, 0)], lambda k: None, [[img]], work,
                                sample) == 1


def test_a_repeat_counts_where_it_differs_from_the_first():
    img = generate.pool(TINY_IMAGES, 1, 6, torch.device("cpu"))[0][0]
    H, W, C = img.shape
    work = {"slice_h": 8, "primed": True, "seeded": False}
    streams = [reference.encode_stripe(img[y0:y1], True)
               for y0, y1, _, _ in reference.regions(H, W, 8)]
    good = reference.pack(streams, H, W, C, 8, judge.flags(work))
    # a stream altered and packed anew: the container parses and repacks
    altered = reference.pack(
        [streams[0], bytes([streams[1][0] ^ 1]) + streams[1][1:]]
        + streams[2:], H, W, C, 8, judge.flags(work))
    sample = [(0, 0, 0, 8)]                  # not the altered stripe

    def off(first, later):
        blobs = {0: [first], 1: later}
        return judge.containers_off([(0, 0)], blobs.get, [[img]], work,
                                    sample, repeats=[(1, 0)])

    assert off(good, [good]) == 0
    assert off(good, [altered]) == 1
    assert off(altered, [altered]) == 0      # the sample misses both
    assert off(b"LLCT", [b"LLCT"]) == 2      # a repeat of a wrong one
    assert off(good, None) == 1
    held = {0: (0, "a"), 1: (1, "b"), 2: (0, "c"), 3: (1, "d")}
    assert judge.firsts(held) == ([(0, 0), (1, 1)], [(2, 0), (3, 1)])


def test_draw_takes_each_shape_and_every_image_end():
    corpora = generate.pool(TINY_IMAGES, 2, 8, torch.device("cpu"))
    work = {"slice_h": 8}
    holders = [(10, 0), (11, 1)]
    for n in (0, 9, 100):
        got = judge.draw(np.random.default_rng(n), holders, corpora, work, n)
        assert len(set(got)) == len(got)
        ends = {(i, y0) for _, i, y0, _ in got}
        for i, img in enumerate(corpora[0]):
            assert {(i, 0), (i, (img.shape[0] - 1) // 8 * 8)} <= ends
        shapes = {(y1 - y0, corpora[0][i].shape[1]) for _, i, y0, y1 in got}
        assert shapes == {(8, 24), (8, 16), (5, 16)}
        # 6 ends and 3 shapes, some of them the same stripes; 14 in all
        assert 6 <= len(got) <= 9 if n == 0 else len(got) == min(n, 14)


def test_pixels_off_counts_pixels():
    img = np.zeros((4, 5, 3), np.uint8)
    out = img.copy()
    out[1, 2, 0] = 1
    out[3, 4] = 9
    assert judge.pixels_off([out], [img]) == 2
    assert judge.pixels_off([out[:3]], [img]) == 20
    assert judge.pixels_off(None, [img, img]) == 40


@pytest.mark.parametrize("cell", ["kodak24.ingest", "kodak24.restore"])
def test_sound_run_is_correct(run_tiny, cell):
    result, checks = run_tiny(cell)
    assert result["correct"], checks
    assert result["attempted"] == 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert all(v == 0 for v, _ in checks.values())
