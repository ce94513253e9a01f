"""The comparisons that decide ``correct``, against ``reference`` alone.

* ``containers_off``: containers whose bytes differ from the reference's
  packing of their own streams (head, length index, crc32 table), that do
  not parse, that hold a stripe, drawn from the seed, whose stream differs
  from the reference's encoding of it, or that differ from the first held
  call's container of the same image: the region plan, the packing, the
  precompute, the lane driver and kernel 1.
* ``pixels_off``: decoded pixels that differ from the images made by the
  benchmark: container parse, lane driver, kernel 2, inverse colour
  transform, assembly.

Each is a count whose limit is 0: the codec is lossless and its bytes are
fixed by the format.  A control (``lossy``) codes or returns the images with
their lowest bit cleared, which breaks the lossless guarantee.
"""
from __future__ import annotations

import struct

import numpy as np

from . import reference as R


def flags(work: dict) -> int:
    """The container flags of the traffic's settings; the reference knows
    the primed and the unprimed start with crc32, untiled and unseeded."""
    if work["seeded"] or not isinstance(work["primed"], bool):
        raise ValueError("the reference codes primed=True/False, seeded=False")
    return (R.FLAG_PRIMED if work["primed"] else 0) | R.FLAG_CRC


def lossy(img: np.ndarray) -> np.ndarray:
    """The control's images: the lowest bit of every sample cleared."""
    return img & np.uint8(0xFE)


def firsts(kept: dict) -> tuple[list, list]:
    """Held calls ``{key: (pool item, output)}`` -> (holders, repeats):
    the first held call of each pool item as (key, item), and each later
    held call of an item as (key, that item's first key)."""
    first, repeats = {}, []
    for key in sorted(kept):
        item = kept[key][0]
        if item in first:
            repeats.append((key, first[item]))
        else:
            first[item] = key
    return [(key, item) for item, key in first.items()], repeats


def draw(rng: np.random.Generator, holders: list, corpora: list, work: dict,
         n: int) -> list[tuple]:
    """Stripes to compare, as (holder, image, y0, y1), each once: one of
    each stripe shape, then each image's first and last stripe (in a holder
    drawn for each), then drawn uniformly over every stripe of every holder
    until ``n`` or every stripe is taken.  ``holders``: (key, pool item)
    pairs whose outputs are held."""
    sh = work["slice_h"]
    every, by_shape, ends = [], {}, {}
    for key, item in holders:
        for i, img in enumerate(corpora[item]):
            H, W, C = img.shape
            last = (H - 1) // sh * sh
            for y0 in range(0, H, sh):
                y1 = min(y0 + sh, H)
                if y0 in (0, last):
                    ends.setdefault((i, y0), []).append(len(every))
                by_shape.setdefault((y1 - y0, W, C), []).append(len(every))
                every.append((key, i, y0, y1))
    picks = [int(rng.choice(v)) for _, v in sorted(by_shape.items())]
    picks += [int(rng.choice(v)) for _, v in sorted(ends.items())]
    picks = list(dict.fromkeys(picks))
    left = np.setdiff1d(np.arange(len(every)), picks)
    rest = min(max(0, n - len(picks)), len(left))
    picks += rng.choice(left, size=rest, replace=False).tolist()
    return [every[p] for p in picks]


def _streams(blob) -> list | None:
    try:
        return R.parse(blob)
    except (ValueError, IndexError, TypeError, struct.error):
        return None


def containers_off(holders: list, blobs_of, corpora: list, work: dict,
                   sample: list[tuple], control: bool = False,
                   repeats: list = ()) -> int:
    """Containers found wrong among the held calls' ``blobs_of(key)`` (one
    an image of pool item ``item`` for each (key, item) of ``holders``): one
    that does not parse, holds another count of streams than its image has
    stripes, differs from the reference's packing of its own streams (head,
    length index, crc32 table), or holds a stripe of ``sample`` whose stream
    differs from the reference's encoding of it.  Each (key, was) of
    ``repeats`` is a later call of the item of holder ``was``: its
    containers count where they differ from ``was``'s byte for byte or
    ``was``'s are wrong.  A call that returned no list of its length counts
    every image.  ``control``: no containers; each sampled stripe's stream
    is the reference's encoding of the lossy stripe."""
    items, bad = dict(holders), set()
    parsed: dict = {}
    for key, item in holders if not control else ():
        blobs, imgs = blobs_of(key), corpora[item]
        if blobs is None or len(blobs) != len(imgs):
            bad.update((key, i) for i in range(len(imgs)))
            continue
        for i, (img, blob) in enumerate(zip(imgs, blobs)):
            H, W, C = img.shape
            parsed[key, i] = streams = _streams(blob)
            if (streams is None
                    or len(streams) != len(R.regions(H, W, work["slice_h"]))
                    or R.pack(streams, H, W, C, work["slice_h"],
                              flags(work)) != blob):
                bad.add((key, i))
    for key, i, y0, y1 in sample:
        if (key, i) in bad:
            continue
        stripe = corpora[items[key]][i][y0:y1]
        want = R.encode_stripe(stripe, work["primed"])
        if control:
            got = R.encode_stripe(lossy(stripe), work["primed"])
        else:
            streams, j = parsed[key, i], y0 // work["slice_h"]
            got = streams[j] if j < len(streams) else None
        if got != want:
            bad.add((key, i))
    for key, was in repeats:
        blobs, first = blobs_of(key), blobs_of(was)
        n = len(corpora[items[was]])
        if blobs is None or len(blobs) != n:
            bad.update((key, i) for i in range(n))
            continue
        bad.update((key, i) for i in range(n) if (was, i) in bad
                   or blobs[i] != first[i])
    return len(bad)


def pixels_off(outs, imgs: list[np.ndarray]) -> int:
    """Pixels of ``outs`` that differ from ``imgs`` in any channel; all of
    an image's where its output is missing or of another shape."""
    if outs is None or len(outs) != len(imgs):
        return sum(im.shape[0] * im.shape[1] for im in imgs)
    off = 0
    for out, img in zip(outs, imgs):
        out = np.asarray(out)
        if out.shape != img.shape or out.dtype != img.dtype:
            off += img.shape[0] * img.shape[1]
        elif not np.array_equal(out, img):
            off += int((out != img).any(axis=-1).sum())
    return off
