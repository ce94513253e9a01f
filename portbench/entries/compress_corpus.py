"""Ingest: ``corpus.compress_corpus`` takes one corpus a call and returns a
sliced container an image.

Checked (``judge.containers_off``): every held container against the
reference's packing of its streams; ``ref_lanes`` stripes of the first held
call of each pool item (each image's first and last among them) against
the reference's encoding; and every later held call of an item against its
first, byte for byte.
"""
from __future__ import annotations

from .. import judge as J


def prepare(corpora: list, work: dict, dev) -> list:
    """A call's input is a corpus: host u8 images, as users pass them."""
    return corpora


def call(images: list, work: dict, dev) -> tuple[list, dict]:
    from llcomp_tpu_torch import corpus

    blobs, stats = corpus.compress_corpus(
        images, slice_h=work["slice_h"], primed=work["primed"],
        seeded=work["seeded"], device=dev)
    return blobs, {"encode_s": stats.encode_s,
                   "out_bytes": sum(map(len, blobs))}


def judge(corpora: list, inputs: list, kept: dict, work: dict, rng) -> dict:
    holders, repeats = J.firsts(kept)
    sample = J.draw(rng, holders, corpora, work, work["ref_lanes"])
    return {"containers_off": (J.containers_off(
        holders, lambda k: kept[k][1], corpora, work, sample,
        repeats=repeats), 0)}


def control(corpora: list, work: dict, rng) -> dict:
    """The reference in the program's place, coding the lossy images: the
    same draw of stripes over one call a pool item."""
    holders = [(k, k) for k in range(len(corpora))]
    sample = J.draw(rng, holders, corpora, work, work["ref_lanes"])
    return {"containers_off": (J.containers_off(
        holders, None, corpora, work, sample, control=True), 0)}
