"""Restore: ``corpus.decompress_corpus`` takes one corpus's containers a
call and returns the images.

The containers are made at set-up by the program's ``compress_corpus``
with the traffic's settings.  Checked: every pixel of the held calls
against the images the benchmark made (``pixels_off``), and those inputs as
the ingest cell checks its outputs (``inputs_off``: every container,
``ref_lanes`` stripes, each image's first and last among them), so that
what is decoded is the format.
"""
from __future__ import annotations

from .. import judge as J


def prepare(corpora: list, work: dict, dev) -> list:
    from llcomp_tpu_torch import corpus

    return [corpus.compress_corpus(
        images, slice_h=work["slice_h"], primed=work["primed"],
        seeded=work["seeded"], device=dev)[0] for images in corpora]


def call(blobs: list, work: dict, dev) -> tuple[list, dict]:
    from llcomp_tpu_torch import corpus

    return (corpus.decompress_corpus(blobs, device=dev),
            {"in_bytes": sum(map(len, blobs))})


def judge(corpora: list, inputs: list, kept: dict, work: dict, rng) -> dict:
    pixels = sum(J.pixels_off(outs, corpora[item])
                 for item, outs in kept.values())
    holders = [(k, k) for k in range(len(corpora))]
    sample = J.draw(rng, holders, corpora, work, work["ref_lanes"])
    return {"pixels_off": (pixels, 0), "inputs_off": (J.containers_off(
        holders, lambda k: inputs[k], corpora, work, sample), 0)}


def control(corpora: list, work: dict, rng) -> dict:
    """The lossy images in place of the decoded ones, one call a pool item,
    and the reference's encoding of the lossy stripes in place of the
    inputs' sampled streams."""
    holders = [(k, k) for k in range(len(corpora))]
    sample = J.draw(rng, holders, corpora, work, work["ref_lanes"])
    pixels = sum(J.pixels_off([J.lossy(im) for im in images], images)
                 for images in corpora)
    return {"pixels_off": (pixels, 0), "inputs_off": (J.containers_off(
        holders, None, corpora, work, sample, control=True), 0)}
