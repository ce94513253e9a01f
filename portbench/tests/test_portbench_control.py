"""The comparison that decides ``correct`` fails its control and every fault
the cells can have.

The control (the reference in the program's place, on the images with their
lowest bit cleared: the lossless guarantee broken) at a tiny size; the
faults planted in the program underneath a whole run of the harness on the
CPU: half of each batch's lanes left out, and an answer altered where it is
produced (a stream's byte in encode, a pixel in decode); and a call that
raises, an answer that never comes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_spec
from portbench import generate, harness


@pytest.mark.parametrize("cell", ["kodak24.ingest", "kodak24.restore"])
def test_control_fails(cell):
    spec = tiny_spec(cell)
    entry = harness.entry_module(spec.work["entry"])
    corpora = generate.pool(spec.config["images"], 2, 4242,
                            torch.device("cpu"))
    checks = entry.control(corpora, spec.work, np.random.default_rng(1))
    # every number the cell compares has an upper reading
    result, sound = harness.measure(spec, 4242, 0.0, False, "cpu",
                                    log=lambda msg: None)
    assert result["correct"] and set(checks) == set(sound)
    assert all(v > lim for v, lim in checks.values()), checks


def _half_left_out_encode(monkeypatch):
    from llcomp_tpu_torch import encode

    real = encode.encode_lanes_pipelined

    def half(batches, *args, **kwargs):
        out = real(batches, *args, **kwargs)
        return [s[: (len(s) + 1) // 2] + [b""] * (len(s) // 2) for s in out]

    monkeypatch.setattr(encode, "encode_lanes_pipelined", half)


def _altered_encode(monkeypatch):
    from llcomp_tpu_torch import encode

    real = encode._streams

    def altered(out, lens):
        return [bytes([s[0] ^ 1]) + s[1:] if s else s
                for s in real(out, lens)]

    monkeypatch.setattr(encode, "_streams", altered)


def _half_left_out_decode(monkeypatch):
    from llcomp_tpu_torch import decode

    real = decode.decode_lanes

    def half(streams, *args, **kwargs):
        out = real(streams, *args, **kwargs)
        out[(len(out) + 1) // 2:] = 0
        return out

    monkeypatch.setattr(decode, "decode_lanes", half)


def _altered_decode(monkeypatch):
    from llcomp_tpu_torch import decode

    real = decode._kernel

    def altered(*args, **kwargs):
        imgs, err = real(*args, **kwargs)
        imgs[:, 0, 0, 0] ^= 1
        return imgs, err

    monkeypatch.setattr(decode, "_kernel", altered)


def _raises(monkeypatch):
    from llcomp_tpu_torch import decode

    def fail(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(decode, "decode_lanes", fail)


@pytest.mark.parametrize("cell, fault", [
    ("kodak24.ingest", _half_left_out_encode),
    ("kodak24.ingest", _altered_encode),
    ("kodak24.restore", _half_left_out_decode),
    ("kodak24.restore", _altered_decode),
    ("kodak24.restore", _raises),
], ids=["ingest-half", "ingest-altered", "restore-half", "restore-altered",
        "restore-raises"])
def test_fault_fails(run_tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, checks = run_tiny(cell)
    assert not result["correct"], (result, checks)
