"""The yardstick alone: the generator, the frozen roofline arithmetic, the
reference's decision count and the reading of a trace."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import devtrace, generate, harness, reference, roofline

IMAGES = [{"shape": [12, 20, 3], "count": 2}, {"shape": [9, 7, 3], "count": 1}]


def test_generator_is_deterministic_per_seed():
    dev = torch.device("cpu")
    a = generate.pool(IMAGES, 2, 2 ** 31 + 5, dev)
    b = generate.pool(IMAGES, 2, 2 ** 31 + 5, dev)
    c = generate.pool(IMAGES, 2, 2 ** 31 + 6, dev)
    shapes = [im.shape for im in a[0]]
    assert shapes == [(12, 20, 3), (12, 20, 3), (9, 7, 3)]
    assert all(im.dtype == np.uint8 and im.flags.c_contiguous for im in a[0])
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not np.array_equal(a[0][0], a[1][0])      # the pool's corpora differ
    assert not np.array_equal(a[0][0], c[0][0])      # and so do the seeds'


def test_bound_by_hand():
    b = roofline.bound(3.35e12, 0)
    assert b["bound_ms"] == pytest.approx(1000.0) and b["bound_by"] == "bytes"
    ops = 64 * 132 * 1.98e9
    b = roofline.bound(1.0, 2 * ops)
    assert b["bound_ms"] == pytest.approx(2000.0)
    assert b["bound_by"] == "operations"


def test_kernel_bounds_by_hand():
    # 2 lanes, 10 symbols, 5 decisions, 7 stream bytes
    e = roofline.encode_bound(2, 10, 5, 7)
    assert (e["bytes"], e["ops"]) == (4 * 10 + 7 + 4 * 2, 5 * 20 + 10 * 10)
    d = roofline.decode_bound(2, 10, 5, 7)
    assert (d["bytes"], d["ops"]) == (7 + 8 + 40 + 8, 5 * 20 + 10 * 40)


def test_decisions_by_hand():
    # 0 -> 1; |d| 1 -> 3; 2, 3 -> 5; 4..7 -> 7; 8 -> 9; 1274 (e 10) -> 23
    diff = torch.tensor([0, 1, -1, 2, 3, -4, 7, 8, 1274])
    assert reference.decisions(diff) == 1 + 3 + 3 + 5 + 5 + 7 + 7 + 9 + 23


def test_decisions_match_the_layout():
    img = generate.pool(IMAGES, 1, 9, torch.device("cpu"))[0][0][:8]
    h, d = reference.residuals(torch.from_numpy(img)[None])
    idx, _ = reference._layout(h[0].numpy(), d[0].numpy())
    assert reference.decisions(d) == len(idx)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _window_events():
    return [
        _x("user_annotation", devtrace.WINDOW, 0, 100),
        _x("user_annotation", devtrace.CALL, 0, 50),
        _x("user_annotation", "encode/upload", 5, 10),
        _x("user_annotation", devtrace.CALL, 50, 50),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10),
        _x("kernel", "(anonymous namespace)::encode_fused_kernel(int const*)",
           20, 30),
        _x("kernel", "void at::native::foo<int>(int)", 40, 20),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 70, 5),
        _x("kernel", "late(int)", 120, 5),                 # past the window
    ]


def test_trace_reading():
    t = devtrace.read(_window_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(55e-6)         # [10, 60) and [70, 75)
    assert t.kernel_s == pytest.approx({"encode_fused_kernel": 30e-6,
                                        "foo": 20e-6})
    assert t.copy_s == pytest.approx({"HtoD": 10e-6, "DtoH": 5e-6})
    assert t.device_s({"encode_fused_kernel"}) == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps)       # [0, 10) [60, 70) [75, 100)
    assert gaps == pytest.approx({devtrace.CALL: 40e-6, "encode/upload": 5e-6})
    assert "encode_fused_kernel" in t.device_ops[0][0]


@pytest.mark.parametrize("name, want", [
    ("copy_ms.encode", 0.0075), ("copy_ms.decode", 0.0075),
    ("torch_ops_ms.encode", 0.01), ("torch_ops_ms.decode", 0.01),
    ("idle_pct.encode", 45.0), ("idle_pct.decode", 45.0),
])
def test_layer_readers(name, want):
    # the window of test_trace_reading over two calls
    run = types.SimpleNamespace(
        trace=devtrace.read(_window_events()), calls=[{}, {}],
        program_kernels={"encode_fused_kernel"})
    read = harness.load_metric(name).read
    assert read(run) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None, calls=[])) is None


def test_program_kernels_are_read_from_the_sources():
    from conftest import ROOT

    names = devtrace.program_kernels(str(ROOT / "llcomp_tpu_torch" / "csrc"))
    assert {"encode_fused_kernel", "decode_kernel"} <= names
    for name in ("void decode_kernel<3>(unsigned char const*)",
                 "void (anonymous namespace)::decode_kernel<3>(int const*)"):
        assert devtrace.kernel_id(name) == "decode_kernel"
