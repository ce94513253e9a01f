"""llcomp_tpu_torch.host (the port's copy of the native C++ runtime) against
llcomp_tpu.host, and ``backend=`` through the port's API: equal streams and
pixels, the same corrupt streams refused, auto's routing by the work's shape
only, and the same bad slices named as the device path names.  Tolerance:
exact."""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from llcomp_tpu import api as japi
from llcomp_tpu import coder as jcoder
from llcomp_tpu import host as jhost
from llcomp_tpu import seed as jseed
from llcomp_tpu_torch import api, container, encode, host
from llcomp_tpu_torch.core import tables
from llcomp_tpu_torch.native import build
from tests.conftest import make_noise, make_photo
from tests.test_native import _malicious_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", [(1, 1, 3), (4, 4, 3), (7, 5, 3), (8, 8, 4),
                                   (5, 3, 1), (6, 4, 2), (1, 9, 3), (9, 1, 3)])
@pytest.mark.parametrize("start", ["zeros", "primed", "seeded"])
def test_stream_equals_the_reference(shape, start):
    img = make_photo(*shape, seed=sum(shape) * 7)
    kw = {"primed": start == "primed",
          "seed": jseed.derive(img) if start == "seeded" else None}
    stream = host.encode_stream(img, **kw)
    assert stream == jhost.encode_stream(img, **kw)
    np.testing.assert_array_equal(host.decode_stream(stream, shape, **kw), img)


def test_batches_equal_the_reference():
    lanes = np.stack([make_photo(12, 10, seed=50 + i) for i in range(5)])
    lanes[-1] = make_noise(12, 10, seed=3)
    tab = jseed.derive(lanes[0])
    for kw in ({}, {"primed": True}, {"seed": tab}):
        streams = host.encode_images(lanes, n_threads=2, **kw)
        assert streams == jhost.encode_images(lanes, n_threads=3, **kw)
        np.testing.assert_array_equal(
            host.decode_streams(streams, (12, 10, 3), n_threads=2, **kw),
            lanes)


def test_corrupt_streams_raise_like_the_reference():
    good = host.encode_stream(make_photo(8, 8))
    for mod in (host, jhost):
        with pytest.raises(ValueError):
            mod.decode_stream(_malicious_stream(), (4, 4, 3))
        with pytest.raises(ValueError, match="1 of 2"):
            mod.decode_streams([good, _malicious_stream()], (8, 8, 3))


def test_expand_slots_equal():
    rng = np.random.default_rng(0)
    meta = (rng.integers(0, 2, 64) | (rng.integers(0, 2, 64) << 1)
            | (rng.integers(0, 256, 64) << 8)).astype(np.int32)
    runs = rng.integers(0, 5, 64).astype(np.int32)
    assert host.expand_slots(meta, runs) == jhost.expand_slots(meta, runs)
    assert host.expand_slots(meta, runs) == jcoder.expand_slots(meta, runs)


def test_the_library_builds_under_the_ports_build_dir():
    def snapshot():
        return {p: p.stat().st_mtime_ns
                for p in (ROOT / "llcomp_tpu").rglob("*")
                if p.is_file() and "__pycache__" not in p.parts}

    before = snapshot()
    so = build.build()
    host.encode_stream(np.zeros((2, 2, 3), np.uint8))
    assert so.parent == ROOT / "llcomp_tpu_torch" / "_build"
    assert so.name.startswith("_llcomp_host_") and so.exists()
    assert snapshot() == before
    assert (build.FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC",
                            "-DNDEBUG", "-pthread"])


def test_a_missing_compiler_raises_naming_it(monkeypatch):
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(build.shutil, "which", lambda cc: None)
    with pytest.raises(build.NativeBuildError, match="g\\+\\+"):
        build.compiler()


def test_resolve_backend_by_shape_only(monkeypatch):
    n = api.MIN_DEVICE_LANES
    cpu = torch.device("cpu")
    assert api._resolve_backend("auto", "cpu", single=True) == ("native", None)
    assert api._resolve_backend("auto", "cpu", lanes=n - 1) == ("native", None)
    assert api._resolve_backend("auto", "cpu", lanes=n) == ("torch", cpu)
    assert api._resolve_backend("torch", "cpu", single=True) == ("torch", cpu)
    assert api._resolve_backend("oracle", "cuda", lanes=1) == ("torch", cpu)
    assert api._resolve_backend("native", "cuda", lanes=4096) == ("native",
                                                                   None)
    assert api._resolve_backend("jax", "cpu", lanes=1) == ("torch", cpu)
    for bad in ("xla", "pallas", "cuda", ""):
        with pytest.raises(ValueError, match="backend must be one of"):
            api._resolve_backend(bad, "cpu")
    # without CUDA: auto raises where the device engine would run, and
    # still takes the native runtime where the shape says so
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api._resolve_backend("auto", "cuda", lanes=n)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compress(make_photo(4 * n, 4), slices=n, backend="auto")
    assert api._resolve_backend("auto", "cuda", lanes=n - 1) == ("native",
                                                                 None)
    img = make_photo(8, 6, seed=2)
    assert api.compress(img, backend="auto") == japi.compress(
        img, backend="native")


def test_auto_routes_compress_and_decompress(monkeypatch):
    """With the threshold at 3 stripes: 2 stripes go native, 4 go to the
    device engine (here its plain versions); the bytes are the same."""
    calls = []
    for mod, name in ((host, "encode_images"), (host, "decode_streams"),
                      (encode, "encode_lanes")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    monkeypatch.setattr(api, "MIN_DEVICE_LANES", 3)
    img = make_photo(8, 6, seed=4)
    for slices, engine in ((2, "encode_images"), (4, "encode_lanes")):
        calls.clear()
        blob = api.compress(img, slices=slices, primed=True, backend="auto",
                            device="cpu")
        assert calls == [engine]
        assert blob == japi.compress(img, slices=slices, primed=True,
                                     backend="native")
    calls.clear()
    np.testing.assert_array_equal(
        api.decompress(api.compress(img, slices=2, backend="native"),
                       backend="auto", device="cpu"), img)
    assert calls == ["encode_images", "decode_streams"]


def test_single_streams_through_each_backend():
    img = make_photo(6, 5, seed=2)
    want = japi.compress(img, backend="native")
    for backend in ("native", "oracle", "auto"):
        blob = api.compress(img, backend=backend, device="cpu")
        assert blob == want
        np.testing.assert_array_equal(
            api.decompress(blob, backend=backend, device="cpu"), img)
    bad = want[:6] + _malicious_stream()
    out, slices = api.decompress(bad, backend="native", strict=False)
    assert slices == [0] and not out.any()
    with pytest.raises(ValueError):
        api.decompress(bad, backend="native")


def test_native_names_the_bad_slices_the_device_path_names():
    img = make_photo(24, 6, seed=10)
    blob = api.compress(img, slices=4, primed=False, backend="native")
    streams, W, H, C, sh, flags, _, _ = container.unpack_sliced(blob)
    bad = list(streams)
    bad[2] = _malicious_stream()      # passes the crc, trips the decoder
    broken = container.pack_sliced(bad, W, H, C, sh, flags=flags)
    flipped = bytearray(broken)
    flipped[-1] ^= 0x40               # slice 3 fails its crc
    for data, want_bad in ((broken, [2]), (bytes(flipped), [2, 3])):
        for backend in ("native", "torch"):
            with pytest.raises(ValueError, match="corrupt stream in slices"):
                api.decompress(data, device="cpu", backend=backend)
        out, got = api.decompress(data, backend="native", strict=False)
        dev_out, dev_bad = api.decompress(data, device="cpu", strict=False)
        ref, ref_bad = japi.decompress(data, backend="native", strict=False)
        assert got == dev_bad == ref_bad == want_bad
        for i, (y0, y1) in enumerate(container.slice_bounds(H, sh)):
            if i not in want_bad:
                np.testing.assert_array_equal(out[y0:y1], img[y0:y1])
                np.testing.assert_array_equal(dev_out[y0:y1], img[y0:y1])


def test_stripes_and_prior_table_through_the_native_backend():
    img = make_photo(24, 8, seed=12)
    bounds = container.slice_bounds(24, 8)
    tab = jseed.derive(img)
    streams = api.encode_stripes(img, bounds, seed=tab, backend="native")
    assert streams == japi.encode_stripes(img, bounds, backend="native",
                                          seed=tab)
    np.testing.assert_array_equal(
        api.decode_stripes(streams, bounds, 8, 3, seed=tab, backend="native"),
        img)
    np.testing.assert_array_equal(host._PRIOR, tables.PRIOR_TAB)
