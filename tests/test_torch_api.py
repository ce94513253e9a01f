"""llcomp_tpu_torch.api (device='cpu', the kernels' plain versions) against
llcomp_tpu.api with the native backend: equal .llct bytes, exact round
trips, equal fault reports."""
from __future__ import annotations

import numpy as np
import pytest

from llcomp_tpu import api as japi
from llcomp_tpu import container as jcont
from llcomp_tpu import host, oracle
from llcomp_tpu import seed as jseed
from llcomp_tpu_torch import api, container, encode
from llcomp_tpu_torch.core.config import CodecConfig
from tests.conftest import make_photo
from tests.test_native import _malicious_stream

CASES = {
    "photo auto (primed)": (make_photo(24, 16, seed=3), {}),
    "seeded": (make_photo(24, 16, seed=4), {"seeded": True}),
    "slices=3": (make_photo(20, 8, seed=5), {"slices": 3}),
    "slices=2 unprimed": (make_photo(12, 8, seed=6),
                          {"slices": 2, "primed": False}),
    "tile_w=10": (make_photo(16, 24, seed=7), {"tile_w": 10}),
    "rgba": (make_photo(16, 8, c=4, seed=8), {}),
    "grayscale 2-D": (make_photo(20, 12, c=1, seed=9)[..., 0], {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_llct_bytes_equal_native_and_roundtrip(name):
    img, kw = CASES[name]
    kw = dict(kw)
    slices = kw.pop("slices", "auto")
    got = api.compress(img, slices=slices, device="cpu", **kw)
    want = japi.compress(img, slices=slices, backend="native", **kw)
    assert got == want
    if name == "photo auto (primed)":
        assert container.unpack_sliced(got)[5] & container.FLAG_PRIMED
    out = api.decompress(got, device="cpu")
    np.testing.assert_array_equal(out, japi._as_image(img))


def test_single_stream_equals_oracle_and_roundtrips():
    img = make_photo(6, 5, seed=2)
    for slices in (None, 1):
        blob = api.compress(img, slices=slices, device="cpu")
        assert blob == oracle.encode(img)
    np.testing.assert_array_equal(api.decompress(blob, device="cpu"), img)
    out, bad = api.decompress(blob[:6] + _malicious_stream(), device="cpu",
                              strict=False)
    want, want_bad = japi.decompress(blob[:6] + _malicious_stream(),
                                     backend="native", strict=False)
    assert bad == want_bad == [0] and not out.any()
    with pytest.raises(ValueError, match="sliced mode"):
        api.compress(img, primed=True, device="cpu")


def test_nonstrict_reports_corrupt_slices_like_jax_package():
    img = make_photo(32, 8, seed=10)
    blob = api.compress(img, slices=4, primed=False, device="cpu")
    streams, W, H, C, sh, flags, _, _ = container.unpack_sliced(blob)
    bad = list(streams)
    bad[2] = _malicious_stream()      # passes the crc, trips the decoder
    broken = container.pack_sliced(bad, W, H, C, sh, flags=flags)
    flipped = bytearray(broken)
    flipped[-1] ^= 0x40               # slice 3 fails its crc
    for data, want_bad in ((broken, [2]), (bytes(flipped), [2, 3])):
        with pytest.raises(ValueError):
            api.decompress(data, device="cpu")
        out, bad_slices = api.decompress(data, device="cpu", strict=False)
        ref, ref_bad = japi.decompress(data, backend="native", strict=False)
        assert bad_slices == ref_bad == want_bad
        for i, (y0, y1) in enumerate(container.slice_bounds(H, sh)):
            if i not in want_bad:
                np.testing.assert_array_equal(out[y0:y1], img[y0:y1])
                np.testing.assert_array_equal(ref[y0:y1], img[y0:y1])


def test_seed_table_from_jax_package_gives_same_streams():
    """Weights-and-state check: a stored-seed table derived by llcomp_tpu
    and handed over as numpy drives both packages to the same streams."""
    img = make_photo(24, 8, seed=12)
    tab = jseed.derive(img)
    lanes = img.reshape(3, 8, 8, 3)
    assert encode.encode_lanes(lanes, seed=tab, device="cpu") == \
        host.encode_images(lanes, seed=tab)
    bounds = jcont.slice_bounds(24, 8)
    streams = api.encode_stripes(img, bounds, seed=tab, device="cpu")
    assert streams == japi.encode_stripes(img, bounds, backend="native",
                                          seed=tab)
    np.testing.assert_array_equal(
        api.decode_stripes(streams, bounds, 8, 3, seed=tab, device="cpu"), img)


def test_argument_errors():
    img = make_photo(8, 8)
    with pytest.raises(TypeError):
        api.compress(img.astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="sign_ctx"):
        api.compress(img, slices=2, cfg=CodecConfig(sign_ctx=8), device="cpu")
    with pytest.raises(ValueError, match="tile_w"):
        api.compress(img, slices="auto", tile_w=8, device="cpu")
    with pytest.raises(ValueError, match="unsupported revision"):
        api.compress(img, revision=1, device="cpu")
    with pytest.raises(ValueError):
        api.decompress(b"\x00" * 16, device="cpu")
