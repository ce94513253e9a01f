"""llcomp_tpu_torch.rev0 (the llcomp.js bitstream, magic 0x77) against
llcomp_tpu.rev0: the pinned goldens, equal bytes and pixels on random 3- and
4-channel images, the coder trace, and the API's dispatch.  Tolerance:
exact."""
from __future__ import annotations

import numpy as np
import pytest

from llcomp_tpu import oracle
from llcomp_tpu import rev0 as jrev0
from llcomp_tpu_torch import api, container, rev0
from tests.conftest import make_noise, make_photo

# tests/test_rev0.py's goldens and images
GOLDEN_REV0 = {
    (1, 1, 3): "7703010001008266d6e11f3a",
    (2, 2, 3): "770302000200825ba6a4f74bfbffafc811a6b0307247632a91",
    (4, 4, 3): "7703040004008261c3981a766b9810e7cdda4d55c2bfbbf453ed46ac50c1720d16",
    (2, 2, 4): "7704020002008266d6e11f3b221ec719257457c884bd6a7127",
}


def _golden_image(shape):
    if shape == (1, 1, 3):
        return np.array([[[10, 20, 30]]], np.uint8)
    if shape == (2, 2, 3):
        return np.array(
            [[[0, 0, 0], [255, 255, 255]], [[128, 64, 32], [1, 2, 3]]], np.uint8)
    if shape == (4, 4, 3):
        return (np.arange(48).reshape(4, 4, 3) * 5 % 256).astype(np.uint8)
    return np.arange(10, 170, 10, dtype=np.uint8).reshape(2, 2, 4)


@pytest.mark.parametrize("shape", sorted(GOLDEN_REV0))
def test_golden_bytes_both_ways(shape):
    img = _golden_image(shape)
    want = bytes.fromhex(GOLDEN_REV0[shape])
    assert jrev0.encode(img) == want
    assert rev0.encode(img) == want
    assert api.compress(img, revision=0) == want
    np.testing.assert_array_equal(rev0.decode(want), img)
    np.testing.assert_array_equal(api.decompress(want), img)


@pytest.mark.parametrize("case", ["photo 7x5x3", "photo 6x6x4",
                                  "photo 16x16x3", "noise 9x7x3",
                                  "noise 5x6x4", "flat 8x8x3"])
def test_random_images_equal_the_reference(case):
    kind, dims = case.split()
    h, w, c = map(int, dims.split("x"))
    if kind == "photo":
        img = make_photo(h, w, c, seed=h * w + c)
    elif kind == "noise":
        img = make_noise(h, w, c, seed=h + w)
    else:
        img = np.full((h, w, c), 200, np.uint8)
    blob = rev0.encode(img)
    assert blob == jrev0.encode(img)
    np.testing.assert_array_equal(rev0.decode(blob), jrev0.decode(blob))
    np.testing.assert_array_equal(api.decompress(blob, device="cpu"), img)


def test_coder_trace():
    """The first two decisions of the 1x1x3 golden, hand-derived from the
    llcomp.js:39-52 clamped float split (tests/test_rev0.py)."""
    for mod in (rev0, jrev0):
        enc = mod.RangeEncoder0()
        enc.put(0, 1 - 0.5156)
        assert (enc.low, enc.range) == (0, 33659)
        enc.put(1, 1 - 0.5156)
        assert (enc.low, enc.range) == (17355, 16304)


def test_tables_equal_the_reference():
    for name in ("NEXT_STATE_MPS_0", "NEXT_STATE_LPS_0", "MPS_PROBABILITY"):
        np.testing.assert_array_equal(getattr(rev0, name),
                                      getattr(jrev0, name))


def test_api_dispatch():
    img = make_photo(8, 8)
    blob = api.compress(img, revision=0, slices="auto", device="cuda")
    assert blob[0] == 0x77 and blob == jrev0.encode(img)
    np.testing.assert_array_equal(api.decompress(blob, device="cuda"), img)
    out, bad = api.decompress(blob, strict=False)
    assert bad == [] and np.array_equal(out, img)
    with pytest.raises(ValueError, match="unsupported revision"):
        api.compress(img, revision=1)
    # revision 0 takes 3 or 4 channels, as llcomp.js does
    gray = make_photo(4, 4, c=1)
    for fn in (jrev0.encode, rev0.encode,
               lambda im: api.compress(im, revision=0)):
        with pytest.raises(ValueError, match="3 or 4 channels"):
            fn(gray)


def test_cross_rejects():
    img = make_photo(8, 8)
    with pytest.raises(ValueError):
        rev0.decode(oracle.encode(img))
    with pytest.raises(ValueError, match="Invalid magic"):
        container.unpack_single(rev0.encode(img))


@pytest.mark.parametrize("strict", [True, False])
def test_bad_headers_raise_value_error(strict, tmp_path, capsys):
    """A cut header, a channel count llcomp.js never writes, and a header
    claiming more samples than its payload can code raise ValueError in
    either mode, before anything is allocated; the CLI reports them."""
    from llcomp_tpu_torch import cli

    good = rev0.encode(make_photo(4, 4))
    cases = {b"\x77": "cut at 1 of 6", good[:5]: "cut at 5 of 6",
             b"\x77\x01" + good[2:]: "3 or 4 channels",
             bytes([0x77, 2]) + good[2:]: "3 or 4 channels",
             b"\x77\x03\xff\xff\xff\xff" + good[6:]: "more samples"}
    for data, match in cases.items():
        with pytest.raises(ValueError, match=match):
            api.decompress(data, strict=strict, device="cpu")
        with pytest.raises(ValueError, match=match):
            rev0.header(data)
        path = tmp_path / "bad.llcomp"
        path.write_bytes(data)
        for cmd in ("decompress", "info"):
            assert cli.main([cmd, str(path)]) == 1
            assert match in capsys.readouterr().err
    # the bound admits the most compressible stream: a constant image
    flat = np.full((64, 64, 4), 7, np.uint8)
    blob = rev0.encode(flat)
    assert flat.size > 100 * (len(blob) - 6)
    assert rev0.header(blob) == (4, 64, 64)
    out, bad = api.decompress(blob, strict=False, device="cpu")
    assert bad == [] and np.array_equal(out, flat)


def test_revision_0_checks_the_backend():
    img = make_photo(4, 4)
    blob = rev0.encode(img)
    for bad in ("xla", "pallas"):
        with pytest.raises(ValueError, match="backend must be one of"):
            api.compress(img, revision=0, backend=bad)
        with pytest.raises(ValueError, match="backend must be one of"):
            api.decompress(blob, backend=bad)
    # revision 0 runs on the host: every accepted backend gives its bytes
    for backend in api.BACKENDS + tuple(api.BACKEND_ALIASES):
        assert api.compress(img, revision=0, backend=backend) == blob
        np.testing.assert_array_equal(
            api.decompress(blob, backend=backend), img)
