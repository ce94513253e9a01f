"""llcomp_tpu_torch.api.reencode_slice (device='cpu', the kernels' plain
versions) against llcomp_tpu's native backend: a healed container equals
the one ``llcomp_tpu.api.compress`` gives, on plain, primed, seeded and
tiled containers; the aliases and the lazy exports.  Tolerance: exact."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import llcomp_tpu_torch
from llcomp_tpu import api as japi
from llcomp_tpu import container as jcont
from llcomp_tpu_torch import api, container
from tests.conftest import make_photo

ROOT = pathlib.Path(__file__).resolve().parents[1]

# image, compress arguments, the slice to corrupt and heal
CASES = {
    "plain": (make_photo(16, 8, seed=1), {"slices": 4, "primed": False}, 2),
    "primed": (make_photo(16, 8, seed=2), {"slices": 4, "primed": True}, 1),
    "seeded": (make_photo(16, 8, seed=11), {"slices": 4, "seeded": True}, 1),
    "tiled": (make_photo(16, 24, seed=15),
              {"slices": "auto", "tile_w": 10}, 3),
}


def _corrupt(blob: bytes, k: int) -> bytes:
    """``blob`` with slice ``k``'s payload XORed, repacked (its crc then
    matches the bad bytes, as a stale writer would leave it)."""
    streams, W, H, C, sh, flags, seed_blob, tw = jcont.unpack_sliced(blob)
    bad = list(streams)
    bad[k] = bytes(b ^ 0xFF for b in bad[k])
    return jcont.pack_sliced(bad, W, H, C, sh, flags=flags,
                             seed_blob=seed_blob, tile_w=tw)


@pytest.mark.parametrize("name", list(CASES))
def test_reencode_heals_to_the_native_container(name):
    img, kw, k = CASES[name]
    want = japi.compress(img, backend="native", **kw)
    broken = _corrupt(want, k)
    assert broken != want
    streams, W, H, C, sh, flags, _, tw = container.unpack_sliced(want)
    if name == "tiled":
        assert tw == 10 and sh == 8 and len(streams) == 6
    if name == "seeded":
        assert flags & container.FLAG_SEEDED
    y0, y1, x0, x1 = container.tile_regions(W, H, sh, tw)[k]
    healed = api.reencode_slice(broken, k, img[y0:y1, x0:x1], device="cpu")
    assert healed == want


def test_reencode_slice_validates_args():
    img = make_photo(32, 16)
    blob = japi.compress(img, slices=4, backend="native")
    with pytest.raises(IndexError):
        api.reencode_slice(blob, 9, img[:8], device="cpu")
    with pytest.raises(IndexError):
        api.reencode_slice(blob, -1, img[:8], device="cpu")
    with pytest.raises(ValueError, match="stripe shape"):
        api.reencode_slice(blob, 0, img[:4], device="cpu")
    tiled_img, kw, k = CASES["tiled"]
    tiled = japi.compress(tiled_img, backend="native", **kw)
    with pytest.raises(ValueError, match="stripe shape"):  # full width
        api.reencode_slice(tiled, k, tiled_img[8:16], device="cpu")
    with pytest.raises(ValueError, match="Invalid magic"):
        api.reencode_slice(japi.compress(img, backend="native"), 0, img[:8],
                           device="cpu")


def test_aliases_equal_the_reference_and_export_lazily():
    for name in ("compress", "decompress", "compress_sliced",
                 "decompress_sliced", "reencode_slice"):
        assert getattr(llcomp_tpu_torch, name) is getattr(api, name)
    img = make_photo(8, 6, seed=3)
    blob = llcomp_tpu_torch.compress_sliced(img, slices=2, device="cpu")
    assert blob == japi.compress(img, slices=2, backend="native")
    np.testing.assert_array_equal(
        llcomp_tpu_torch.decompress_sliced(blob, backend="native"), img)
    code = ("import sys, llcomp_tpu_torch\n"
            "assert 'llcomp_tpu_torch.api' not in sys.modules\n"
            "assert 'torch' not in sys.modules\n"
            "llcomp_tpu_torch.reencode_slice\n"
            "assert 'llcomp_tpu_torch.api' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
