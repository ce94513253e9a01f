"""llcomp_tpu_torch stands alone: it never imports JAX or llcomp_tpu, never
runs a CUDA request on the CPU, and chip_smoke.py's pinned goldens are the
bytes llcomp_tpu's native backend gives."""
from __future__ import annotations

import importlib
import pathlib
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import llcomp_tpu_torch
from llcomp_tpu_torch import (api, corpus, decode, distributed, encode,
                              graft_entry, parallel, seed)
from tests.conftest import make_photo

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "llcomp_tpu_torch"
FORBIDDEN = re.compile(r"import jax|from jax|llcomp_tpu\.")


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        llcomp_tpu_torch.__path__, "llcomp_tpu_torch."))


def test_sources_never_name_jax_or_the_jax_package():
    files = [p for p in PKG.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert len(files) >= 15
    names = {p.relative_to(PKG).as_posix() for p in files}
    assert {"cli.py", "corpus.py", "host.py", "rev0.py", "io/images.py",
            "native/build.py", "native/llcomp_host.cpp", "parallel.py",
            "distributed.py", "profiling.py", "graft_entry.py"} <= names
    for p in files + [ROOT / "chip_smoke.py"]:
        hits = FORBIDDEN.findall(p.read_text())
        assert not hits, f"{p.relative_to(ROOT)}: {hits}"


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert {"llcomp_tpu_torch.kernels.decode_kernel", "llcomp_tpu_torch.cli",
            "llcomp_tpu_torch.corpus", "llcomp_tpu_torch.host",
            "llcomp_tpu_torch.rev0", "llcomp_tpu_torch.io.images",
            "llcomp_tpu_torch.native.build", "llcomp_tpu_torch.parallel",
            "llcomp_tpu_torch.distributed", "llcomp_tpu_torch.profiling",
            "llcomp_tpu_torch.graft_entry"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'llcomp_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_without_cuda_raises(no_cuda):
    img = make_photo(8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compress(img, slices="auto")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.decompress(api.compress(img, slices=2, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode.encode_lanes(img[None], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.decode_lanes([b""], (8, 8, 3), device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seed.derive(img)
    for call in (lambda: parallel.compress_sharded(img, ["cuda:0"]),
                 lambda: parallel.decode_lanes_sharded([b""], (8, 8, 3),
                                                       ["cpu", "cuda"]),
                 lambda: corpus.compress_corpus([img], mesh=["cuda:0"]),
                 lambda: distributed.compress_image_pod(img),
                 lambda: distributed.compress_corpus_distributed([img]),
                 lambda: graft_entry.entry()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    """Alone in a directory (or on a host without CUDA) the script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_goldens_equal_native_backend():
    from llcomp_tpu import api as japi
    from llcomp_tpu import host
    from llcomp_tpu import seed as jseed

    cs = importlib.import_module("chip_smoke")
    tiled, h, w, tiled_seed = cs.TILED
    for name, img in (
            ("photo512", cs.make_image(512, 512, 3, 1512)),
            ("photo2048", cs.make_image(2048, 2048, 3, 3048)),
            (tiled, cs.make_image(h, w, 3, tiled_seed))):
        assert cs.sha(img) == cs.IMAGE_SHA[name]
        blob = japi.compress(img, slices="auto", backend="native")
        assert cs.sha(blob) == cs.GOLDEN_SHA[name], name
    imgs = cs.bench_images(100)
    lanes = cs.bench_lanes(imgs)
    assert lanes.shape == (1024, 8, 512, 3)
    assert cs.sha(lanes) == cs.IMAGE_SHA["batch"]
    tab = jseed.derive_pooled(imgs[:8])
    np.testing.assert_array_equal(seed.derive_pooled(imgs[:8], device="cpu"),
                                  tab)
    streams = host.encode_images(lanes, seed=tab)
    assert cs.sha(b"".join(streams)) == cs.GOLDEN_SHA["batch"]
