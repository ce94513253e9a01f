"""llcomp_tpu_torch.distributed against llcomp_tpu.distributed: the span
maths, the single-process forms, and real 2- and 4-process runs over gloo
on localhost, every rank's container equal to the one llcomp_tpu builds in
one process.  Tolerance: exact.

Run as a script, this file is one rank of such a run (``spawn`` starts
them): ``python tests/test_torch_distributed.py ADDR N RANK BACKEND DEVICE
IMAGE.npy [CORPUS.npz] OUT.json``.  It imports no JAX, so ``chip_smoke.py``
starts its ranks the same way on the card.
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from llcomp_tpu_torch import api, distributed  # noqa: E402
from llcomp_tpu_torch.device import guard  # noqa: E402

WORKER_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, img: np.ndarray, tmp: pathlib.Path, backend: str = "gloo",
          device: str = "cpu", corpus=None, mode: str = "pod",
          timeout: float = WORKER_TIMEOUT_S) -> list[dict]:
    """Run ``n`` ranks of this file on one localhost group -> each rank's
    result (``worker``'s JSON).  Raises RuntimeError with a rank's exit
    code and the tail of its stderr where one fails or outlasts
    ``timeout``; every rank is ended before returning."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.save(tmp / "img.npy", img)
    extra = []
    if corpus is not None:
        np.savez(tmp / "corpus.npz", *corpus)
        extra = [str(tmp / "corpus.npz")]
    addr = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), addr, str(n),
         str(r), backend, device, mode, str(tmp / "img.npy"), *extra,
         str(tmp / f"rank{r}.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(n)]
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                raise RuntimeError(f"rank {r} outlasted {timeout} s: "
                                   f"{err.decode(errors='replace')[-2000:]}")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}: "
                                   f"{err.decode(errors='replace')[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(n)]


def worker(argv: list[str]) -> None:
    """One rank: ``mode`` 'pod' compresses the image with
    ``compress_image_pod`` (and, given a corpus, runs
    ``compress_corpus_distributed`` on it); 'gather' runs
    ``_allgather_streams`` on fixed streams, which this rank holds all of.
    Writes its results as JSON."""
    addr, n, rank, backend, device, mode, img_path, *rest = argv
    *corpus_path, out = rest
    torch.set_num_threads(1)
    distributed.initialize(addr, int(n), int(rank), backend=backend)
    try:
        res: dict = {"rank": dist.get_rank(), "world": dist.get_world_size()}
        if mode == "gather":
            streams = [bytes(range(k, 3 * k + 5)) for k in range(7)] + [b""]
            with guard(torch.device(device)):
                got = distributed._allgather_streams(streams, len(streams), 0)
            res["equal"] = got == streams
        else:
            img = np.load(img_path)
            t0 = time.perf_counter()
            res["pod"] = distributed.compress_image_pod(
                img, slice_h=8, device=device).hex()
            res["pod_s"] = time.perf_counter() - t0
            if corpus_path:
                with np.load(corpus_path[0]) as z:
                    imgs = [z[k] for k in sorted(z.files,
                                                 key=lambda k: int(k[4:]))]
                span, blobs, _ = distributed.compress_corpus_distributed(
                    imgs, slice_h=8, device=device)
                res["span"], res["blobs"] = list(span), [b.hex()
                                                        for b in blobs]
        pathlib.Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


import pytest  # noqa: E402


def make_photo(*args, **kw) -> np.ndarray:
    """``tests.conftest.make_photo``, imported on first use: ``spawn`` is
    also imported by ``chip_smoke.py``, which must not load the conftest's
    JAX."""
    from tests.conftest import make_photo

    return make_photo(*args, **kw)


def _jax_container(img: np.ndarray, slice_h: int = 8) -> bytes:
    """The container of ``img``'s stripes as llcomp_tpu builds it in one
    process: ``api.encode_stripes`` and ``container.pack_sliced``, primed
    by ``api._pick_primed``, CRC, no seed."""
    from llcomp_tpu import api as japi
    from llcomp_tpu import container as jcont
    from llcomp_tpu.core.config import REV2

    H, W, C = img.shape
    bounds = jcont.slice_bounds(H, slice_h)
    primed = len(bounds) > 1 and japi._pick_primed(img, REV2)
    streams = japi.encode_stripes(img, bounds, REV2, primed)
    return jcont.pack_sliced(
        streams, W, H, C, slice_h, REV2,
        flags=(jcont.FLAG_PRIMED if primed else 0) | jcont.FLAG_CRC)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
def test_corpus_span_equals_the_jax_span(count):
    from llcomp_tpu import distributed as jdist

    for n in range(13):
        spans = [distributed.corpus_span(n, p, count) for p in range(count)]
        assert spans == [jdist.corpus_span(n, p, count)
                         for p in range(count)]
        assert [i for a, b in spans for i in range(a, b)] == list(range(n))
    assert distributed.corpus_span(2, 3, 4) == (2, 2)      # empty tail span
    assert distributed.corpus_span(10) == (0, 10)          # no group: 0 of 1


def test_single_process_forms_equal_the_jax_package():
    from llcomp_tpu import distributed as jdist

    img = make_photo(32, 16)
    blob = distributed.compress_image_pod(img, slice_h=8, device="cpu")
    assert blob == jdist.compress_image_pod(img, slice_h=8)
    np.testing.assert_array_equal(api.decompress(blob, backend="native"), img)
    imgs = [make_photo(16, 16, seed=i) for i in range(3)]
    span, blobs, stats = distributed.compress_corpus_distributed(
        imgs, 8, device="cpu")
    want = jdist.compress_corpus_distributed(imgs, 8)
    assert span == want[0] == (0, 3) and blobs == want[1]
    assert stats.images == 3


def test_allgather_without_a_group_is_the_identity():
    s = [b"abc", b"", b"xy"]
    assert distributed._allgather_streams(s, 3, 0) == s
    with pytest.raises(ValueError, match="must hold all"):
        distributed._allgather_streams(s[:2], 3, 0)
    distributed.initialize()          # no address, no count: a no-op
    assert not dist.is_initialized()


def test_two_processes_over_gloo(tmp_path):
    """Both ranks pack one container, equal to llcomp_tpu's; the corpus's
    spans are 2 and 2, their blobs llcomp_tpu's corpus's."""
    from llcomp_tpu import distributed as jdist

    img = make_photo(32, 16, seed=3)
    imgs = [make_photo(8 + 4 * i, 16, seed=40 + i) for i in range(4)]
    res = spawn(2, img, tmp_path, corpus=imgs)
    assert [r["world"] for r in res] == [2, 2]
    pods = {bytes.fromhex(r["pod"]) for r in res}
    assert pods == {_jax_container(img)}
    assert pods == {distributed.compress_image_pod(img, device="cpu")}
    assert [tuple(r["span"]) for r in res] == [(0, 2), (2, 4)]
    got = [bytes.fromhex(b) for r in res for b in r["blobs"]]
    for r in range(2):
        lo, hi = jdist.corpus_span(4, r, 2)
        want = jdist.compress_corpus_distributed(imgs[lo:hi], 8)[1]
        assert got[lo:hi] == want


def test_four_processes_with_unequal_spans(tmp_path):
    """H = 44: 6 stripes over 4 ranks, the last stripe 4 rows; corpus_span
    gives spans of 2/2/2/0 (ceil(6/4) = 2 a rank), so rank 3 encodes
    nothing and still joins both gathers.  Every rank's container equals
    llcomp_tpu's."""
    img = make_photo(44, 16, seed=3)
    assert [b - a for a, b in (distributed.corpus_span(6, p, 4)
                               for p in range(4))] == [2, 2, 2, 0]
    res = spawn(4, img, tmp_path)
    blobs = {bytes.fromhex(r["pod"]) for r in res}
    assert blobs == {_jax_container(img)}
    np.testing.assert_array_equal(
        api.decompress(blobs.pop(), backend="native"), img)
