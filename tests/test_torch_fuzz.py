"""Property fuzz of llcomp_tpu_torch: the draws of ``tests/test_fuzz.py``
(random shapes, channels and content) through every engine of the port on
the CPU (the kernels' plain versions) and through its native runtime,
against the JAX package's NumPy oracle; and the smallest of
``chip_smoke.py`` phase 11's fuzz cases through its own check here.
Tolerance: exact bytes and pixels."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from llcomp_tpu import oracle
from llcomp_tpu_torch import decode, encode, host
from llcomp_tpu_torch import seed as seedmod

cs = importlib.import_module("chip_smoke")

SEEDS = range(10)
PRIMED_SEEDS = range(6)


def fuzz_image(seed: int) -> np.ndarray:
    """``test_fuzz_roundtrip``'s image of ``seed``: 1-19 x 1-19 x 1-4,
    noise, flat or a clipped random walk along rows by ``seed % 3``."""
    rng = np.random.default_rng(seed)
    h = int(rng.integers(1, 20))
    w = int(rng.integers(1, 20))
    c = int(rng.choice([1, 2, 3, 4]))
    style = seed % 3
    if style == 0:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if style == 1:
        return np.full((h, w, c), int(rng.integers(0, 256)), np.uint8)
    base = rng.integers(0, 256)
    return np.clip(base + np.cumsum(rng.integers(-2, 3, (h, w, c)), axis=1),
                   0, 255).astype(np.uint8)


def fuzz_primed_image(seed: int) -> np.ndarray:
    """``test_fuzz_roundtrip_primed``'s image of ``seed``: 1-15 x 1-15 x
    1, 3 or 4, noise or a clipped random walk down columns."""
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(1, 16))
    w = int(rng.integers(1, 16))
    c = int(rng.choice([1, 3, 4]))
    if seed % 2 == 0:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return np.clip(rng.integers(0, 256)
                   + np.cumsum(rng.integers(-3, 4, (h, w, c)), axis=0),
                   0, 255).astype(np.uint8)


def fuzz_corpus() -> list[tuple[np.ndarray, bool]]:
    """Every fuzz image with whether it is coded primed."""
    return ([(fuzz_image(s), False) for s in SEEDS]
            + [(fuzz_primed_image(s), True) for s in PRIMED_SEEDS])


def check_engines(img: np.ndarray, want: bytes, primed: bool) -> None:
    """Each encode of the port equals ``want``; kernel 2's plain version
    decodes it exactly."""
    engines = [{"engine": "fused"}, {"engine": "sort"}]
    if not primed:
        engines.append({"engine": "sort", "variant": "decision"})
    for kw in engines:
        got = encode.encode_lanes(img[None], primed=primed, device="cpu",
                                  **kw)[0]
        assert got == want, (kw, img.shape)
    assert host.encode_stream(img, primed=primed) == want, ("native",
                                                            img.shape)
    out = decode.decode_lanes([want], img.shape, primed=primed, device="cpu")
    np.testing.assert_array_equal(out[0], img)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_roundtrip(seed):
    img = fuzz_image(seed)
    check_engines(img, oracle.encode(img)[6:], primed=False)


@pytest.mark.parametrize("seed", PRIMED_SEEDS)
def test_fuzz_roundtrip_primed(seed):
    img = fuzz_primed_image(seed)
    want = oracle.encode_planes(oracle.rct_forward(img), primed=True)
    check_engines(img, want, primed=True)


def test_chip_fuzz_cases_cover_their_draws():
    """Phase 11's cases: at least 200; h and w over 1-40, C over 1-5;
    every style with every start; rows within, on and across 16-byte
    words."""
    cases = [cs.fuzz_case(s) for s in cs.FUZZ_SEEDS]
    assert len(cases) >= 200
    h, w, c = (np.array(v) for v in zip(*(img.shape for img, _ in cases)))
    assert (h.min(), h.max(), w.min(), w.max()) == (1, 40, 1, 40)
    assert set(c) == {1, 2, 3, 4, 5}
    assert {(s % 3, start) for s, (_, start) in zip(cs.FUZZ_SEEDS, cases)} \
        == {(k, start) for k in range(3) for start in cs.FUZZ_STARTS}
    row = w * c
    assert (row < 16).any() and (row % 16 == 0).any() and (row > 32).any()
    flat = [img for s, (img, _) in zip(cs.FUZZ_SEEDS, cases) if s % 3 == 1]
    assert all((img == img.flat[0]).all() for img in flat)


# the smallest phase 11 cases of each style, each start among them
@pytest.mark.parametrize("seed", [10, 14, 15, 45, 125, 184])
def test_chip_fuzz_case_on_the_cpu(seed):
    """``chip_smoke.fuzz_check`` on the CPU, and the runtime's stream it
    holds the engines to equal to the oracle's."""
    img, start = cs.fuzz_case(seed)
    tab = seedmod.derive(img, device="cpu") if start == "seeded" else None
    want = oracle.encode_planes(oracle.rct_forward(img),
                                primed=start == "primed", seed=tab)
    assert host.encode_stream(img, primed=start == "primed", seed=tab) == want
    r = cs.fuzz_check(torch, torch.device("cpu"), seed)
    assert r["plain"] and r["symbols"] == img.size
