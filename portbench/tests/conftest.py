"""Shared pieces of the benchmark's CPU tests: a tiny cell of each entry,
the harness run through ``device="cpu"`` (the kernels' plain versions)."""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

# two widths and a short last stripe: 7 stripes a corpus at 8 rows
TINY_IMAGES = [{"shape": [16, 24, 3], "count": 2},
               {"shape": [21, 16, 3], "count": 1}]


def tiny_spec(cell: str) -> harness.Spec:
    """The cell of BENCHMARK.json with its corpus cut to ``TINY_IMAGES``,
    no warm call, every call held and every stripe compared."""
    spec = harness.Spec.load(cell)
    spec.config = {"images": TINY_IMAGES}
    spec.work = dict(spec.work, pool=2, warm_calls=0, keep_share=1.0,
                     ref_lanes=64)
    return spec


@pytest.fixture
def run_tiny():
    """-> run(cell, seed) -> (result, checks) of one call on the CPU."""
    def run(cell: str, seed: int = 2 ** 31 + 11, traced: bool = False):
        return harness.measure(tiny_spec(cell), seed, 0.0, traced, "cpu",
                               log=lambda msg: None)
    return run
