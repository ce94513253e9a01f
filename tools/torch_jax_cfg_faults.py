#!/usr/bin/env python3
"""The JAX package's engines under custom codec configurations, on the CPU.

Prints, for each cfg, whether ``llcomp_tpu.encode.encode_lanes`` with the
fused Pallas kernel (``engine="fused"``) and the sort chain
(``engine="pallas"``) give ``llcomp_tpu.oracle``'s bytes, and whether
``decode_lanes(engine="pallas")`` (the decode kernel) decodes the oracle's
streams exactly; then ``api.compress(backend="jax")``'s automatic priming
at 16 and 4 substates and its own ``decompress``.  The faults it shows are
the ones ``llcomp_tpu_torch`` does not copy (``ROADMAP.md`` section 3).

Usage, from the root of the repository (the Pallas kernels run in
interpret mode; a few minutes)::

    JAX_PLATFORMS=cpu python3 tools/torch_jax_cfg_faults.py
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from llcomp_tpu import api as japi  # noqa: E402
from llcomp_tpu import container as jcont  # noqa: E402
from llcomp_tpu import decode as jdec  # noqa: E402
from llcomp_tpu import encode as jenc  # noqa: E402
from llcomp_tpu import oracle  # noqa: E402
from llcomp_tpu.core.config import CodecConfig  # noqa: E402
from tests.conftest import make_photo  # noqa: E402

LANES = (np.random.default_rng(0).integers(0, 40, (3, 8, 12, 3))
         + np.arange(12)[None, None, :, None] * 4).astype(np.uint8)
CFGS = {"small model": dict(large_model=False),
        "e3 r5 s6": dict(e_lim=3, r_lim=5, sign_ctx=6),
        "substates 4": dict(substates=4, e_lim=2, r_lim=3, sign_ctx=3),
        "substates 16": dict(substates=16, e_lim=8, r_lim=12, sign_ctx=15)}


def main() -> None:
    for name, kw in CFGS.items():
        cfg = CodecConfig(**kw)
        want = [oracle.encode(lane, cfg)[6:] for lane in LANES]
        for engine in ("fused", "pallas"):
            got = jenc.encode_lanes(LANES, cfg, engine=engine)
            print(f"{name}: encode_lanes(engine={engine!r}) "
                  f"{'==' if got == want else '!='} oracle", flush=True)
        out, bad = jdec.decode_lanes(want, LANES.shape[1:], cfg,
                                     engine="pallas", errors="report")
        print(f"{name}: decode_lanes(engine='pallas') flags {bad}, pixels "
              f"{'exact' if np.array_equal(out, LANES) else 'not exact'}",
              flush=True)
    img = make_photo(40, 24, seed=0)
    for name in ("substates 16", "substates 4"):
        cfg = CodecConfig(**CFGS[name])
        blob = japi.compress(img, slices=5, cfg=cfg, backend="jax")
        try:
            back = japi.decompress(blob, cfg=cfg, backend="jax")
            flags = jcont.unpack_sliced(blob, cfg)[5]
            said = ("exact" if np.array_equal(back, img)
                    else "gives another image, no error")
            print(f"{name}: compress(slices=5) flags {flags:#x}, its "
                  f"decompress {said}", flush=True)
        except ValueError as e:
            print(f"{name}: compress(slices=5), its decompress raises "
                  f"ValueError: {e}", flush=True)


if __name__ == "__main__":
    main()
