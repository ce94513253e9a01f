#!/usr/bin/env python3
"""Kernel sources built in this checkout and in another, compared
instruction for instruction in their SASS.

Each source (``llcomp_tpu_torch/csrc/<name>.cu``) of each checkout is built
by ``nvcc`` with the port's flags (``kernels.build.NVCC_FLAGS``), that
checkout's ``csrc/`` on the include path and the given ``-D`` defines, and
disassembled by ``cuobjdump -sass``.  For every kernel function the script
prints its instruction count in each build and whether the two lists of
instructions (opcode and operands; addresses and branch labels as
``cuobjdump`` numbers them) are equal, with the first difference where
they are not.

Usage, from the root of a checkout, on a machine with ``nvcc`` (unpack the
other commit with ``git archive`` into the ignored ``_checkout/`` first)::

    python3 tools/torch_sass_diff.py --parent _checkout/parent \\
        walk_symbols build_stream [--defines -DLLCT_E_LIM=3 ...]

Prints one line a kernel and a last JSON line; exits 1 where a kernel's
SASS differs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from llcomp_tpu_torch.kernels import build  # noqa: E402


def kernels(tree: pathlib.Path, name: str, defines: list, out: pathlib.Path
            ) -> dict:
    """{kernel: [instruction]} of ``tree``'s ``csrc/<name>.cu``."""
    csrc = tree / "llcomp_tpu_torch" / "csrc"
    so = out / f"{name}_{tree.name}_{len(list(out.iterdir()))}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *defines, "-I",
                    str(csrc), "-o", str(so), str(csrc / f"{name}.cu")],
                   check=True, capture_output=True)
    return {k: [ins for _, ins in body]
            for k, (body, _) in cs.sass_functions(cs.sass(so)).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+", help="sources of csrc/, no suffix")
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="the other checkout's root")
    ap.add_argument("--defines", nargs="*", default=[],
                    help="-D flags of both builds")
    a = ap.parse_args()
    report, same = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for name in a.names:
            mine = kernels(ROOT, name, a.defines, pathlib.Path(tmp))
            theirs = kernels(a.parent.resolve(), name, a.defines,
                             pathlib.Path(tmp))
            for k in sorted(set(mine) | set(theirs)):
                x, y = mine.get(k, []), theirs.get(k, [])
                equal = x == y
                same &= equal
                first = next((i for i, (p, q) in enumerate(zip(x, y))
                              if p != q), min(len(x), len(y)))
                report[f"{name} {k}"] = {"instructions": len(x),
                                         "parent": len(y), "equal": equal}
                print(f"{name} {k}: {len(x)} instructions, the parent's "
                      f"{len(y)}: " + ("equal, instruction for instruction"
                                       if equal else
                                       f"differ from instruction {first} "
                                       f"({x[first:first + 1]} against "
                                       f"{y[first:first + 1]})"), flush=True)
    print(json.dumps({"defines": a.defines, "kernels": report}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
