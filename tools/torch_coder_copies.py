#!/usr/bin/env python3
"""The port's three range coders (kernels 4, 7 and 8,
``llcomp_tpu_torch/csrc/coder_scan.cu``) beside edited copies of their
source, on one CUDA GPU, with the instructions a coded record takes in
each one's compiled loop.

Usage, from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``:

    python3 tools/torch_coder_copies.py [--parent DIR] [--sass DIR]

The copies are ``chip_smoke``'s copies of ``coder_scan.cu``
(``chip_smoke.VARIANTS``: kernel 7 with other lanes a block and ring
depths, kernels 4 and 8 with other hand-over batches and stages) and this
script's ablations of kernels 4 and 8, each the shipped source with an
edit (``chip_smoke.build_copy``); ``--parent DIR`` adds the
``coder_scan.cu`` of another checkout as copy "parent" (the kernels before
an edit, timed in turns with it).  Every copy but the ablations is held
against the plain versions on ragged record sets (T rows around every
depth and hand-over, 1, 33 and 130 lanes, 0xFF runs, dead lanes and
tails) and against the shipped kernel on the inputs the sort engine gives
each coder for the bench batch (``chip_smoke``'s seeded 1,024 lanes for
kernel 4, unprimed for kernels 7 and 8), exact, and timed there in turns
with the shipped kernel, ``ROUNDS`` rounds (CUDA events,
``chip_smoke._time_cuda``).

The instruction count reads the library's SASS (``cuobjdump -sass``): for
each coder kernel, its innermost loops that code records, each with its
instructions, the records one pass codes (counted by the shared-memory
stores of a split kernel's rng warp, the shared-memory loads of its other
warp, else the global stores: one a record, two in kernel 8) and the most
frequent opcodes.  ``--sass DIR`` also writes each library's whole SASS to
``DIR``.

Prints the card, each copy's registers and SASS counts, then one line a
kernel: ms of each copy in each round.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

ROUNDS = 3
# Ablations, whose output is not the kernel's and is not compared: kernels
# 4 and 8 with their stores kept behind a test that never passes (the work
# kept, no store made), with each input read from the lane's first two
# batches (cached), and both.
_NO_STORES = {
    "coder_scan": (
        "      store_if(ml, slot_meta(f, emit), live && in);\n"
        "      store_if(rl, f.run, live && in);",
        "      store_if(ml, 0, (slot_meta(f, emit) ^ f.run) == -7);"),
    "coder_scan_off_q": (
        "      store_if(kl, off_record(o, f, emit), live && in);",
        "      store_if(kl, 0, off_record(o, f, emit) == -7);"),
}
_CACHED = {
    "coder_scan": (
        "const size_t at = static_cast<size_t>(b) * kBatch * s + lane;",
        "const size_t at = static_cast<size_t>(b & 1) * kBatch * s + lane;"),
    "coder_scan_off_q": (
        "const size_t at = static_cast<size_t>(b) * kRows * s + lane;",
        "const size_t at = static_cast<size_t>(b & 1) * kRows * s + lane;"),
}
# a ring-only kernel 8 (a parent's) stores two words a record, the
# others one
STORES_A_RECORD = {"coder_scan_kernel": 2}
# ragged rows of every copy's case set: around depths 1-32 and hand-overs
# of 16-32 records
ROWS = (1, 2, 3, 5, 7, 9, 15, 17, 31, 33, 43, 65, 67)


def copies() -> dict:
    """tag -> (edits, the coders it is timed as, output compared):
    ``chip_smoke``'s copies of ``coder_scan.cu`` (each timed as the coders
    ``chip_smoke.CODER_TAGS`` gives it) and the ablations of kernels 4
    and 8."""
    out = {tag: (edits if isinstance(edits, list) else [edits],
                 tuple(n for n in cs.CODERS if tag in cs.CODER_TAGS[n]),
                 True)
           for (src, tag), edits in cs.VARIANTS.items()
           if src == "coder_scan"}
    for name in _NO_STORES:
        for tag, edits in (("no stores", [_NO_STORES[name]]),
                           ("cached inputs", [_CACHED[name]]),
                           ("cached no stores", [_NO_STORES[name],
                                                 _CACHED[name]])):
            out[f"{name} {tag}"] = (edits, (name,), False)
    return out


def record_loops(text: str) -> dict:
    """SASS text -> {kernel: [(first address, instructions, records a pass,
    opcode counts), ...]}: each kernel's innermost loops that code
    records."""
    out = {}
    for fn, (ins, labels) in cs.sass_functions(text).items():
        for a, b in cs.inner_loops(ins, labels):
            ops = collections.Counter(cs.sass_opcode(t) for x, t in ins
                                      if a <= x <= b)
            recs = ops["STS"] or ops["LDS"] or (
                ops["STG"] // STORES_A_RECORD.get(fn, 1))
            if recs:
                out.setdefault(fn, []).append(
                    (a, sum(ops.values()), recs, ops))
    return out


def sass_line(tag: str, text: str) -> str:
    """One line a copy: each coder loop's instructions a record."""
    parts = []
    for fn, loops in record_loops(text).items():
        for a, n, recs, ops in loops:
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
            parts.append(f"{fn} loop@{a:#x}: {n} instructions, {recs} "
                         f"records, {n / recs:.2f} a record ({top})")
    return f"SASS {tag}: " + "; ".join(parts)


def case_set(torch, name: str, dev) -> list:
    """Coder ``name``'s ragged inputs on the card: ``ROWS`` rows at 1, 33
    and 130 lanes, 0xFF runs, dead lanes and tails."""
    per = cs.CODERS[name][1]
    long = cs.off_record_cases(1, per)
    recs = [cs.skewed_recs(T * per, S, seed=T + S)
            for T in ROWS for S in (1, 33, 130)]
    recs += [long["0xFF runs"], long["dead lanes and tails"]]
    return [tuple(torch.from_numpy(a).to(dev)
                  for a in (cs.pack_quads(r) if per == 4
                            else (r.astype(np.int32),)))
            for r in recs]


def main() -> int:
    import torch

    from llcomp_tpu_torch import encode, seed
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="a checkout whose coder_scan.cu is copy 'parent'")
    ap.add_argument("--sass", type=pathlib.Path,
                    help="write each library's SASS to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_coder_copies: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    table = copies()
    with ThreadPoolExecutor(len(table) + 1) as pool:
        built = dict(zip(table, pool.map(
            lambda tag: cs.build_copy("coder_scan", tag, table[tag][0]),
            table)))
        shipped = pool.submit(build.build, "coder_scan").result()
    libs = {"shipped": (shipped, build.compiler_log("coder_scan"))}
    libs.update(built)
    if args.parent:
        src = args.parent / "llcomp_tpu_torch" / "csrc" / "coder_scan.cu"
        so = build.BUILD_DIR / "variant_coder_scan_parent.so"
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                            str(src)], capture_output=True, text=True,
                           check=True)
        libs["parent"] = (so, r.stderr)
        table["parent"] = ([], tuple(cs.CODERS), True)
    table["shipped"] = ([], tuple(cs.CODERS), True)
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
    for tag, (so, report) in libs.items():
        regs = cs.registers(report)
        print(f"{tag}: registers, spilled B: " + ", ".join(
            f"{k} {r} {sp}" for k, (r, sp) in regs.items()))
        text = cs.sass(so)
        if args.sass:
            (args.sass / f"coder_scan_{tag.replace(' ', '_')}.sass"
             ).write_text(text)
        print(sass_line(tag, text), flush=True)

    dev = torch.device("cuda")
    n_cases = 0
    for name in cs.CODERS:
        kernel, plain = getattr(ek, name), getattr(ek, f"{name}_plain")
        cases = case_set(torch, name, dev)
        want = [plain(*c) for c in cases]
        for tag, (so, _) in libs.items():
            if name not in table[tag][1] or not table[tag][2]:
                continue
            with cs.running("coder_scan", so):
                for c, w in zip(cases, want):
                    err = max(cs._max_err(a, b) for a, b in zip(kernel(*c), w))
                    cs.check(err == 0, f"{name} {tag}: != plain ({err})")
                    n_cases += 1
    print(f"every copy == plain on its coders' ragged cases: {n_cases} "
          f"cases (rows {ROWS} at 1, 33, 130 lanes, 0xFF runs, dead lanes "
          "and tails)", flush=True)

    imgs = cs.bench_images(100)
    tab = seed.derive_pooled(imgs[:8], device=dev)
    lanes = torch.from_numpy(cs.bench_lanes(imgs)).to(dev)
    _, made, _ = cs._stage_run(torch, encode._encode_sort, lanes, tab,
                               keep=True)
    quads = made["compact sort"]
    _, made, _ = cs._stage_run(torch, encode._encode_decision, lanes, None,
                               keep=True)
    (cx,) = made["back sort"]
    inputs = {"coder_scan_off_q": quads, "coder_scan_off": (cx,),
              "coder_scan": (cx,)}
    for name, a in inputs.items():
        kernel = getattr(ek, name)
        run = (lambda k=kernel, a=a: k(*a))
        want = run()
        tags = [t for t in libs if name in table[t][1]]
        ms = {t: [] for t in tags}
        for _ in range(ROUNDS):
            for tag in tags:
                with cs.running("coder_scan", libs[tag][0]):
                    if table[tag][2]:
                        err = max(cs._max_err(x, y)
                                  for x, y in zip(run(), want))
                        cs.check(err == 0, f"{name} {tag}: output != the "
                                 f"shipped kernel's ({err})")
                    ms[tag].append(cs._time_cuda(torch, run))
        shape = "x".join(str(d) for d in a[0].shape)
        print(f"{name} [{shape}] ms in turns, {ROUNDS} rounds (every "
              "copy's output but the ablations' equal to the shipped "
              "kernel's): " + "; ".join(
                  f"{tag} " + ", ".join(f"{t:.4f}" for t in v)
                  for tag, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.Failed as e:
        print(f"torch_coder_copies FAILED: {e}", file=sys.stderr)
        sys.exit(1)
