#!/usr/bin/env python3
"""Kernel 5 (the decision variant's stream builder,
``llcomp_tpu_torch/csrc/build_stream.cu``) and probe pH (the carry-coupled
staging probe, ``csrc/probe_mosaic3.cu``) beside edited copies of their
sources, on one CUDA GPU, with the instructions a slot takes in kernel 5's
compiled loops.

Usage, from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``:

    python3 tools/torch_stream_copies.py [--sass DIR]

The copies are ``chip_smoke``'s (``chip_smoke.VARIANTS``): kernel 5 as
one thread a slot (the design it replaced, ``tools/designs/``), with
tiles of other sizes and with scalar stores; pH as one block (the design
it replaced) and at each cluster size.  This script adds pH with the words
sent to one leader block, and pH with its words sent by ``st.async`` onto
each block's transaction barrier in place of the cluster barrier (a
design not taken, ``tools/designs/``), both compared; and pH's
ablations, whose output is not compared: only lane 0 live (the chain of
one lane's dependent loads and the barrier, on the full plane), no lane
live (the barrier, the reductions and the carry alone), the barrier's
arrive without its release, and one block with ``__syncthreads`` in
place of the cluster barrier, at the shipped cluster rule and at other
sizes.  Kernel 5 also runs with its step written as selects (compared).

Kernel 5 runs on the inputs the decision variant gives it for
``chip_smoke``'s unprimed bench batch (1,024 lanes x 12,288 symbols, K
24); every copy's output equals the shipped kernel's, which equals
``build_stream_plain``; ms in turns, ``ROUNDS`` rounds (CUDA events,
``chip_smoke._time_cuda``).  pH runs at ``PH_LANES`` lanes and T in
``PH_STEPS`` with and without the window through ``probes.run_probe``;
every copy but the ablations is exact against ``pH_stage_plain``
(outputs and planes of random words); ns a step in turns, ``ROUNDS``
rounds.

The instruction count reads each library's SASS (``cuobjdump -sass``):
for kernel 5's K 24 instantiation (the one-thread copy's only kernel), its
innermost loops that store slots, each with its instructions, the slots
one pass stores (4 a 16-byte store, 1 a 4-byte store) and the most
frequent opcodes, and the calls it makes (a 64-bit division is a call).
``--sass DIR`` also writes each library's whole SASS to ``DIR``.
"""
from __future__ import annotations

import argparse
import contextlib
import collections
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

ROUNDS = 3
PH_LANES = (1, 128, 1024)
PH_STEPS = (256, 512)
_LIVE = "  const bool live = t < per && l < lanes;\n"
_ARRIVE = 'asm volatile("barrier.cluster.arrive.release;" ::: "memory");'
_WAIT = 'asm volatile("barrier.cluster.wait.acquire;" ::: "memory");'
# pH's ablations: (edits, cluster sizes or None for the shipped rule)
PH_ABLATIONS = {
    "lane 0 live": ([(_LIVE, "  const bool live = t < per && l == 0;\n")],
                    (None, 1, 16)),
    "no lane live": ([(_LIVE, "  const bool live = false;\n")],
                     (None, 1, 8, 16)),
    # the barrier's arrive without its release (the words' visibility no
    # longer ordered: a measurement of the fence, not a kernel)
    "relaxed arrive": ([(_ARRIVE, _ARRIVE.replace("release", "relaxed"))],
                       (None, 1)),
    # one block: __syncthreads in place of the cluster barrier
    "block barrier": ([(_ARRIVE, ""), (_WAIT, "__syncthreads();")], (1,)),
}
# pH's words sent to block 0 alone and read from it after the barrier (a
# leader block, in place of a copy in every block; compared)
PH_LEADER = [
    ("""  int32_t* to = lane < blocks ? cluster.map_shared_rank(&red[0][gw], lane)
                              : nullptr;""",
     """  int32_t* to = lane == 0 ? cluster.map_shared_rank(&red[0][gw], 0)
                         : nullptr;"""),
    ("static_cast<uint32_t>(red[s & 1][lane])",
     "static_cast<uint32_t>(*cluster.map_shared_rank(&red[s & 1][lane], 0))"),
    # block 0 stays until every block has read its last words
    ("    for (int i = 0; i < 8; ++i) out[i * n + l] = carry;\n  }\n",
     "    for (int i = 0; i < 8; ++i) out[i * n + l] = carry;\n  }\n"
     "  cluster.sync();\n"),
]
# kernel 5's step as selects in place of slot()'s branches (a measurement
# of the branches; compared, as the same arithmetic)
K5_SELECTS = [(
    """  if (!t.live || !(k == 0 || (nz && (in_exp || is_stop || in_mant ||
                                     is_sign))))
    return -1;
  int ctx = 0, bit;
  if (k == 0) {
    bit = !nz;
  } else if (in_exp) {
    ctx = min(k, 4);
    bit = 1;
  } else if (is_stop) {
    ctx = min(e + 1, 4);
    bit = 0;
  } else if (in_mant) {
    ctx = min(k - e + 3, 6);
    bit = (ad >> min(max(2 * e + 1 - k, 0), 30)) & 1;
  } else {
    ctx = 7;
    bit = t.neg;
  }
  return t.h16 + ctx * 2 + bit;""",
    """  const bool valid = t.live && (k == 0 || (nz && (in_exp || is_stop ||
                                                  in_mant || is_sign)));
  const int ctx = k == 0 ? 0 : in_exp ? min(k, 4) : is_stop ? min(e + 1, 4)
                : in_mant ? min(k - e + 3, 6) : 7;
  const int bit = k == 0 ? !nz : in_exp ? 1 : is_stop ? 0
                : in_mant ? (ad >> min(max(2 * e + 1 - k, 0), 30)) & 1
                : t.neg;
  return valid ? t.h16 + ctx * 2 + bit : -1;""")]


def ph_copies() -> dict:
    """tag -> (edits, compared): ``chip_smoke``'s copies of pH and this
    script's ablations."""
    out = {tag: (edits, True) for (src, tag), edits in cs.VARIANTS.items()
           if src == "probe_mosaic3"}
    out["leader block"] = (PH_LEADER, True)
    out["st.async hand-off"] = (cs.DESIGNS / "probe_mosaic3_st_async.cu",
                                True)
    for name, (edits, sizes) in PH_ABLATIONS.items():
        for c in sizes:
            rule = [] if c is None else [
                (cs._PH_RULE, f"  const int pick = {c};\n")]
            out[name + ("" if c is None else f" cluster {c}")] = (
                edits + rule, False)
    return out


def slot_loops(text: str, kernel: str) -> list:
    """SASS text -> [(first address, instructions, slots a pass, calls,
    opcode counts)] of kernel ``kernel``'s innermost loops that store to
    global memory: 4 slots a 16-byte store, 1 a 4-byte one."""
    ins, labels = cs.sass_functions(text).get(kernel, ([], {}))
    out = []
    for a, b in cs.inner_loops(ins, labels):
        body = [t for x, t in ins if a <= x <= b]
        stores = [t for t in body if cs.sass_opcode(t) == "STG"]
        if stores:
            out.append((a, len(body),
                        sum(4 if ".128" in t else 1 for t in stores),
                        sum(cs.sass_opcode(t) == "CALL" for t in body),
                        collections.Counter(map(cs.sass_opcode, body))))
    return out


def sass_line(tag: str, text: str) -> str:
    """One line a copy: kernel 5's store loops, instructions a slot."""
    names = cs.sass_functions(text)
    kernel = next((k for k in ("build_stream_kernel<24>",
                               "build_stream_kernel") if k in names), None)
    parts = []
    for a, n, slots, calls, ops in slot_loops(text, kernel):
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
        parts.append(f"loop@{a:#x}: {n} instructions, {slots} slots, "
                     f"{n / slots:.2f} a slot, {calls} calls ({top})")
    return f"SASS {tag} {kernel}: " + "; ".join(parts)


def main() -> int:
    import torch

    from llcomp_tpu_torch import encode, probes
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.kernels import encode_kernels as ek
    from llcomp_tpu_torch.probes import mosaic3

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", type=pathlib.Path,
                    help="write each library's SASS to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_copies: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    k5 = {tag: edits for (src, tag), edits in cs.VARIANTS.items()
          if src == "build_stream"}
    k5["selects"] = K5_SELECTS
    ph = ph_copies()
    jobs = {("build_stream", t): e for t, e in k5.items()}
    jobs.update({("probe_mosaic3", t): e for t, (e, _) in ph.items()})
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        built = dict(zip(jobs, pool.map(
            lambda k: cs.build_copy(*k, jobs[k] if isinstance(
                jobs[k], (list, pathlib.Path)) else [jobs[k]]), jobs)))
        list(pool.map(build.build, ("build_stream", "probe_mosaic3")))
    for src in ("build_stream", "probe_mosaic3"):
        built[src, "shipped"] = (build.build(src), build.compiler_log(src))
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
    for (src, tag), (so, report) in sorted(built.items()):
        regs = cs.registers(report)
        print(f"{src} {tag}: registers, spilled B: " + ", ".join(
            f"{k} {r} {sp}" for k, (r, sp) in regs.items()
            if k.startswith(("build_stream_kernel", "stage_steps"))))
        if src == "build_stream":
            text = cs.sass(so)
            if args.sass:
                (args.sass / f"build_stream_{tag.replace(' ', '_')}.sass"
                 ).write_text(text)
            print(sass_line(tag, text), flush=True)

    dev = torch.device("cuda")
    lanes = torch.from_numpy(cs.bench_lanes(cs.bench_images(100))).to(dev)
    _, made, _ = cs._stage_run(torch, encode._encode_decision, lanes, None,
                               keep=True)
    K, _, h, diff = made["precompute and counts"]
    n = h.shape[1]

    def run():
        return ek.build_stream(h, diff, n, K)

    want = run()
    cs.check(torch.equal(want, ek.build_stream_plain(h, diff, n, K)),
             "build_stream != build_stream_plain on the engine's inputs")
    tags = ["shipped", *k5]
    ms = {t: [] for t in tags}
    for _ in range(ROUNDS):
        for tag in tags:
            ctx = (cs.running("build_stream", built["build_stream", tag][0])
                   if tag != "shipped" else contextlib.nullcontext())
            with ctx:
                cs.check(torch.equal(run(), want), f"build_stream {tag}: "
                         "output != the shipped kernel's")
                ms[tag].append(cs._time_cuda(torch, run))
    print(f"build_stream [{h.shape[0]}x{n}, K {K}] ms in turns, {ROUNDS} "
          f"rounds (every copy's output equal to the shipped kernel's, "
          f"equal to build_stream_plain): " + "; ".join(
              f"{tag} " + ", ".join(f"{t:.4f}" for t in v)
              for tag, v in ms.items()), flush=True)

    tags = ["shipped", *ph]
    for key in ("pHw", "pHn"):
        p = mosaic3.PROBES[key]
        for n_lanes in PH_LANES:
            for T in PH_STEPS:
                ns = {t: [] for t in tags}
                for _ in range(ROUNDS):
                    for tag in tags:
                        ctx = (cs.running("probe_mosaic3",
                                          built["probe_mosaic3", tag][0])
                               if tag != "shipped"
                               else contextlib.nullcontext())
                        compared = tag == "shipped" or ph[tag][1]
                        with ctx:
                            try:
                                r = probes.run_probe(p, dev, lanes=n_lanes,
                                                     T=T, check=compared)
                            except RuntimeError as e:
                                ns[tag].append(f"refused ({e})")
                                continue
                        if compared:
                            cs.check(r["err"] == 0, f"{key} {tag}, "
                                     f"{n_lanes} lanes, T {T}: != plain "
                                     f"({r['err']})")
                        ns[tag].append(r["ns_step"])
                print(f"{key} {n_lanes} lanes T {T}: ns a step in turns, "
                      f"{ROUNDS} rounds (every copy but the ablations "
                      f"exact against pH_stage_plain): " + "; ".join(
                          f"{tag} " + ", ".join(
                              f"{v:.1f}" if isinstance(v, float) else v
                              for v in vs) for tag, vs in ns.items()),
                      flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.Failed as e:
        print(f"torch_stream_copies FAILED: {e}", file=sys.stderr)
        sys.exit(1)
