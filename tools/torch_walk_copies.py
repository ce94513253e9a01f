#!/usr/bin/env python3
"""The port's two walks (kernels 3 and 6, ``llcomp_tpu_torch/csrc/
walk_symbols.cu`` and ``walk_probs.cu``) beside edited copies of their
sources, on one CUDA GPU.

Usage, from the root of a checkout, on a machine with a CUDA GPU and
``nvcc``:

    python3 tools/torch_walk_copies.py

Each copy is the shipped source with a few edits (``chip_smoke.build_copy``),
run on the inputs the sort engine gives the kernel for the bench batch
(``chip_smoke``'s seeded 1,024 lanes for kernel 3, unprimed for kernel 6)
and timed in turns with the shipped kernel, 3 rounds (CUDA events,
``chip_smoke._time_cuda``).  Two kinds:

- designs not taken, whose output must equal the shipped kernel's:
  kernel 3 with its row update as shifts, masks and selects in place of
  byte permutes; either kernel with its state table copied once a lane,
  so that a lane always reads its own bank; kernel 3 coding every quad,
  without the warp vote that skips a quad no lane needs; kernel 6 with its
  inputs staged by ``cp.async`` in a ring of 4 stages of 8 rows a warp in
  shared memory in place of the register ring;
- ablations, whose output is not the kernel's and is not compared, at one
  chunk a lane (the whole lane one chain): without the stores (a sum
  stands in), with each input read from the lane's first 64 rows (cached),
  and with an integer function of the state in place of the state table's
  lookup; beside the shipped kernel at one chunk a lane.

Prints the card, each copy's registers, then one line a kernel: ms of each
copy in each round.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

ONE_CHUNK = ("constexpr int kChunks = 64;", "constexpr int kChunks = 1;")

SELECT_STEP = (
    """  const uint32_t c = ctx & 3;
  const uint32_t put = valid ? ((5 + bit) ^ c) << (4 * c) : 0u;
  const uint32_t f = static_cast<uint32_t>(
      fused[__byte_perm(rlo, rhi, ctx) & 0xFF]);
  rlo = __byte_perm(rlo, f, 0x3210u ^ (ctx < 4 ? put : 0u));
  rhi = __byte_perm(rhi, f, 0x3210u ^ (ctx < 4 ? 0u : put));""",
    """  const bool upper = ctx >= 4;
  const int sh = (ctx & 3) * 8;
  const uint32_t word = upper ? rhi : rlo;
  const uint32_t f = static_cast<uint32_t>(fused[(word >> sh) & 0xFF]);
  const uint32_t ns = (f >> (8 + 8 * bit)) & 0xFF;
  const uint32_t moved = (word & ~(0xFFu << sh)) | (ns << sh);
  rlo = valid && !upper ? moved : rlo;
  rhi = valid && upper ? moved : rhi;""")

TABLE_A_LANE_3 = [
    ("  __shared__ int32_t s_fused[128];\n",
     "  __shared__ int32_t s_fused[128 * kWarp];\n"),
    ("  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = "
     "fused[i];",
     "  for (int i = threadIdx.x; i < 128 * kWarp; i += blockDim.x)\n"
     "    s_fused[i] = fused[i / kWarp];"),
    ("      fused[__byte_perm(rlo, rhi, ctx) & 0xFF]);",
     "      fused[(__byte_perm(rlo, rhi, ctx) & 0xFF) * kWarp]);"),
    ("""          qlo = sym.code(rlo, rhi, 4 * q, s_fused);
          qlo |= sym.code(rlo, rhi, 4 * q + 1, s_fused) << 10;
          qhi = sym.code(rlo, rhi, 4 * q + 2, s_fused);
          qhi |= sym.code(rlo, rhi, 4 * q + 3, s_fused) << 10;""",
     """          const int32_t* tab = s_fused + threadIdx.x % kWarp;
          qlo = sym.code(rlo, rhi, 4 * q, tab);
          qlo |= sym.code(rlo, rhi, 4 * q + 1, tab) << 10;
          qhi = sym.code(rlo, rhi, 4 * q + 2, tab);
          qhi |= sym.code(rlo, rhi, 4 * q + 3, tab) << 10;"""),
]
TABLE_A_LANE_6 = [
    ("  __shared__ int32_t s_fused[128];\n",
     "  __shared__ int32_t s_fused[128 * kWarp];\n"),
    ("  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = "
     "fused[i];",
     "  for (int i = threadIdx.x; i < 128 * kWarp; i += blockDim.x)\n"
     "    s_fused[i] = fused[i / kWarp];"),
    ("      const int32_t f = s_fused[st];",
     "      const int32_t f = s_fused[st * kWarp + threadIdx.x % kWarp];"),
]
CP_ASYNC_RING = [
    ("constexpr int32_t kSeg = 2;\n",
     "constexpr int32_t kSeg = 2;\nconstexpr int kStages = 4, kRowsA = 8;\n"),
    ("""  int32_t xv[kDepth];                                // slot k: entry t0 + k
#pragma unroll
  for (int k = 0; k < kDepth; ++k) xv[k] = load_x(first + k);
  bool on = c == 0;                                  // walking, not skipping
  int32_t st = 0;
  for (int t0 = first; __any_sync(kFull, !done); t0 += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int t = t0 + k;
      const int32_t x = xv[k];
      const bool seg = x & kSeg;
      done = done || (t >= end && seg);              // the next chunk's
      on = on || seg;
      xv[k] = load_x(t + kDepth);                    // walked kDepth on
""", """  (void)load_x;
  __shared__ int32_t s_x[kWarps][kStages][kRowsA][kWarp];
  int32_t (*ring)[kRowsA][kWarp] = s_x[threadIdx.x / kWarp];
  const int l = threadIdx.x % kWarp;
  auto stage_in = [&](int stage) {
    const int t0 = first + stage * kRowsA;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      if (!done && t0 + r < T) {
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(&ring[stage % kStages][r][l]));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(dst),
                     "l"(xl + (t0 + r) * s));
      }
    }
    asm volatile("cp.async.commit_group;\\n" ::);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage_in(k);
  bool on = c == 0;
  int32_t st = 0;
  for (int stage = 0; __any_sync(kFull, !done); ++stage) {
    stage_in(stage + kStages - 1);
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(kStages - 1));
    const int t0 = first + stage * kRowsA;
#pragma unroll
    for (int k = 0; k < kRowsA; ++k) {
      const int t = t0 + k;
      const int32_t x = t < T ? ring[stage % kStages][k][l] : kSeg;
      const bool seg = x & kSeg;
      done = done || (t >= end && seg);
      on = on || seg;
"""),
]
NO_STORES_3 = [
    ("  uint32_t rlo = 0, rhi = 0;\n",
     "  uint32_t rlo = 0, rhi = 0, sink = 0;\n"),
    ("""        if (walk) {
          lo[(q0 + q) * s + lane] = static_cast<int32_t>(qlo);
          hi[(q0 + q) * s + lane] = static_cast<int32_t>(qhi);
        }""", "        sink += walk ? qlo ^ qhi : 0;"),
    ("      }\n    }\n  }\n}\n\n}  // namespace",
     "      }\n    }\n  }\n  if (sink == 0x7FFFFFFFu) lo[0] = sink;\n}\n\n"
     "}  // namespace"),
]
NO_STORES_6 = [
    ("  int32_t st = 0;\n", "  int32_t st = 0, sink = 0;\n"),
    ("      if (on && !done) pl[t * s] = f & 0xFF;",
     "      sink += on && !done ? f : 0;"),
    ("      st = (f >> ((x & 1) ? 16 : 8)) & 0xFF;\n    }\n  }\n}",
     "      st = (f >> ((x & 1) ? 16 : 8)) & 0xFF;\n    }\n  }\n"
     "  if (sink == 0x7FFFFFFF) pl[0] = sink;\n}"),
]
CACHED_3 = [("    return !done && j < n ? xl[j * s] : kSeg;",
             "    return !done && j < n ? xl[(j & 63) * s] : kSeg;")]
CACHED_6 = [("    return !done && t < T ? xl[t * s] : kSeg;",
             "    return !done && t < T ? xl[(t & 63) * s] : kSeg;")]
STAND_IN_3 = [("      fused[__byte_perm(rlo, rhi, ctx) & 0xFF]);",
               "      ((__byte_perm(rlo, rhi, ctx) & 0x7F) * 0x01030507u)"
               " & 0x7F7F7Fu);")]
STAND_IN_6 = [("      const int32_t f = s_fused[st];",
               "      const int32_t f = (st * 0x01030507) & 0x7F7F7F;")]

# name -> {tag: (edits, output compared)}
COPIES = {
    "walk_symbols": {
        "select step": ([SELECT_STEP], True),
        "table a lane": (TABLE_A_LANE_3, True),
        "no warp vote": ([("        if (__any_sync(kFull, 4 * q < nb)) {"
                           "         // the same in a warp", "        {")],
                         True),
        "C 1": ([ONE_CHUNK], True),
        "C 1 no stores": ([ONE_CHUNK, *NO_STORES_3], False),
        "C 1 cached inputs": ([ONE_CHUNK, *CACHED_3], False),
        "C 1 lookup stand-in": ([ONE_CHUNK, *STAND_IN_3], False),
    },
    "walk_probs": {
        "table a lane": (TABLE_A_LANE_6, True),
        "cp.async ring": (CP_ASYNC_RING, True),
        "C 1": ([ONE_CHUNK], True),
        "C 1 no stores": ([ONE_CHUNK, *NO_STORES_6], False),
        "C 1 cached inputs": ([ONE_CHUNK, *CACHED_6], False),
        "C 1 lookup stand-in": ([ONE_CHUNK, *STAND_IN_6], False),
    },
}


def main() -> int:
    import torch

    from llcomp_tpu_torch import encode, seed
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    if not torch.cuda.is_available():
        print("torch_walk_copies: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    keys = [(name, tag) for name, tags in COPIES.items() for tag in tags]
    with ThreadPoolExecutor(len(keys)) as pool:
        built = dict(zip(keys, pool.map(
            lambda k: cs.build_copy(*k, COPIES[k[0]][k[1]][0]), keys)))
    for (name, tag), (_, report) in built.items():
        regs, spill = cs.registers(report)[f"{name}_kernel"]
        print(f"{name} {tag}: {regs} registers, {spill} B spilled")

    dev = torch.device("cuda")
    imgs = cs.bench_images(100)
    tab = seed.derive_pooled(imgs[:8], device=dev)
    lanes = torch.from_numpy(cs.bench_lanes(imgs)).to(dev)
    _, made, _ = cs._stage_run(torch, encode._encode_sort, lanes, tab,
                               keep=True)
    K, _ = made["precompute and counts"]
    xs3, _ = made["sym sort"]
    want3 = made["walk"]
    _, made, _ = cs._stage_run(torch, encode._encode_decision, lanes, None,
                               keep=True)
    (xs6,), want6 = made["walk xs"], made["walk"]
    runs = {"walk_symbols": (lambda: ek.walk_symbols(xs3, K, tab), want3),
            "walk_probs": (lambda: (ek.walk_probs(xs6),), want6)}
    for name, (run, want) in runs.items():
        ms = {"shipped": []}
        for _ in range(3):
            ms["shipped"].append(cs._time_cuda(torch, run))
            for tag, (_, compared) in COPIES[name].items():
                with cs.running(name, built[name, tag][0]):
                    if compared:
                        err = max(cs._max_err(a, b)
                                  for a, b in zip(run(), want))
                        cs.check(err == 0, f"{name} {tag}: output != the "
                                 f"shipped kernel's ({err})")
                    ms.setdefault(tag, []).append(cs._time_cuda(torch, run))
        print(f"{name} ms in turns, 3 rounds (designs not taken equal to the "
              "shipped output; ablations at C 1 not compared): " + "; ".join(
                  f"{tag} " + ", ".join(f"{t:.4f}" for t in v)
                  for tag, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.Failed as e:
        print(f"torch_walk_copies FAILED: {e}", file=sys.stderr)
        sys.exit(1)
