#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llcomp_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with one CUDA GPU and
``nvcc``:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero without the final
``"ok": true`` line):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the ten kernel sources of ``llcomp_tpu_torch/csrc`` (the
   eight library kernels and the 21 probes), one nvcc each, in parallel,
   beside the copies of kernels 1-8 and probes p7-p11, pF, pG, pH and
   reduce that phases 5-8 time (``VARIANTS``); prints the registers a
   thread of
   kernels 1-8, the probes of ``probe_mosaic.cu`` and
   ``probe_mosaic2.cu``, pH and reduce and of the copies (every coder
   kernel of a copy of ``coder_scan.cu``, every instantiation of kernel 5
   and pH, p7-p11, pF, pG and reduce) from the
   compiler's ``-Xptxas -v`` report (a spill fails);
3. kernel vs plain: each CUDA kernel against its plain PyTorch version (run
   on CPU copies of the kernel's inputs, where its loops of small ops cost
   no launch; the kernel's outputs brought to the host) on small lane
   batches (photo, flat, noise, grayscale, RGBA, C = 2 and 5,
   1-row, 1-column, odd stride, context hashes repeating every 1 to 5
   symbols, 1, 33 and 130 lanes; unprimed, primed, seeded; dead symbol
   tails; flipped streams, streams cut inside a 16-byte word, garbage past
   every length), every instantiation of kernel 2 (C1-C4 and generic) must
   launch, and the three coders (kernels 4, 7 and 8) on random records
   with skewed bits, T around kernel 7's ring depth and kernels 4 and
   8's hand-overs between warps at 1, 33 and 130 lanes, deferred 0xFF
   runs past a hundred bytes, dead lanes and dead tails (kernel 4's
   records packed in quads: dead quads 0, dead records inside live
   quads); the walks (kernels 3 and 6) on synthetic context runs
   (``seg_cases``: a seg on every entry, on entry 0 only, on none, runs
   across chunks, a seg on every chunk start, a one-run tail) at T around
   their chunk count and 1, 33, 130 and 513 lanes; the tolerance is exact
   equality of bytes, lengths, planes, error flags, walk records, coder
   records and final carries;
4. main path: ``api.compress(img, slices="auto")`` + ``api.decompress`` on a
   512x512x3 and a 2048x2048x3 image; the ``.llct`` sha256 must equal the
   pinned golden (the bytes of ``llcomp_tpu``'s native backend) and the
   pixels must round-trip; both kernels' launch counters must move;
9. (run right after phase 4) the single-host surface: ``reencode_slice``
   heals a corrupted slice of phase 4's 512x512x3 container and of a tiled
   256x8192x3 one (reported by ``decompress(strict=False)``) on the card
   back to the pinned golden; the port's native C++ runtime builds, gives
   phase 4's goldens through ``backend="native"`` and is timed against the
   device engine at 1-128 stripes of 8x512x3 (the crossover behind
   ``api.MIN_DEVICE_LANES``); the four revision-0 goldens; a corpus of 24
   images (512x512x3, 256x256x4, grayscale, the tiled one) in batches of
   ``CORPUS_BATCH`` lanes through ``encode_lanes_pipelined``, every blob
   equal to ``backend="native"``'s, exact round trips, MP/s pipelined and
   in turn and the device idle share; and the CLI as subprocesses
   (selftest, .ppm and .pgm round trips, info, corpus --verify); kernel 1's
   and 2's launch counts are set to 0 before each part and read after; the
   phase fails past ``PHASE9_LIMIT_S`` seconds;
5. bench-size batch: 16 images of 512x512x3 in 8-row stripes (1,024 lanes x
   12,288 symbols), seeded from the first 8 images; the sha256 of the
   concatenated streams must equal the golden and the round trip be exact;
   encode and decode are timed (median of 3 fresh batches after a warm-up)
   with their host share, kernels 1 and 2 alone (us a symbol), beside
   copies of them built with other lanes a block (kernel 1 also with other
   look-ahead depths; at 1,024 lanes, and 2 lanes a block at 2,048) and
   kernel 1 without its decisions, each copy's output equal to the
   shipped kernel's; kernel 2 at C = 1 on channel 0, and each kernel
   beside its plain version on a stated subset;
10. (run right after phase 5) the multi-device and multi-process surface,
   on the device lists ``[cuda:0]``, ``[cuda:0, cuda:0]`` and, with
   several GPUs, every card: ``parallel.compress_sharded`` and
   ``decompress_sharded`` of phase 4's two images and the tiled one, with
   explicit slices equal to ``backend="native"``'s, with 'auto' exact at
   8 stripes a device (the tiled image its golden), a flipped slice
   refused by its crc; phase 5's batch through ``encode_lanes_sharded``
   and ``decode_lanes_sharded``: its golden, exact, one launch of kernels
   1 and 2 a shard, a corrupt stream named by its global lane, MP/s of
   ``SHARD_REPS`` fresh batches in turns with one ``encode_lanes`` /
   ``decode_lanes`` call, and kernel 1 on the whole batch against its
   halves on two side streams; ``POD_RANKS`` gloo ranks
   (``tests/test_torch_distributed.py`` as a script, each on cuda:0)
   packing photo512 with ``compress_image_pod`` (equal on every rank, to
   the call here and to the native backend) and running
   ``compress_corpus_distributed``, and one NCCL rank gathering CUDA
   streams; one profiled photo512 round trip under ``profiling.trace_to``
   (the stage labels and kernels 1 and 2 in the trace) and under
   ``LLCT_PROFILE=1`` (the stage report); ``graft_entry.entry`` on the
   card equal to the CPU's and ``dryrun_multichip(2, [cuda:0, cuda:0])``;
   the phase fails past ``PHASE10_LIMIT_S`` seconds;
6. the sort engine (``encode_lanes(engine="sort")``, kernels 3 and 4) on the
   same seeded batch: the same golden, an exact round trip through kernel 2,
   the unprimed batch and a worst-case batch byte-equal to the fused
   engine's, both kernels launched (and kernel 1 not), peak device memory
   within ``encode.lane_bytes``; timed end to end beside the fused engine,
   its device idle share and its ten largest device ops under
   ``torch.profiler``, split by stage; each kernel held exactly against its
   plain version on the inputs the engine gave it at this shape, and both
   timed, kernel 3 with its longest piece and thread walk and beside
   copies of it with other chunk counts and ring depths, kernel 4 beside
   copies of it with other hand-over batches and stages, each copy's
   output equal to the shipped kernel's;
7. the decision variant (``encode_lanes(engine="sort",
   variant="decision")``, kernels 5, 6 and 7) on the unprimed bench batch:
   streams equal to the fused engine's and the symbol variant's, also on
   the worst-case batch, an exact round trip through kernel 2, kernels 5-7
   launched (and 1, 3 and 4 not), peak device memory of a chunk within
   ``encode.lane_bytes``; timed end to end beside both other encodes on the
   same batches, its device idle share and largest ops, split by stage; on
   all 1,024 lanes in one chunk, kernels 5-8 held exactly against their
   plain versions on the inputs the engine gave them, and timed, kernel 5
   beside copies of it (one thread a slot, the design it replaced; other
   tiles; scalar stores), kernel 6
   (with its longest piece and thread walk) beside copies of it with other
   chunk counts and ring depths, kernel 7 beside copies of it with other
   lanes a block and ring depths and kernel 8 beside copies of it with
   other hand-over batches and stages, each copy's output equal to
   the shipped kernel's; kernel 8
   (``coder_scan``, the slot-record coder) run on its own path on the
   variant's coder records, through ``coder.finish_steps`` and
   ``coder.expand_slots``, must give the variant's streams;
8. the probes (``llcomp_tpu_torch.probes``, the 21 TPU probes of
   ``tools/``): each driven through ``probes.run_probe`` at the TPU probes'
   shape (128 lanes, a 15,872-row model plane), the stepped ones also at
   1,024 lanes and pH at T 32, 256 and 512, every wrapper launched; the
   time a launch and a symbol step, the one-shot probes' device time,
   each in turns with an empty kernel (the launch floor under their
   bounds, its share of the probe's time) and the library call in one
   profiler session, the reduce probe also with copies of it (a maximum
   on every slice, the design it replaced; one warp for the tile), pG
   with its (one block of a word a thread, the design it replaced; 8
   warps of an int4 a thread) and p11, at T 512 and 128 and 1,024 lanes,
   with its (the serial design it replaced; a register ring a lane; 8
   warps a block);
   each kernel held exactly against its plain version (outputs and model
   planes of random words, on inputs where the plain output differs across
   lanes or a plane changes); pH beside copies of it (one block, the
   design it replaced, and each cluster size), each exact, at 128 and
   1,024 lanes and T 32, 256 and 512, with and without the window; p7-p10
   and pF beside copies of them (the serial step they replaced, p7, p8
   and pF at other row ring depths, p9 unrolled, p10 and pF on the steps
   not taken, p8 with its rows stepped by additions), each exact against
   one plain output a case on p7's ring hazards (lanes whose every step
   lands on one row, planes of 2, 3 and 17 rows, T around each depth;
   p8's too), pF's (lanes whose every step lands on one pair, planes of
   4, 6 and 36 rows, T around each depth), p9's byte edges and 128 and
   1,024 lanes, timed in turns, with the SASS instructions of one
   decision, those to the ALU and the FMA pipe and its carried chain
   (``cuobjdump -sass``), those of one step of p8 and pF and their
   carried chain, those of a step of p11's loops and each copy's (its
   loads counted), the SM clock and the chain floors (p8's from the step
   of p11's serial copy); the reduce probe and its copies exact on
   ``reduce_cases`` (flushes at gaps of 4, of 5 and more, none; rows past
   a multiple of 32; 1, 33 and 128 lanes), p11 and its copies on
   ``p11_cases`` (nstage at and below 0 and past the lanes, T around a
   warp's 32 steps, planes of 2, 3 and 300 rows; 100, 128 and 1,024
   lanes) and pG and its copies on ``pG_cases`` (maxima of 100 and 101,
   in the head, int4 and tail words, wrapping at both ends of int32; 1 to
   8,192 words, x off a 16-byte boundary); the one PyTorch call that
   computes the same function, where there is one, timed and equal.

Phases 5-8 compute each kernel's bound (``bound``): the least time the
card could take for the bytes and integer operations of its work on this
run's inputs; a one-shot probe's row also carries that bound raised to the
launch floor (``launch_bound_ms``, ``launch_bound_by`` "launch" where the
floor wins).  The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Test images use integer arithmetic only
(a counter-based hash, no libm, no NumPy random streams), and their own
sha256 is pinned so a generator drift is told apart from a codec fault.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PROBE_SOURCES = ("probe_mosaic", "probe_mosaic2", "probe_mosaic3",
                 "probe_reduce")
KERNEL_SOURCES = ("encode_fused", "decode_kernel", "walk_symbols",
                  "coder_scan", "build_stream", "walk_probs", *PROBE_SOURCES)
# the main path's kernels, the walks and the range coders: phase 2 reads
# their registers and spills
PTXAS_SOURCES = ("encode_fused", "decode_kernel", "walk_symbols",
                 "walk_probs", "coder_scan", "build_stream", "probe_mosaic",
                 "probe_mosaic2", "probe_mosaic3", "probe_reduce")
# Copies of kernels 1-8 and probes p7-p11, pF, pG, pH and reduce that
# phases 5-8 time beside the shipped ones, each built from the shipped source
# with one edit (old, new): other lanes a block (kernels 1 and 7's constants,
# kernel 2's rule), other look-ahead depths of kernels 1, 3, 6 and 7,
# other chunk counts of the walks (kernels 3 and 6), other hand-over
# batches and stages of kernels 4 and 8, other tiles of kernel 5 and its
# scalar stores, other cluster sizes of pH, other row ring depths of p7,
# p8 and pF, p8 and pF with a warp's lanes spread over more blocks, p11
# and pG at 8 warps a block, p9 unrolled, p10 and pF on a step of fewer instructions, p10 on one split
# between the ALU and the FMA pipes, p8 with its rows stepped by
# additions, p11 as a serial loop a lane (the design it replaced) and as a
# register ring a lane (the measurements behind those choices; each
# includes its step or kernel from ``tools/designs/``), and kernel 1
# with each symbol's decisions replaced by one byte out (the split of a
# symbol's time); or a whole source of
# ``tools/designs/`` (a path): kernel 5 as one thread a slot, pH as one
# block, p7-p10 and pF as a serial step (the row loaded after the
# previous step's store, the shift-and-select decision), pG as one block
# of a word a thread and the reduce probe with a maximum on every slice,
# the designs they replaced, and the reduce probe as one warp, the design
# not taken.
_BLOCK, _DEPTH = "constexpr int kBlock = 1;", "constexpr int kDepth = 2;"
_RULE = "  return e;\n"       # the end of kernel 2's lanes_a_block
_CODER_BLOCK = "constexpr int kBlock = 32;"
_OFF_DEPTH = "constexpr int kOffDepth = 8;"
# kernels 4 and 8 (their step split across two warps): the shipped
# records a hand-over, batches in the hand-over ring and batches of input
# landing, and those of their copies
SPLIT_SHIPPED = {"kBatch": 32, "kStages": 4, "kInStages": 4}
SPLIT_COPIES = {"kBatch": (16,), "kStages": (2, 6), "kInStages": (2, 6)}
# the range coders: the constant that sets each one's records in flight
# (kernel 7's ring depth, the others' hand-over batch) and records a row of
# its input (kernel 4's rows are pair-packed quads)
CODERS = {"coder_scan_off_q": ("kBatch", 4),
          "coder_scan_off": ("kOffDepth", 1),
          "coder_scan": ("kBatch", 1)}
DESIGNS = pathlib.Path(__file__).resolve().parent / "tools" / "designs"
# kernel 5's tiles (symbols a block) and pH's cluster sizes (blocks), the
# shipped rule's text and each copy's
BUILD_TILES = (64, 128)
# residuals at kernel 5's exponent edges: 0, +-1, +-2, +-(2^11 - 1),
# +-2^11, +-4095 (the 11-bit clip) and past it
EDGE_RESIDUALS = np.array([0, 1, -1, 2, -2, 2047, -2047, 2048, -2048, 4095,
                           -4095, 4096, -4096, 5000, -5000, 1 << 20,
                           -(1 << 20), 1 << 30, -(1 << 30)], np.int32)
_TILE = "constexpr int kTile = 256;"
PH_CLUSTERS = (1, 2, 4, 8, 16)
_PH_RULE = "  const int pick = lanes > 512 ? 16 : 8;\n"
# p7's row ring depths: the shipped one and its copies'
ROW_SHIPPED, ROW_DEPTHS = 4, (2, 4, 8)
_ROW_DEPTH = f"constexpr int kRowDepth = {ROW_SHIPPED};"
# p8's and pF's: the shipped one and their copies'
STAGE_SHIPPED, STAGE_DEPTHS = 16, (2, 4, 8, 16, 32)
PAIR_SHIPPED, PAIR_DEPTHS = 4, (2, 3, 4, 8)
# the lanes a block of p8's and pF's copies that spread a launch's lanes
# over more SMs (the shipped kernels take kLaneBlock, a warp)
STEP_BLOCK = 8
_P9_LAUNCH = "  decisions_perm<false>\n      <<<"
_P10_LAUNCH = "  decisions_perm<true>\n      <<<"
_P8_LAUNCH = "  stage_only<StepRows>\n      <<<"
# p11's launch in the shipped entry point, which its copies replace by
# their own over every lane
_P11_LAUNCH = ("  if (blocks > 0)\n    stage_few<kFewWarps><<<blocks, block, 0, "
               "as_stream(stream)>>>(\n        in(idx), in(A), io(out), "
               "lanes, staged, T, warp_blocks, row);\n")
_WARP_GRID = "lane_blocks(lanes), kLaneBlock,"
# the walks' shipped chunk counts and ring depths, and those of their
# copies (kernel 3 spills at depth 32)
WALK_SHIPPED = {"walk_symbols": (64, 4), "walk_probs": (64, 16)}
WALK_COPIES = {"walk_symbols": {"C": (1, 8, 16, 32, 64), "D": (1, 4, 8, 16)},
               "walk_probs": {"C": (1, 8, 16, 32, 64),
                              "D": (1, 4, 8, 16, 32)}}
# the kernels of each copied source whose registers phase 2 prints
# (each kernel named by the start of its name)
COPIED_KERNEL = {"encode_fused": ("encode_fused_kernel",),
                 "coder_scan": ("coder_scan_off_q_kernel",
                                "coder_scan_off_kernel", "coder_scan_kernel"),
                 "walk_symbols": ("walk_symbols_kernel",),
                 "walk_probs": ("walk_probs_kernel",),
                 "build_stream": ("build_stream_kernel",),
                 "probe_mosaic": ("symbol_steps", "stage_only", "decisions",
                                  "stage_few"),
                 "probe_mosaic2": ("pair_steps",),
                 "probe_mosaic3": ("stage_steps", "scalar_gate"),
                 "probe_reduce": ("fill_flush",)}


def _include(design: str) -> tuple[str, str]:
    """The edit that includes ``tools/designs/<design>`` into a probe
    source's namespace."""
    return ("using namespace probe;\n",
            f"using namespace probe;\n#include \"{design}\"\n")


def _p10_step(design: str, kernel: str, args: str = "") -> list:
    """p10's copy on the step of ``tools/designs/<design>``: that file
    included into probe_mosaic.cu's namespace, its kernel ``kernel``
    launched for p10 with the extra arguments ``args``."""
    end = ("io(out), lanes, T);\n  return done();\n}\n\n"
           "extern \"C\" int llct_probe_p11")
    return [_include(design), (_P10_LAUNCH, f"  {kernel}\n      <<<"),
            *([(end, end.replace("T)", f"T{args})"))] if args else [])]


def _p11_copy(design: str, kernel: str) -> list:
    """p11's copy on the kernel ``kernel`` of ``tools/designs/<design>``:
    that file included into probe_mosaic.cu's namespace, its kernel
    launched for p11 over every lane, one thread a lane."""
    return [_include(design), (_P11_LAUNCH, (
        f"  {kernel}<<<lane_blocks(lanes), kLaneBlock, 0, "
        "as_stream(stream)>>>(\n      in(idx), in(A), io(out), lanes, rows, "
        "T, nstage);\n"))]


def _walk_variants() -> dict:
    """The walks' copies: each chunk count and ring depth of
    ``WALK_COPIES`` but the shipped one."""
    out = {}
    for name, (C, D) in WALK_SHIPPED.items():
        for key, const, ship in (("C", "kChunks", C), ("D", "kDepth", D)):
            out.update({(name, f"{key} {v}"): (
                f"constexpr int {const} = {ship};",
                f"constexpr int {const} = {v};")
                for v in WALK_COPIES[name][key] if v != ship})
    return out


def _split_variants() -> dict:
    """Kernels 4 and 8's copies: each hand-over batch and stage count of
    ``SPLIT_COPIES`` but the shipped one."""
    return {("coder_scan", f"{const} {v}"): (
        f"constexpr int {const} = {SPLIT_SHIPPED[const]};",
        f"constexpr int {const} = {v};")
        for const, values in SPLIT_COPIES.items()
        for v in values if v != SPLIT_SHIPPED[const]}


VARIANTS = {
    **{("encode_fused", f"{n} lanes"): (_BLOCK, f"constexpr int kBlock = {n};")
       for n in (32, 16, 8, 4, 2)},
    **{("decode_kernel", f"{n} lanes"): (_RULE, f"  *lanes = {n};\n{_RULE}")
       for n in (32, 16, 8, 4, 2, 1)},
    **{("encode_fused", f"depth {d}"): (_DEPTH, f"constexpr int kDepth = {d};")
       for d in (4, 8)},
    ("encode_fused", "no decisions"): (
        "code_symbol(c, w, xv[k], s_fused);",
        "w += static_cast<uint32_t>(xv[k]); "
        "c.put_byte(static_cast<uint32_t>(w));"),
    **{("coder_scan", f"{n} lanes"): (_CODER_BLOCK,
                                      f"constexpr int kBlock = {n};")
       for n in (1, 4)},
    **{("coder_scan", f"depth {d}"): (_OFF_DEPTH,
                                      f"constexpr int kOffDepth = {d};")
       for d in (1, 4, 16, 32)},
    **_split_variants(),
    **_walk_variants(),
    ("build_stream", "one thread a slot"):
        DESIGNS / "build_stream_slot_thread.cu",
    **{("build_stream", f"tile {n}"): (_TILE, f"constexpr int kTile = {n};")
       for n in BUILD_TILES},
    ("build_stream", "scalar stores"): ("constexpr bool kVector = true;",
                                        "constexpr bool kVector = false;"),
    ("probe_mosaic3", "one block"): DESIGNS / "probe_mosaic3_one_block.cu",
    **{("probe_mosaic3", f"cluster {c}"): (
        _PH_RULE, f"  const int pick = {c};\n") for c in PH_CLUSTERS},
    ("probe_mosaic", "serial step"): DESIGNS / "probe_mosaic_serial_step.cu",
    **{("probe_mosaic", f"depth {d}"): (
        _ROW_DEPTH, f"constexpr int kRowDepth = {d};")
       for d in ROW_DEPTHS if d != ROW_SHIPPED},
    ("probe_mosaic", "p9 unrolled"): (
        _P9_LAUNCH, _P9_LAUNCH.replace("false", "true")),
    ("probe_mosaic", "p10 split"): _p10_step("probe_p10_split_step.cuh",
                                             "decisions_split"),
    ("probe_mosaic", "p10 pipes"): _p10_step("probe_p10_pipes_step.cuh",
                                             "decisions_pipes", ", 1u"),
    **{("probe_mosaic", f"p8 depth {d}"): (
        f"constexpr int kStageDepth = {STAGE_SHIPPED};",
        f"constexpr int kStageDepth = {d};")
       for d in STAGE_DEPTHS if d != STAGE_SHIPPED},
    ("probe_mosaic", "p8 row step"): [
        _include("probe_p8_row_step.cuh"),
        (_P8_LAUNCH, _P8_LAUNCH.replace("StepRows", "StepRowsAdd"))],
    ("probe_mosaic", f"p8 {STEP_BLOCK} lanes"): (
        _P8_LAUNCH + _WARP_GRID, _P8_LAUNCH + _WARP_GRID.replace(
            "lane_blocks(lanes), kLaneBlock",
            f"(lanes + {STEP_BLOCK - 1}) / {STEP_BLOCK}, {STEP_BLOCK}")),
    ("probe_mosaic2", "serial step"): DESIGNS / "probe_mosaic2_serial_step.cu",
    **{("probe_mosaic2", f"pF depth {d}"): (
        f"constexpr int kPairDepth = {PAIR_SHIPPED};",
        f"constexpr int kPairDepth = {d};")
       for d in PAIR_DEPTHS if d != PAIR_SHIPPED},
    ("probe_mosaic2", f"pF {STEP_BLOCK} lanes"): (
        "pair_steps<<<" + _WARP_GRID, "pair_steps<<<" + _WARP_GRID.replace(
            "lane_blocks(lanes), kLaneBlock",
            f"(lanes + {STEP_BLOCK - 1}) / {STEP_BLOCK}, {STEP_BLOCK}")),
    ("probe_mosaic2", "pF split"): [
        _include("probe_p10_split_step.cuh"),
        ("decide24_perm<true>(wlo, whi, ctx, t);",
         "decide24_split(wlo, whi, ctx, t);")],
    ("probe_mosaic", "p11 serial"): _p11_copy("probe_p11_serial.cuh",
                                              "stage_few_serial"),
    ("probe_mosaic", "p11 ring"): _p11_copy("probe_p11_ring.cuh",
                                            "stage_few_ring"),
    ("probe_mosaic", "p11 8 warps"): ("constexpr int kFewWarps = 1;",
                                      "constexpr int kFewWarps = 8;"),
    ("probe_mosaic3", "pG block"): DESIGNS / "probe_pG_block.cu",
    ("probe_mosaic3", "pG 8 warps"): ("constexpr int kGateWarps = 1;",
                                      "constexpr int kGateWarps = 8;"),
    ("probe_reduce", "every slice"): DESIGNS / "probe_reduce_every_slice.cu",
    ("probe_reduce", "one warp"): DESIGNS / "probe_reduce_one_warp.cu",
}
# the copies of probe_mosaic.cu that p7-p10 are timed beside, of
# probe_mosaic2.cu that pF is, and of probe_reduce.cu that the reduce
# probe is
PROBE_TAGS = {"p7": ("serial step", *(f"depth {d}" for d in ROW_DEPTHS
                                      if d != ROW_SHIPPED)),
              "p8": ("serial step", *(f"p8 depth {d}" for d in STAGE_DEPTHS
                                      if d != STAGE_SHIPPED),
                     "p8 row step", f"p8 {STEP_BLOCK} lanes"),
              "p9": ("serial step", "p9 unrolled"),
              "p10": ("serial step", "p10 split", "p10 pipes"),
              "pF": ("serial step", *(f"pF depth {d}" for d in PAIR_DEPTHS
                                      if d != PAIR_SHIPPED), "pF split",
                     f"pF {STEP_BLOCK} lanes")}
REDUCE_TAGS = ("every slice", "one warp")
# p11's copies (the serial design it replaced; a register ring a lane, and
# a block of 8 warps, 8 staged lanes on one SM, the designs not taken) and
# pG's (one block of one word a thread, the design it replaced; 8 warps of
# one int4 a thread, the design not taken), each timed in turns with the
# shipped kernel and the empty launch in one profiler session; and pH's
# (one block, each cluster size)
P11_TAGS = ("p11 serial", "p11 ring", "p11 8 warps")
PG_TAGS = ("pG block", "pG 8 warps")
PH_TAGS = ("one block", *(f"cluster {c}" for c in PH_CLUSTERS))
# the copies of coder_scan.cu that each coder is timed beside
CODER_TAGS = {
    "coder_scan_off": ("1 lanes", "4 lanes",
                       *(f"depth {d}" for d in (1, 4, 16, 32))),
    **dict.fromkeys(("coder_scan_off_q", "coder_scan"),
                    tuple(tag for _, tag in _split_variants()))}

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once)
# over the H100 SXM's 3.35 TB/s, and its 32-bit integer operations over
# the card's int32 rate: 64 results a clock an SM (the CUDA C++
# Programming Guide's arithmetic throughput table, compute capability 9.0:
# add, multiply, shift, logic, compare) x 132 SMs x the SXM part's 1,980
# MHz boost clock = 16.7 T/s.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations a step, estimated from the kernels' loop bodies as
# floors (no count of the compiled instructions backs them): binarising
# a decision (its context and bit), the model state's update (byte out,
# state table, byte in), the coder's put (range split, select, compare), a
# record's packing; a symbol's unpacking and model-row access in encode,
# its neighbours, hash and prediction in decode.
OPS_DECISION, OPS_STATE, OPS_CODER, OPS_RECORD = 6, 6, 8, 4
OPS_SYMBOL_ENC, OPS_SYMBOL_DEC = 10, 40
# the probes: a stand-in decision, a staging step's row (multiply, add,
# modulo), a word staged
OPS_PROBE_DECISION, OPS_PROBE_ROW, OPS_PROBE_WORD = 12, 8, 2

# Each probe's row in the kernels line: its probe keys (the first one is
# timed and bounded at the TPU probe's shape for the row) and the Pallas
# kernel it replaces.
PROBE_ROWS = {
    "p0": (("p0",), "tools/probe_mosaic.py:74"),
    "p1": (("p1",), "tools/probe_mosaic.py:99"),
    "p2": (("p2",), "tools/probe_mosaic.py:124"),
    "p3": (("p3",), "tools/probe_mosaic.py:150"),
    "p4": (("p4",), "tools/probe_mosaic.py:176"),
    "p5": (("p5",), "tools/probe_mosaic.py:193"),
    "p6": (("p6",), "tools/probe_mosaic.py:221"),
    "p7": (("p7",), "tools/probe_mosaic.py:292"),
    "p8": (("p8",), "tools/probe_mosaic.py:337"),
    "p9": (("p9",), "tools/probe_mosaic.py:377"),
    "p10": (("p10",), "tools/probe_mosaic.py:409"),
    "p11": (("p11",), "tools/probe_mosaic.py:440"),
    "pA": (("pA",), "tools/probe_mosaic2.py:87"),
    "pB": (("pB",), "tools/probe_mosaic2.py:120"),
    "pC": (("pC",), "tools/probe_mosaic2.py:154"),
    "pD": (("pD8", "pD16"), "tools/probe_mosaic2.py:188"),
    "pE": (("pE16", "pE32"), "tools/probe_mosaic2.py:210"),
    "pF": (("pF",), "tools/probe_mosaic2.py:280"),
    "pG": (("pG",), "tools/probe_mosaic3.py:62"),
    "pH": (("pHw", "pHn"), "tools/probe_mosaic3.py:127"),
    "reduce": (("reduce",), "tools/probe_reduce.py:55"),
}
# The designs that p11's and pG's kernels replaced, kept as copies that
# phase 8 times in the same profiler session: their rows of the kernels
# line carry each one's source and device ms (replaced)
REPLACED = {"p11": ("p11 serial", "tools/designs/probe_p11_serial.cuh"),
            "pG": ("pG block", "tools/designs/probe_pG_block.cu")}
PROBE_LANES = (128, 1024)   # the TPU probes' lanes and the bench batch's
PH_STEPS = (32, 256, 512)
PROBE_ROUNDS = 10           # rounds of the stepped probes' copies in turns

# sha256 of the test images (generator check) and of the expected bytes
IMAGE_SHA = {
    "photo512":
        "c4322b8c128817a9b266bc32ad85370c8235fdd1964ae2d69d64b3fb940bdd39",
    "photo2048":
        "11d12dd74abeca8656254fffad3362443c77183b6e770dbe1c021a9e91ddeea1",
    "batch":
        "4f66aff073d30148f2dc38a009b61b2064015695b7574fa524a7db90e78f0d3e",
    "tiled8192":
        "2ae29720c6604c7768613e917eb7acf1e4d60baca1bb998045d364d38d305d4c",
}
GOLDEN_SHA = {
    "photo512":
        "297e2e42af81b99cc72f625125b9f5c194367b7f2d872f0c41205dab1c75a470",
    "photo2048":
        "db79cca10e503e158f928bc8f27b3a54bf44105551c040b51dc1050a79cf22a1",
    "batch":
        "b745711bf7f11a6c01455c6408cd89fa1abe76de655706fd0f4db8e105561e04",
    "tiled8192":
        "cee8f22798245fe970081eb830e54c51ddff98d1f757b7012423fb1ae1d0b099",
}
BENCH_IMAGES, BENCH_SIZE, BENCH_SLICE_H = 16, 512, 8
PLAIN_SUBSET_ROWS = 1   # rows of each bench stripe the plain versions time


def _hash64(seed: int, n: int) -> np.ndarray:
    """splitmix64 of (seed, 0..n-1): n pseudo-random uint64, integer only."""
    m = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        z = (np.arange(n, dtype=np.uint64)
             + np.full(n, seed, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return (z ^ (z >> np.uint64(31))) & m


def make_image(h: int, w: int, c: int = 3, seed: int = 0) -> np.ndarray:
    """Photo-like uint8 [h, w, c]: two triangle-wave gradients, a per-row
    random walk for texture and +-3 noise, from integer arithmetic only."""
    r = _hash64(seed, h * w * c).reshape(h, w, c)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]

    def tri(t, period):  # 0..128 and back over one period
        return np.abs((t % period) * 256 // period - 128)

    base = 40 + (tri(3 * x + y, 2 * w + 5) + tri(2 * y + x, h + w + 3)) * 3 // 4
    walk = np.cumsum((r >> np.uint64(8)).astype(np.int64) % 5 - 2, axis=1)
    noise = (r % np.uint64(7)).astype(np.int64) - 3
    img = (base[..., None] + 10 * np.arange(c, dtype=np.int64) + walk // 4
           + noise)
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_images(first_seed: int) -> list[np.ndarray]:
    return [make_image(BENCH_SIZE, BENCH_SIZE, 3, first_seed + i)
            for i in range(BENCH_IMAGES)]


def bench_lanes(imgs) -> np.ndarray:
    """Images -> [n_images * H/slice_h, slice_h, W, C] 8-row stripes."""
    H, W, C = imgs[0].shape
    return np.concatenate([im.reshape(H // BENCH_SLICE_H, BENCH_SLICE_H, W, C)
                           for im in imgs])


def sha(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def _malicious_stream() -> bytes:
    """An unterminated unary exponent (> 31 one-bits) under a zero model:
    decoding it must set the lane's error flag."""
    import torch

    from llcomp_tpu_torch.coder import Encoder
    from llcomp_tpu_torch.core import tables

    enc = Encoder(1, 256, "cpu")
    states = np.zeros(8, dtype=np.int64)
    for ctx, bit in [(0, 0)] + [(min(k, 4), 1) for k in range(1, 40)]:
        st = int(states[ctx])
        enc.put(torch.tensor([bit]), torch.tensor([int(tables.STATE_PROB[st])]),
                torch.tensor([True]))
        states[ctx] = tables.NEXT_STATE[st * 2 + bit]
    out, lens, _ = enc.finish()
    return out[0, : int(lens[0])].numpy().tobytes()


def _kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol: the function's own name
    (the last part of a nested name), with its template argument where it
    is an instantiation on an int or a bool (``decode_kernel<1>``, kernel
    2's channels, ``<0>`` the generic one; ``stage_steps<true>``)."""
    rest, names = re.sub(r"^_ZN?", "", mangled), []
    while m := re.match(r"\d+", rest):
        n = int(m[0])
        names.append(rest[len(m[0]):len(m[0]) + n])
        rest = rest[len(m[0]) + n:]
    name = names[-1] if names else mangled
    if arg := re.match(r"IL([ib])(\d+)E", rest):
        value = {"0": "false", "1": "true"}[arg[2]] if arg[1] == "b" else arg[2]
        return f"{name}<{value}>"
    return name


def registers(report: str) -> dict:
    """``-Xptxas -v`` report -> {kernel: (registers, spill bytes)}, each
    kernel named by ``_kernel_name``."""
    out, fn, spill = {}, None, 0
    for line in report.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m[1]
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out[_kernel_name(fn)] = (int(m[1]), spill)
    check(bool(out), "ptxas -v printed no registers")
    return out


def sass(so: pathlib.Path) -> str:
    """The library's SASS, by the toolkit's ``cuobjdump``."""
    from llcomp_tpu_torch.kernels import build

    tool = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def sass_opcode(text: str) -> str:
    """An instruction's opcode without predicate and modifiers."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def sass_functions(text: str) -> dict:
    """SASS text -> {kernel: ([(address, instruction)], {label:
    address})}, each kernel named by ``chip_smoke._kernel_name``."""
    fns, fn, pending = {}, None, []
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn, pending = _kernel_name(m[1]), []
            fns[fn] = ([], {})
        elif fn is None:
            continue
        elif m := re.match(r"\s*(\.L_x_\d+):", line):
            pending.append(m[1])
        elif m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line):
            addr = int(m[1], 16)
            ins, labels = fns[fn]
            labels.update({lb: addr for lb in pending})
            pending = []
            ins.append((addr, m[2]))
    return fns


def inner_loops(ins: list, labels: dict) -> list:
    """A kernel's innermost loops, [(first address, last address)]: each
    a branch back to an earlier address and what lies between, holding
    no other loop."""
    loops = []
    for addr, t in ins:
        if sass_opcode(t) != "BRA":
            continue
        m = re.search(r"(0x[0-9a-f]+)|`\((\.L_x_\d+)\)", t)
        target = (int(m[1], 16) if m and m[1]
                  else labels.get(m[2]) if m else None)
        if target is not None and target <= addr:
            loops.append((target, addr))
    return sorted({(a, b) for a, b in loops
                   if not any((c, d) != (a, b) and a <= c and d <= b
                              for c, d in loops)})


# Dependent-issue latency of an arithmetic instruction, in SM clocks: the
# CUDA C++ Programming Guide ("Multiprocessor Level": "typically 4 clock
# cycles" for most arithmetic instructions, stated for compute capability
# 7.x); no count of this card's own backs it.  A serial chain's floor is its
# dependent instructions times this over the SM clock.
ALU_LATENCY_CLOCKS = 4
# opcodes that write no register (stores, branches, barriers)
_NO_DEST = ("ST", "RED", "BRA", "EXIT", "BAR", "CALL", "RET", "NOP", "BSYNC",
            "BSSY", "WARPSYNC", "MEMBAR", "YIELD", "DEPBAR", "CCTL")


def _sass_regs(operand: str) -> list:
    """The registers and predicates an operand names (``R2.64``: R2, R3)."""
    regs = re.findall(r"\bU?[RP]\d+\b", operand)
    if m := re.search(r"\b(U?R)(\d+)\.64\b", operand):
        regs.append(f"{m[1]}{int(m[2]) + 1}")
    return regs


def sass_chain(body: list, passes: int = 16) -> tuple:
    """The dependent instructions one pass of a loop ``body`` (its SASS
    instructions in order) carries to the next: how much the longest chain
    of instructions each reading a register that the one before it wrote
    grows a pass, over the second half of ``passes`` passes in a row (the
    first half lets the chains that start in a pass settle); and the
    opcodes of that chain in its middle pass.  An instruction's first
    operand is its destination, and its second where that is a predicate
    (a compare's or a carry's); a predicated instruction also reads what
    it writes."""
    nodes, last, best = [], {}, None      # node: (depth, parent, pass, op)
    ends = []                             # the longest chain after a pass
    for p in range(passes):
        for text in body:
            guard = re.match(r"@!?(U?P\d)\s+", text)
            rest = text[guard.end():] if guard else text
            _, _, args = rest.partition(" ")
            ops = [a.strip() for a in args.split(",")] if args else []
            n = 0 if sass_opcode(rest).startswith(_NO_DEST) else (
                2 if len(ops) > 1 and re.fullmatch(r"U?P(\d|T)", ops[1])
                else 1)
            dests = [r for a in ops[:n] for r in _sass_regs(a)]
            reads = [r for a in ops[n:] for r in _sass_regs(a)]
            if guard:
                reads += [guard[1], *dests]
            parent = max((last[r] for r in reads if r in last),
                         key=lambda i: nodes[i][0], default=None)
            depth = 1 + (nodes[parent][0] if parent is not None else 0)
            nodes.append((depth, parent, p, sass_opcode(rest)))
            for r in dests:
                last[r] = len(nodes) - 1
            if best is None or depth > nodes[best][0]:
                best = len(nodes) - 1
        ends.append(nodes[best][0])
    chain, i = [], best
    while i is not None:
        if nodes[i][2] == passes // 2:
            chain.append(nodes[i][3])
        i = nodes[i][1]
    half = passes // 2
    return (ends[-1] - ends[half - 1]) / (passes - half), chain[::-1]


def build_copy(name: str, tag: str, edits) -> tuple[pathlib.Path, str]:
    """``csrc/<name>.cu`` with each edit (old, new) made, every old text
    found once, or the whole source at path ``edits``, built with the
    port's flags (``csrc/`` and ``tools/designs/`` on the include path)
    as copy ``tag``: (its library, the compiler's report)."""
    from llcomp_tpu_torch.kernels import build

    if isinstance(edits, pathlib.Path):
        src, edits = edits.read_text(), []
    else:
        src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        check(src.count(old) == 1, f"{name}.cu: the text of copy {tag!r} "
              "moved")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W", "_", f"variant_{name}_{tag}")
    cu = build.BUILD_DIR / f"{stem}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-I", str(DESIGNS), "-o", str(so),
                        str(cu)],
                       capture_output=True, text=True)
    check(r.returncode == 0, f"{name}.cu copy {tag!r} did not build:\n"
          + r.stderr[-3000:])
    return so, r.stderr


def build_variant(key: tuple[str, str]) -> tuple[pathlib.Path, str]:
    """The copy ``VARIANTS[key]``, built (``build_copy``)."""
    edits = VARIANTS[key]
    return build_copy(*key, edits if isinstance(edits, (list, pathlib.Path))
                      else [edits])


@contextlib.contextmanager
def running(name: str, so: pathlib.Path):
    """Inside the block, the wrapper of kernel ``name`` launches the library
    ``so`` (a ``build_variant``) in place of the shipped build."""
    from llcomp_tpu_torch.kernels import build

    build._libs[name] = ctypes.CDLL(str(so))
    try:
        yield
    finally:
        del build._libs[name]      # the next launch loads the shipped build


def repeat_lanes(shape) -> list[np.ndarray]:
    """Lanes of ``shape`` (H, W, C) whose context hash repeats at short
    distances: a constant lane (every symbol) and columns of period 2 to 5
    (every period x C symbols past the first rows)."""
    h, w, c = shape
    x = np.arange(w)[None, :, None]
    ch = 10 * np.arange(c)[None, None, :]
    return [np.full(shape, 77, np.uint8)] + [
        np.broadcast_to(30 + 40 * (x % p) + ch, shape).astype(np.uint8)
        for p in (2, 3, 4, 5)]


def _max_err(a, b) -> int:
    """Largest absolute difference of two integer tensors."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _stream_err(out, lens, out_p, lens_p) -> int:
    """Largest absolute difference of two encodes' lengths and of their
    bytes up to each lane's length."""
    import torch

    cut = (torch.arange(out.shape[1], device=out.device)[None, :]
           >= torch.minimum(lens, lens_p)[:, None])
    return max(_max_err(lens, lens_p), _max_err(out.masked_fill(cut, 0),
                                                out_p.masked_fill(cut, 0)))


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and bound_by of a kernel that must move ``n_bytes`` and do
    ``n_ops`` integer operations on this card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


def _decisions(torch, diff) -> int:
    """Decisions the residuals ``diff`` need: 1 for a zero, else 2e + 3
    (e = floor(log2 |diff|)), summed over every lane and symbol."""
    from llcomp_tpu_torch.core import transform

    ad = diff.abs()
    e = transform.ilog2(ad.clamp(min=1), max_bits=12)
    return int(torch.where(ad != 0, 2 * e + 3, 1).sum())


def _valid(q, shifts) -> int:
    """Valid coder records in ``q``: bit 9 of each record at ``shifts``."""
    return sum(int(((q >> (s + 9)) & 1).sum()) for s in shifts)


def _stage_run(torch, run, lanes_t, init, keep: bool = False):
    """One encode of device lanes [S, H, W, C] u8 through a sort-engine
    chain ``run`` (``encode._encode_sort`` or ``encode._encode_decision``)
    in one chunk, with a CUDA event after each stage: (ms per stage, the
    stages' outputs by stage name if ``keep``, (bytes [S, width] u8,
    lens [S]))."""
    from llcomp_tpu_torch import encode
    from llcomp_tpu_torch.core.config import REV2

    marks, made = [], {}

    def stage_done(stage, *out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))
        if keep:
            made[stage] = out

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    res = run(lanes_t, REV2, init, encode.outcap(lanes_t[0].numel()),
              stage_done)
    torch.cuda.synchronize()
    ms, prev = {}, start
    for stage, ev in marks:
        ms[stage] = prev.elapsed_time(ev)
        prev = ev
    return ms, made, res


def _on_host(args) -> tuple:
    """CPU copies of the tensors in ``args``, the rest as they are: a plain
    version runs on the host, where its loops of small ops launch nothing."""
    return tuple(a.cpu() if hasattr(a, "cpu") else a for a in args)


def _kernel_err(kernel, plain, *args) -> int:
    """``kernel`` on ``args`` against its plain version on CPU copies of
    them: the largest difference over their outputs (kp and fin of a
    coder), the kernel's brought to the host."""
    return max(_max_err(a.cpu(), b)
               for a, b in zip(kernel(*args), plain(*_on_host(args))))


def _sort_kernels_vs_plain(torch, made, init, host: bool = False) -> dict:
    """Kernels 3 and 4, as the engine ran them (``_stage_run(keep=True)``),
    against their plain versions on the same inputs (on CPU copies of them
    if ``host``): max_abs_err of the walk's records and of the coder's kp
    and fin, and the plain versions' milliseconds."""
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    K, _ = made["precompute and counts"]
    xs, _ = made["sym sort"]
    lo, hi = made["walk"]
    qlo, qhi = made["compact sort"]
    kp, fin = made["coder"]
    if host:
        xs, lo, hi, qlo, qhi, kp, fin = _on_host((xs, lo, hi, qlo, qhi, kp,
                                                   fin))
    walk_ms, (lo_p, hi_p) = _time_plain(
        torch, lambda: ek.walk_symbols_plain(xs, K, init))
    coder_ms, (kp_p, fin_p) = _time_plain(
        torch, lambda: ek.coder_scan_off_q_plain(qlo, qhi))
    return {"walk": max(_max_err(lo, lo_p), _max_err(hi, hi_p)),
            "coder": max(_max_err(kp, kp_p), _max_err(fin, fin_p)),
            "walk_plain_ms": walk_ms, "coder_plain_ms": coder_ms}


def skewed_recs(T: int, S: int, seed: int = 77, odds=(97, 50),
                probs=(7, 248)) -> np.ndarray:
    """Random coder records [T, S] int64 (``valid<<9 | bit<<8 | prob``),
    from integer hashes only: 90% valid, bits P(1) = odds[0] % on even
    lanes and odds[1] % on odd ones (97: long deferred runs, carries),
    probabilities in [probs[0], probs[1])."""
    r = _hash64(seed, T * S).reshape(T, S)
    valid = (r % np.uint64(10) != 0).astype(np.int64)
    p1 = np.where(np.arange(S) % 2 == 0, *odds).astype(np.uint64)
    bit = ((r >> np.uint64(8)) % np.uint64(100) < p1).astype(np.int64)
    prob = ((r >> np.uint64(20)) % np.uint64(probs[1] - probs[0])
            ).astype(np.int64) + probs[0]
    return valid << 9 | bit << 8 | prob


def off_record_cases(D: int, per: int = 1, batch: int = 0,
                     stages: int = 2) -> dict:
    """A coder's ragged cases for a ring of ``D`` rows of ``per`` records
    each (kernel 4's rows are quads): name -> records [T * per, S] int64.
    T = 1, D - 1, D + 1 and a T off every multiple of D rows at 1, 33 and
    130 lanes, and, for a split coder whose warps hand over ``batch``
    records at a time, one row either side of a hand-over and one past the
    reuse of the first of 2 and of ``stages`` batches; 0xFF runs (bits
    P(1) = 0.99 with probabilities 7..63: deferred runs of a hundred bytes
    and more, resolved by carries and by emits); dead lanes and dead tails
    of a different length in every lane (for quads, ending inside a
    quad)."""
    rows = {1, max(D - 1, 1), D + 1, 5 * D + 3}
    if batch:
        B = batch // per
        rows |= {max(B - 1, 1), B + 1, 2 * B + 1, stages * B + 1}
    cases = {f"T {T} S {S}": skewed_recs(T * per, S, seed=T + S)
             for T in sorted(rows) for S in (1, 33, 130)}
    cases["0xFF runs"] = skewed_recs(4000, 130, seed=78, odds=(99, 99),
                                     probs=(7, 64))
    dead = skewed_recs(3000, 130, seed=79)
    dead[:, :10] = 0                                   # lanes all dead
    for s in range(130):
        dead[3000 - (s * 37) % 1500:, s] = 0           # dead tails
    cases["dead lanes and tails"] = dead
    return cases


def pack_quads(recs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Records [4 * Tq, S] -> kernel 4's pair-packed quads (qlo, qhi)
    [Tq, S] int32: quad t holds records 4t, 4t+1 in qlo[t] and 4t+2, 4t+3
    in qhi[t], 10 bits each."""
    rec = recs.reshape(-1, 2, 2, recs.shape[1])
    return ((rec[:, 0, 0] | rec[:, 0, 1] << 10).astype(np.int32),
            (rec[:, 1, 0] | rec[:, 1, 1] << 10).astype(np.int32))


def coder_depth(name: str) -> int:
    """Coder ``name``'s (a key of ``CODERS``) rows of its input in flight,
    read from its source: kernel 7's ring depth, kernels 4 and 8's
    hand-over batch."""
    from llcomp_tpu_torch.kernels import build

    const, per = CODERS[name]
    return build.constant("coder_scan", const) // per


def coder_cases(name: str) -> dict:
    """Coder ``name``'s ragged cases (``off_record_cases`` at its ring
    depth and, for kernels 4 and 8, at their hand-over and input stages):
    case -> the wrapper's inputs, int32 arrays (kernel 4's packed by
    ``pack_quads``)."""
    from llcomp_tpu_torch.kernels import build

    per = CODERS[name][1]
    batch = (0 if name == "coder_scan_off"
             else build.constant("coder_scan", "kBatch"))
    cases = off_record_cases(coder_depth(name), per, batch,
                             build.constant("coder_scan", "kInStages"))
    return {case: pack_quads(r) if per == 4 else (r.astype(np.int32),)
            for case, r in cases.items()}


def seg_cases(T: int, S: int, chunks=(2, 7, 32, 64)) -> dict:
    """Context-run starts for the walks' chunk partition: name -> seg
    [T, S] bool.  A seg on every entry; on entry 0 only; on none; runs
    longer than three chunks of each count in ``chunks`` (lanes take the
    counts in turn, shifted by the lane); a seg exactly on every chunk start
    of each count; and runs at random (1 in 10) before a tail that is one
    run of a different length in every lane (the decision variant's
    padding)."""
    t = np.arange(T)[:, None]
    s = np.arange(S)[None, :]
    span = np.array([3 * -(-T // c) + 1 for c in chunks])[s % len(chunks)]
    tail = T - 1 - (s * 37) % max(T // 2, 1)
    r = _hash64(T * 1000 + S, T * S).reshape(T, S)
    return {
        "every entry": np.ones((T, S), bool),
        "entry 0 only": np.broadcast_to(t == 0, (T, S)),
        "no seg": np.zeros((T, S), bool),
        "runs across chunks": (t + s) % span == 0,
        "every chunk start": np.broadcast_to(
            np.any([t % -(-T // c) == 0 for c in chunks], axis=0), (T, S)),
        "random runs, one-run tail": np.where(
            t < tail, r % np.uint64(10) == 0, t == tail),
    }


def walk_probs_xs(seg: np.ndarray) -> np.ndarray:
    """Kernel 6's input ``bit | seg<<1`` [T, S] int32, bits at random."""
    T, S = seg.shape
    bit = (_hash64(T + 7 * S, T * S) % np.uint64(2)).reshape(T, S)
    return (bit.astype(np.int64) | seg.astype(np.int64) << 1).astype(np.int32)


def walk_symbols_xs(seg: np.ndarray) -> np.ndarray:
    """Kernel 3's input ``bucket<<14 | live<<13 | seg<<12 | diff+1274`` [T,
    S] int32: residuals mostly small, a quarter zero, 1 in 16 up to +-1274
    (23 decisions, cut at K 20); buckets at random; dead symbols at random
    (1 in 8) and a dead tail of a different length in every lane."""
    T, S = seg.shape
    r = _hash64(T + 11 * S, T * S).reshape(T, S)
    big = (r >> np.uint64(40)) % np.uint64(16) == 0
    mag = np.where(big, (r >> np.uint64(8)) % np.uint64(1275),
                   (r >> np.uint64(8)) % np.uint64(40)).astype(np.int64)
    mag[(r >> np.uint64(24)) % np.uint64(4) == 0] = 0
    diff = np.where((r >> np.uint64(30)) % np.uint64(2) == 1, -mag, mag)
    t = np.arange(T)[:, None]
    live = ((r >> np.uint64(50)) % np.uint64(8) != 0) & (
        t < T - (np.arange(S)[None, :] * 13) % max(T // 3, 1))
    bucket = ((r >> np.uint64(56)) % np.uint64(128)).astype(np.int64)
    return (bucket << 14 | live.astype(np.int64) << 13
            | seg.astype(np.int64) << 12 | diff + 1274).astype(np.int32)


WALK_LANES = (1, 33, 130, 513)   # the walks' synthetic cases: lanes
WALK_K = 20                        # kernel 3's K there (the bench's)


def walk_steps(C: int) -> tuple[int, ...]:
    """The walks' synthetic lengths around chunk count C: C - 1, C and C +
    1, and 5C + 3 (chunks of 5 and 6 entries)."""
    return tuple(sorted({max(C - 1, 1), C, C + 1, 5 * C + 3}))


def walk_case_errs(torch, name: str, T: int, S: int, dev) -> dict:
    """Kernel 3 or 6 (``name``) against its plain version on every
    ``seg_cases`` pattern at T x S (kernel 3 at K ``WALK_K`` with primed
    reset rows, and a seed table on every other pattern): pattern ->
    max_abs_err of probs, or of lo and hi."""
    from llcomp_tpu_torch.core import tables
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    seed_tab = (np.arange(121 * 8).reshape(121, 8) * 37 % 128).astype(np.uint8)
    errs = {}
    for i, (pattern, seg) in enumerate(seg_cases(T, S).items()):
        if name == "walk_probs":
            xs = torch.from_numpy(walk_probs_xs(seg)).to(dev)
            errs[pattern] = _kernel_err(lambda x: (ek.walk_probs(x),),
                                        lambda x: (ek.walk_probs_plain(x),),
                                        xs)
        else:
            xs = torch.from_numpy(walk_symbols_xs(seg)).to(dev)
            init = seed_tab if i % 2 else tables.PRIOR_TAB
            errs[pattern] = _kernel_err(ek.walk_symbols, ek.walk_symbols_plain,
                                        xs, WALK_K, init)
    return errs


def walk_pieces(seg, chunks: int) -> tuple[int, int]:
    """(the longest piece, the longest thread walk) of a walk's input:
    ``seg`` [T, S] (tensor) cut at its context runs and into ``chunks``
    chunks a lane (``encode_kernels.chunk_bounds``).  A piece runs from a
    seg (or entry 0) to the next seg (or T)."""
    import torch

    from llcomp_tpu_torch.kernels import encode_kernels as ek

    T, S = seg.shape
    if not T * S:
        return 0, 0
    start, end = ek.chunk_bounds(seg, chunks)
    cuts = seg.clone()
    cuts[0] = True
    at = torch.nonzero(cuts.t().reshape(-1)).flatten()  # lane-major order
    gaps = torch.diff(torch.cat([at, at.new_tensor([T * S])]))
    # a piece ends at T, not at the next lane's first entry
    gaps = torch.minimum(gaps, T - at % T)
    return int(gaps.max()), int((end - start).max())


def _skewed_records(torch, Tq: int, S: int, dev):
    """Random pair-packed coder quads (qlo, qhi) [Tq, S] of ``skewed_recs``
    (kernel 4's input)."""
    return tuple(torch.from_numpy(q).to(dev)
                 for q in pack_quads(skewed_recs(4 * Tq, S)))


def phase_kernels_vs_plain(torch, log) -> dict:
    """Phase 3: each kernel against its plain version, exact."""
    from llcomp_tpu_torch import decode, encode, seed
    from llcomp_tpu_torch.core import transform
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    dev = torch.device("cuda")
    err_enc = err_dec = err_walk = err_coder = 0
    n_err_lanes = 0
    t_kernel = t_plain = 0.0
    mal = _malicious_stream()
    photo = [make_image(4, 16, 3, s) for s in range(5)]

    def cycle(imgs, S):                  # S lanes taken in turn from imgs
        return np.stack([imgs[i % len(imgs)] for i in range(S)])

    batches = {
        "rgb 4x16x3": np.stack(photo + [
            np.full((4, 16, 3), 77, np.uint8),
            (_hash64(9, 4 * 16 * 3) % np.uint64(256)).astype(np.uint8)
            .reshape(4, 16, 3)]),
        "gray 6x10x1": np.stack([make_image(6, 10, 1, s) for s in range(4)]),
        "rgba 3x8x4": np.stack([make_image(3, 8, 4, s) for s in range(4)]),
        "row 1x64x3": np.stack([make_image(1, 64, 3, s) for s in range(5)]),
        "col 24x1x3": np.stack([make_image(24, 1, 3, s) for s in range(5)]),
        "odd 7x5x1": np.stack([make_image(7, 5, 1, s) for s in range(5)]),
        # hash repeats (kernel 1's and 2's forwarding), C = 2 and C = 5
        # (kernel 2's last templated and its generic instantiation), lane
        # counts off every block size
        "repeats 6x24x1": np.stack([make_image(6, 24, 1, s) for s in range(3)]
                                   + repeat_lanes((6, 24, 1))),
        "c2 5x12x2 S33": cycle([make_image(5, 12, 2, s) for s in range(3)]
                               + repeat_lanes((5, 12, 2)), 33),
        "c5 4x6x5 S130": cycle([make_image(4, 6, 5, s) for s in range(3)]
                               + repeat_lanes((4, 6, 5)), 130),
        "S1 5x8x3": make_image(5, 8, 3, 3)[None],
    }
    tab = seed.derive(make_image(64, 64, 3, 5), device=dev)
    runs = [(name, lanes, mode) for name, lanes in batches.items()
            for mode in (("unprimed", "primed", "seeded")
                         if name == "rgb 4x16x3" else ("unprimed",))]
    runs.append(("rgb 4x16x3", batches["rgb 4x16x3"], "primed"))
    runs.append(("c5 4x6x5 S130", batches["c5 4x6x5 S130"], "seeded"))
    for k in dk.decode.instances:
        dk.decode.instances[k] = 0
    for name, lanes, mode in runs:
        init = encode._start_table(mode == "primed",
                                   tab if mode == "seeded" else None)
        S, H, W, C = lanes.shape
        xs = encode.precompute(torch.from_numpy(lanes).to(dev)).t().contiguous()
        # a dead tail (live bit clear), which codes nothing
        xs = torch.cat([xs, xs[:5] & ~(1 << 25)])
        cap = encode.outcap(xs.shape[0])
        t0 = time.perf_counter()
        out_k, len_k = ef.encode_fused(xs, init, cap)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out_p, len_p, _ = ef.encode_fused_plain(xs.cpu(), init, cap)
        t2 = time.perf_counter()
        t_kernel += t1 - t0
        t_plain += t2 - t1
        err_enc = max(err_enc, _stream_err(out_k.cpu(), len_k.cpu(), out_p,
                                           len_p))
        streams = [out_k[s, : int(len_k[s])].cpu().numpy().tobytes()
                   for s in range(S)]
        # corruptions: flipped bytes, a truncation inside a 16-byte word,
        # and (unprimed) a stream that must trip the error flag; garbage
        # past every lane's length, which must read as zeros
        n_bad = 3 if S > 3 else 0
        if n_bad:
            streams[0] = bytes(b ^ 0x5A for b in streams[0])
            streams[1] = streams[1][: min(len(streams[1]) - 1,
                                          16 * (len(streams[1]) // 32) + 7)]
            if mode == "unprimed":
                streams[2] = mal
        data, lens = decode._pack(streams)
        data[np.arange(data.shape[1])[None, :] >= lens[:, None]] = 0xA5
        d = torch.from_numpy(data).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        p_k, e_k = dk.decode(d, ln, H, W, C, init)
        p_k, e_k = p_k.cpu(), e_k.cpu()
        p_p, e_p = dk.decode_plain(torch.from_numpy(data),
                                   torch.from_numpy(lens), H, W, C, init)
        check(torch.equal(e_k, e_p), f"{name} {mode}: decode err flags differ")
        if n_bad and mode == "unprimed":
            check(int(e_k[2]) == 1, f"{name}: corrupt lane not flagged")
        n_err_lanes += int(e_k.sum())
        err_dec = max(err_dec, _max_err(p_k, p_p))
        imgs = transform.rct_inverse(p_k.t().reshape(S, H, W, C)).cpu().numpy()
        check(np.array_equal(imgs[n_bad:], lanes[n_bad:]),
              f"{name} {mode}: clean lanes did not round-trip")
        check(err_enc == 0 and err_dec == 0,
              f"{name} {mode}: kernel != plain (enc {err_enc}, dec {err_dec})")
        _, made, _ = _stage_run(torch, encode._encode_sort,
                                torch.from_numpy(lanes).to(dev), init,
                                keep=True)
        e = _sort_kernels_vs_plain(torch, made, init, host=True)
        e_walk, e_coder = e["walk"], e["coder"]
        err_walk, err_coder = max(err_walk, e_walk), max(err_coder, e_coder)
        check(e_walk == 0 and e_coder == 0, f"{name} {mode}: sort kernels "
              f"!= plain (walk {e_walk}, coder {e_coder})")
    e_coder = _kernel_err(ek.coder_scan_off_q, ek.coder_scan_off_q_plain,
                          *_skewed_records(torch, 1024, 256, dev))
    err_coder = max(err_coder, e_coder)
    check(e_coder == 0, f"skewed records: coder kernel != plain ({e_coder})")
    # the three coders on T around kernel 7's ring depth and kernels 4 and
    # 8's hand-overs, 0xFF runs, dead lanes and tails; kernels 7 and 8
    # also on skewed records
    skewed = {"skewed 4096 x 256": (skewed_recs(4096, 256).astype(np.int32),)}
    err_coders, n_coder = {}, 0
    for name in CODERS:
        cases = {**(skewed if name != "coder_scan_off_q" else {}),
                 **coder_cases(name)}
        err_coders[name] = 0
        for case, args in cases.items():
            e = _kernel_err(getattr(ek, name), getattr(ek, f"{name}_plain"),
                            *(torch.from_numpy(a).to(dev) for a in args))
            err_coders[name] = max(err_coders[name], e)
            check(e == 0, f"{case}: {name} kernel != plain ({e})")
            n_coder += 1
    # kernels 3 and 6 on the synthetic seg patterns, T around each
    # kernel's chunk count, ragged lane counts
    n_walk, err_walks = 0, {}
    for name in ("walk_symbols", "walk_probs"):
        C = build.constant(name, "kChunks")
        err_walks[name] = 0
        for T in walk_steps(C):
            for S in WALK_LANES:
                for pattern, e in walk_case_errs(torch, name, T, S,
                                                 dev).items():
                    check(e == 0, f"{name} {pattern}, T {T}, {S} lanes: "
                          f"kernel != plain ({e})")
                    err_walks[name] = max(err_walks[name], e)
                    n_walk += 1
    inst = dict(dk.decode.instances)
    check(all(inst.values()), f"a kernel 2 instantiation never ran: {inst}")
    log(f"phase 3 kernel vs plain: {len(runs)} batches exact "
        f"(max_abs_err encode {err_enc}, decode {err_dec}, walk {err_walk}, "
        f"coder {err_coder}, also on 1024 x 256 skewed coder records; "
        f"{n_err_lanes} flagged lanes agree; kernel 2 launches by "
        f"instantiation {inst}) "
        f"kernel {t_kernel:.3f} s, plain encode {t_plain:.1f} s")
    log(f"phase 3 coders vs plain, every output, on ragged record sets "
        f"({', '.join(coder_cases('coder_scan'))}; kernel 4's packed in "
        f"quads, T in quads) around the rows in flight " + ", ".join(
            f"{coder_depth(n)} ({n})" for n in CODERS)
        + f", skewed 4096 x 256 (kernels 7, 8): {n_coder} cases exact "
        f"(max_abs_err {err_coders})")
    log(f"phase 3 walk_symbols and walk_probs vs plain on synthetic seg "
        f"patterns ({', '.join(seg_cases(2, 1))}) at T " + " and ".join(
            f"{walk_steps(build.constant(n, 'kChunks'))} ({n})"
            for n in err_walks) + f" x {WALK_LANES} lanes: {n_walk} cases "
        f"exact (max_abs_err {err_walks})")
    return {"encode": err_enc, "decode": err_dec,
            "walk": max(err_walk, err_walks["walk_symbols"]),
            "walk_probs": err_walks["walk_probs"],
            "coder": max(err_coder, err_coders["coder_scan_off_q"]),
            "coder_scan_off": err_coders["coder_scan_off"],
            "coder_scan": err_coders["coder_scan"]}


def phase_main_path(torch, log) -> dict:
    """Phase 4: the user's entry points on two images; returns launch counts
    made during this phase only."""
    from llcomp_tpu_torch import api, container
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef

    cases = [("photo512", 512, 32), ("photo2048", 2048, 2048)]
    imgs = {name: make_image(n, n, 3, 1000 + n) for name, n, _ in cases}
    for name, img in imgs.items():
        check(sha(img) == IMAGE_SHA[name], f"{name}: image generator drifted")
    ef.encode_fused.launches = 0
    dk.decode.launches = 0
    for name, n, lanes in cases:
        img = imgs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = api.compress(img, slices="auto", device="cuda")
        t1 = time.perf_counter()
        out = api.decompress(blob, device="cuda")
        t2 = time.perf_counter()
        streams, W, H, C, slice_h, flags, _, tw = container.unpack_sliced(blob)
        check(len(streams) == lanes and flags & container.FLAG_SEEDED,
              f"{name}: expected {lanes} seeded slices, got {len(streams)} "
              f"(flags {flags})")
        check(sha(blob) == GOLDEN_SHA[name], f"{name}: .llct bytes != golden")
        check(np.array_equal(out, img), f"{name}: round trip not exact")
        mp = n * n / 1e6
        log(f"phase 4 {name}: {lanes} lanes x {slice_h} rows, "
            f"{len(blob)} B (ratio {img.size / len(blob):.3f}), golden ok, "
            f"exact; compress {t1 - t0:.3f} s ({mp / (t1 - t0):.2f} MP/s), "
            f"decompress {t2 - t1:.3f} s ({mp / (t2 - t1):.2f} MP/s)")
    counts = {"encode_fused": ef.encode_fused.launches,
              "decode_kernel": dk.decode.launches}
    check(all(counts.values()), f"main path skipped a kernel: {counts}")
    log(f"phase 4 launches on the main path: {counts}")
    return counts


TILED = ("tiled8192", 256, 8192, 9000)   # name, H, W, seed: 4 tiles of 2,048
REV0_GOLDEN = {   # llcomp.js bitstream, as tests/test_rev0.py pins it
    (1, 1, 3): "7703010001008266d6e11f3a",
    (2, 2, 3): "770302000200825ba6a4f74bfbffafc811a6b0307247632a91",
    (4, 4, 3): "7703040004008261c3981a766b9810e7cdda4d55c2bfbbf453ed46ac50c1720d16",
    (2, 2, 4): "7704020002008266d6e11f3b221ec719257457c884bd6a7127",
}
NATIVE_STRIPES = (1, 2, 4, 8, 16, 32, 64, 128)   # of 8x512x3, native vs device
CORPUS_BATCH = 256      # max_lanes_per_batch of phase 9's corpus: 8 batches
PHASE9_LIMIT_S = 120    # phase 9 fails past this many seconds


def rev0_image(shape) -> np.ndarray:
    """The image of a ``REV0_GOLDEN`` entry."""
    if shape == (1, 1, 3):
        return np.array([[[10, 20, 30]]], np.uint8)
    if shape == (2, 2, 3):
        return np.array([[[0, 0, 0], [255, 255, 255]],
                         [[128, 64, 32], [1, 2, 3]]], np.uint8)
    if shape == (4, 4, 3):
        return (np.arange(48).reshape(4, 4, 3) * 5 % 256).astype(np.uint8)
    return np.arange(10, 170, 10, dtype=np.uint8).reshape(2, 2, 4)


def corpus_images() -> list[np.ndarray]:
    """Phase 9's corpus: 16 photos of 512x512x3, 4 of 256x256x4, 3 grayscale
    384x384 and one 256x8192x3 that ``pick_tiling`` tiles."""
    name, h, w, seed = TILED
    return ([make_image(512, 512, 3, 2000 + i) for i in range(16)]
            + [make_image(256, 256, 4, 2100 + i) for i in range(4)]
            + [make_image(384, 384, 1, 2200 + i) for i in range(3)]
            + [make_image(h, w, 3, seed)])


def host_cpu() -> str:
    """The host CPU (native's numbers run there): /proc/cpuinfo's vendor,
    family, model and model name, and the core count."""
    import os

    info = {}
    with contextlib.suppress(OSError):
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = line.partition(":")
            if not key.strip():
                break                    # the first processor's block only
            info.setdefault(key.strip(), val.strip())
    desc = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                                "model", "model name")
                     if k in info)
    return f"{desc or 'CPU not named'}; {os.cpu_count()} cores"


def _median_s(fn, reps: int = 3) -> float:
    """Median seconds of ``reps`` synchronised calls of ``fn`` (host numpy
    in, bytes or pixels out)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _flip_slice(blob: bytes, streams, k: int) -> bytes:
    """``blob`` with slice ``k``'s payload XORed with 0xFF in place (its
    crc no longer matches)."""
    off = len(blob) - sum(len(s) for s in streams[k:])
    bad = np.frombuffer(blob, np.uint8).copy()
    bad[off : off + len(streams[k])] ^= 0xFF
    return bad.tobytes()


def surface_reencode(torch, log) -> int:
    """Phase 9, reencode_slice: a slice of phase 4's photo512 container and
    of a tiled 256x8192x3 container corrupted, reported by
    ``decompress(strict=False)``, healed on the card back to the golden."""
    from llcomp_tpu_torch import api, container
    from llcomp_tpu_torch.kernels import encode_fused as ef

    name, h, w, seed = TILED
    check(api.pick_tiling(h, w, 3) == (2048, 1)
          and api.pick_tiling(h, w // 2, 3)[0] == 0,
          f"pick_tiling({h}, {w}, 3) != (2048, 1)")
    launches, parts = 0, []
    for key, img, k in (("photo512", make_image(512, 512, 3, 1512), 5),
                        (name, make_image(h, w, 3, seed), 256 + 77)):
        check(sha(img) == IMAGE_SHA[key], f"{key}: image generator drifted")
        blob = api.compress(img, slices="auto")
        check(sha(blob) == GOLDEN_SHA[key], f"{key}: .llct bytes != golden")
        streams, W, H, C, sh, flags, _, tw = container.unpack_sliced(blob)
        broken = _flip_slice(blob, streams, k)
        out, bad = api.decompress(broken, strict=False)
        check(bad == [k], f"{key}: strict=False reported {bad}, not [{k}]")
        y0, y1, x0, x1 = container.tile_regions(W, H, sh, tw)[k]
        keep = np.ones((H, W), bool)
        keep[y0:y1, x0:x1] = False
        check(np.array_equal(out[keep], img[keep]) and not out[~keep].any(),
              f"{key}: pixels outside slice {k} not exact")
        ef.encode_fused.launches = 0
        t0 = time.perf_counter()
        healed = api.reencode_slice(broken, k, img[y0:y1, x0:x1])
        ms = (time.perf_counter() - t0) * 1e3
        launches += ef.encode_fused.launches
        check(ef.encode_fused.launches > 0, f"{key}: kernel 1 never launched")
        check(healed == blob, f"{key}: healed container != golden")
        parts.append(f"{key} ({len(streams)} slices of {sh} rows"
                     + (f", tiles {tw} px" if tw else "")
                     + f") slice {k} [{y0}:{y1}, {x0}:{x1}] reported and "
                     f"healed to the golden in {ms:.1f} ms")
    log("phase 9 reencode_slice: " + "; ".join(parts)
        + f"; kernel 1 launches {launches}")
    return launches


def surface_native(torch, log) -> dict:
    """Phase 9, native: build the port's C++ runtime, phase 4's goldens
    through backend='native', and native against the device engine by
    stripe count (end to end, median of 3): the crossover."""
    from llcomp_tpu_torch import api, decode, encode, host
    from llcomp_tpu_torch.native import build as nbuild

    t0 = time.perf_counter()
    so = nbuild.build()
    build_s = time.perf_counter() - t0
    for name, n in (("photo512", 512), ("photo2048", 2048)):
        img = make_image(n, n, 3, 1000 + n)
        blob = api.compress(img, slices="auto", backend="native")
        check(sha(blob) == GOLDEN_SHA[name], f"{name}: native != golden")
        check(np.array_equal(api.decompress(blob, backend="native"), img),
              f"{name}: native round trip not exact")
    dev = torch.device("cuda")
    src = make_image(8 * NATIVE_STRIPES[-1], 512, 3, 77).reshape(-1, 8, 512, 3)
    encode.encode_lanes(src[:2], primed=True, device=dev)      # warm-up
    rows = {}
    for n in NATIVE_STRIPES:
        lanes = src[:n]
        streams = host.encode_images(lanes, primed=True)
        check(encode.encode_lanes(lanes, primed=True, device=dev) == streams,
              f"{n} stripes: device streams != native")
        rows[n] = {
            "native_enc": _median_s(lambda: host.encode_images(
                lanes, primed=True)),
            "device_enc": _median_s(lambda: encode.encode_lanes(
                lanes, primed=True, device=dev)),
            "native_dec": _median_s(lambda: host.decode_streams(
                streams, (8, 512, 3), primed=True)),
            "device_dec": _median_s(lambda: decode.decode_lanes(
                streams, (8, 512, 3), primed=True, device=dev))}
    wins = [rows[n]["device_enc"] + rows[n]["device_dec"]
            < rows[n]["native_enc"] + rows[n]["native_dec"]
            for n in NATIVE_STRIPES]
    cross = next((NATIVE_STRIPES[i] for i in range(len(wins))
                  if all(wins[i:])), None)
    log(f"phase 9 native: {so.name} built in {build_s:.2f} s; photo512 and "
        f"photo2048 through backend='native' golden and exact; "
        f"host {host_cpu()}")
    log("phase 9 native vs device, 8x512x3 stripes primed, ms end to end "
        "(median of 3; encode, decode): " + "; ".join(
            f"{n}: native {1e3 * r['native_enc']:.2f}, "
            f"{1e3 * r['native_dec']:.2f}, device {1e3 * r['device_enc']:.2f}, "
            f"{1e3 * r['device_dec']:.2f}" for n, r in rows.items())
        + f"; the device wins from {cross} stripes on"
        + f" (MIN_DEVICE_LANES {api.MIN_DEVICE_LANES})")
    return {"build_s": build_s, "rows": rows, "crossover": cross}


def surface_rev0(log) -> None:
    """Phase 9, revision 0: the four llcomp.js goldens both ways."""
    from llcomp_tpu_torch import api

    for shape, hexs in REV0_GOLDEN.items():
        img = rev0_image(shape)
        check(api.compress(img, revision=0).hex() == hexs,
              f"rev0 {shape}: bytes != golden")
        check(np.array_equal(api.decompress(bytes.fromhex(hexs)), img),
              f"rev0 {shape}: decode not exact")
    log(f"phase 9 revision 0: {len(REV0_GOLDEN)} goldens "
        f"({', '.join('x'.join(map(str, s)) for s in REV0_GOLDEN)}) encode "
        "and decode exactly through compress(revision=0) and decompress")


def surface_corpus(torch, log) -> dict:
    """Phase 9, corpus: 24 images in batches of ``CORPUS_BATCH`` lanes,
    pipelined; every blob equal to the native runtime's, exact round trips;
    MP/s pipelined and in turn (``encode_lanes_pipelined`` on the corpus's
    batches at ``max_inflight`` 2 and 1); the device idle share of one
    pipelined encode."""
    from llcomp_tpu_torch import api, corpus, encode
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef

    imgs = corpus_images()
    mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
    kw = {"slice_h": 16, "max_lanes_per_batch": CORPUS_BATCH}
    piped = []
    pipelined = encode.encode_lanes_pipelined

    def spy(batches, *a, **k):
        piped.append((batches, a, k))
        return pipelined(batches, *a, **k)

    secs = {}
    t0 = time.perf_counter()
    encode.encode_lanes_pipelined = spy
    try:
        ef.encode_fused.launches = dk.decode.launches = 0
        blobs, stats = corpus.compress_corpus(imgs, **kw)
        outs = corpus.decompress_corpus(blobs, max_lanes_per_batch=CORPUS_BATCH)
        counts = {"encode_fused": ef.encode_fused.launches,
                  "decode_kernel": dk.decode.launches}
    finally:
        encode.encode_lanes_pipelined = pipelined
    secs["device corpus"] = time.perf_counter() - t0
    check(all(counts.values()), f"corpus skipped a kernel: {counts}")
    check(len(piped) == 1 and len(piped[0][0]) >= 4,
          f"corpus: {[len(b) for b, _, _ in piped]} pipelined batches, "
          "want one call of >= 4")
    check(all(np.array_equal(a, b) for a, b in zip(outs, imgs)),
          "decompress_corpus not exact")
    t0 = time.perf_counter()
    native, _ = corpus.compress_corpus(imgs, **kw, backend="native")
    secs["native corpus"] = time.perf_counter() - t0
    check(native == blobs, "corpus blobs != the native runtime's")
    t0 = time.perf_counter()
    check(all(np.array_equal(api.decompress(b), im)
              for b, im in zip(blobs, imgs)), "api.decompress of a blob alone "
          "not exact")
    secs["each blob"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches, a, k = piped[0]
    enc = {2: [], 1: []}          # the pipeline alone, batches made
    for _ in range(3):
        for inflight in enc:
            enc[inflight].append(_median_s(lambda: pipelined(
                batches, *a, **{**k, "max_inflight": inflight}), reps=1))
    enc_s = {m: statistics.median(v) for m, v in enc.items()}
    dec_s = _median_s(lambda: corpus.decompress_corpus(
        blobs, max_lanes_per_batch=CORPUS_BATCH))
    wall, busy, _ = _device_busy(torch, lambda: pipelined(batches, *a, **k))
    secs["timing"] = time.perf_counter() - t0
    log(f"phase 9 corpus: {len(imgs)} images ({mp:.3f} MP), "
        f"{stats.lanes} lanes in {stats.batches} batches of <= "
        f"{CORPUS_BATCH}, {len(batches)} through encode_lanes_pipelined; "
        f"ratio {stats.ratio:.3f}; every blob == backend='native', "
        f"decompress_corpus and each api.decompress exact; launches {counts}")
    log("phase 9 corpus MP/s: compress_corpus once "
        f"{mp / stats.encode_s:.2f} ({1e3 * stats.encode_s:.1f} ms, encode_s "
        f"of CorpusStats); encode_lanes_pipelined on the {len(batches)} "
        "batches (median of 3, turns alternating): pipelined (max_inflight "
        f"2) {mp / enc_s[2]:.2f} ({1e3 * enc_s[2]:.1f} ms), in turn "
        f"(max_inflight 1) {mp / enc_s[1]:.2f} ({1e3 * enc_s[1]:.1f} ms); "
        f"decode_corpus (batches in turn, median of 3) {mp / dec_s:.2f} "
        f"({1e3 * dec_s:.1f} ms); one pipelined encode under torch.profiler: "
        + _idle("encode", wall, busy) + "; seconds: "
        + ", ".join(f"{n} {v:.1f}" for n, v in secs.items()))
    return {"counts": counts, "mp": mp, "corpus_encode_s": stats.encode_s,
            "encode_s": {"pipelined": enc_s[2], "in turn": enc_s[1]},
            "decode_s": dec_s,
            "idle": None if busy is None else 1 - busy / wall}


def surface_cli(log) -> None:
    """Phase 9, the CLI as subprocesses in a temporary directory: selftest,
    .ppm and .pgm round trips, info, corpus --verify; the chains run side
    by side."""
    import os
    import tempfile

    from llcomp_tpu_torch.io import load_image, save_image

    root = pathlib.Path(__file__).resolve().parent

    def cli(*args) -> str:
        r = subprocess.run([sys.executable, "-m", "llcomp_tpu_torch.cli",
                            *map(str, args)], cwd=root, capture_output=True,
                           text=True, timeout=300, env=dict(os.environ))
        check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: "
              f"{r.stderr[-800:]}")
        return r.stdout

    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        ppm, pgm = d / "photo.ppm", d / "gray.pgm"
        save_image(ppm, make_image(96, 64, 3, 31))
        save_image(pgm, make_image(40, 24, 1, 32))
        (d / "set").mkdir()
        for i in range(4):
            save_image(d / "set" / f"im{i}.ppm", make_image(64, 48, 3, 40 + i))

        def ppm_chain():
            cli("compress", ppm, "--slices", "auto")
            cli("decompress", f"{ppm}.llct", "-o", d / "back.ppm")
            return cli("info", f"{ppm}.llct")

        def pgm_chain():
            cli("compress", pgm)
            return cli("decompress", f"{pgm}.llcomp", "-o", d / "back.pgm")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            jobs = [pool.submit(cli, "selftest"), pool.submit(ppm_chain),
                    pool.submit(pgm_chain),
                    pool.submit(cli, "corpus", d / "set", "--verify")]
            selftest, info, _, corp = [j.result() for j in jobs]
        secs = time.perf_counter() - t0
        check("selftest: PASS" in selftest, f"cli selftest: {selftest}")
        check("sliced container" in info, f"cli info: {info}")
        check("verified 4 images bit-exact" in corp, f"cli corpus: {corp}")
        for a, b in ((ppm, d / "back.ppm"), (pgm, d / "back.pgm")):
            check(np.array_equal(load_image(a), load_image(b)),
                  f"cli round trip of {a.name} not exact")
    log(f"phase 9 CLI (python -m llcomp_tpu_torch.cli, 9 processes in 4 "
        f"chains side by side, {secs:.1f} s): selftest PASS ("
        + ", ".join(line[5:] for line in selftest.splitlines()
                    if line.startswith("ok  "))
        + "); .ppm sliced and .pgm single-stream round trips exact; info: "
        + info.splitlines()[0] + "; corpus --verify on 4 .ppm files exact")


def phase_surface(torch, log) -> dict:
    """Phase 9: the single-host surface on the card (reencode_slice, the
    native runtime, revision 0, the corpus, the CLI), each part with the
    launch counts set to 0 just before it and read just after."""
    t = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        t[name] = round(time.perf_counter() - t0, 1)
        return r

    res = {"reencode": part("reencode", surface_reencode, torch, log),
           "native": part("native", surface_native, torch, log)}
    part("rev0", surface_rev0, log)
    res["corpus"] = part("corpus", surface_corpus, torch, log)
    part("cli", surface_cli, log)
    total = sum(t.values())
    log("phase 9 seconds: " + ", ".join(f"{k} {v}" for k, v in t.items())
        + f"; total {total:.1f} of the {PHASE9_LIMIT_S} s limit")
    check(total < PHASE9_LIMIT_S,
          f"phase 9 took {total:.1f} s, over its {PHASE9_LIMIT_S} s limit")
    return res


def _time_cuda(torch, fn, reps: int = 3, calls: int = 1) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after a warm-up
    (over ``calls`` calls back to back, divided by ``calls``)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _time_plain(torch, fn) -> tuple[float, object]:
    """Milliseconds of one call of ``fn`` (synchronised) and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_bench(torch, log, card: str, variants: dict) -> dict:
    """Phase 5: the bench-size batch, golden + round trip + timings; kernels
    1 and 2 beside their copies ``variants`` ({VARIANTS key: library}),
    and kernel 2 at C = 1."""
    from llcomp_tpu_torch import decode, encode, seed
    from llcomp_tpu_torch.core.config import REV2
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef

    dev = torch.device("cuda")
    imgs = bench_images(100)
    lanes = bench_lanes(imgs)
    check(sha(lanes) == IMAGE_SHA["batch"], "bench images drifted")
    S, H, W, C = lanes.shape
    mp = BENCH_IMAGES * BENCH_SIZE * BENCH_SIZE / 1e6
    tab = seed.derive_pooled(imgs[:8], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = encode.encode_lanes(lanes, seed=tab, device=dev)
    t1 = time.perf_counter()
    out = decode.decode_lanes(streams, (H, W, C), seed=tab, device=dev)
    t2 = time.perf_counter()
    check(sha(b"".join(streams)) == GOLDEN_SHA["batch"],
          "bench batch streams != golden")
    check(np.array_equal(out, lanes), "bench batch round trip not exact")
    n_bytes = sum(len(s) for s in streams)
    log(f"phase 5 batch: {S} lanes x {H * W * C} symbols, {n_bytes} B "
        f"(ratio {lanes.size / n_bytes:.3f}), golden ok, exact; first run "
        f"encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s")

    enc_t, dec_t = [], []
    for rep in range(3):
        fresh = bench_lanes(bench_images(5000 + 97 * rep))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = encode.encode_lanes(fresh, seed=tab, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = decode.decode_lanes(st, (H, W, C), seed=tab, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(back, fresh), f"fresh batch {rep} not exact")
        enc_t.append(t1 - t0)
        dec_t.append(t2 - t1)
    enc_s, dec_s = statistics.median(enc_t), statistics.median(dec_t)
    log(f"phase 5 end to end (host numpy in, bytes/pixels out), median of 3 "
        f"fresh batches on {card}: encode {enc_s:.4f} s = "
        f"{mp / enc_s:.2f} MP/s, decode {dec_s:.4f} s = {mp / dec_s:.2f} MP/s")

    # kernel-only times at the main path's shape (CUDA events)
    n_sym = H * W * C
    xs = encode.precompute(torch.from_numpy(lanes).to(dev)).t().contiguous()
    cap = encode.outcap(xs.shape[0])
    enc_ms = _time_cuda(torch, lambda: ef.encode_fused(xs, tab, cap))
    data, lens = decode._pack(streams)
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev)
    dec_ms = _time_cuda(torch, lambda: dk.decode(d, ln, H, W, C, tab))
    log(f"phase 5 kernels alone, {S} lanes x {n_sym} symbols: encode_fused "
        f"{enc_ms:.3f} ms ({mp / enc_ms * 1e3:.1f} MP/s, "
        f"{enc_ms * 1e3 / n_sym:.4f} us a symbol), decode {dec_ms:.3f} ms "
        f"({mp / dec_ms * 1e3:.1f} MP/s, {dec_ms * 1e3 / n_sym:.4f} us a "
        f"symbol)")
    log(f"phase 5 host share of the end-to-end medians (one launch each): "
        f"encode {enc_s * 1e3 - enc_ms:.2f} ms of {enc_s * 1e3:.2f} "
        f"({100 * (1 - enc_ms / (enc_s * 1e3)):.1f}%), decode "
        f"{dec_s * 1e3 - dec_ms:.2f} ms of {dec_s * 1e3:.2f} "
        f"({100 * (1 - dec_ms / (dec_s * 1e3)):.1f}%)")

    # the copies: other lanes a block and look-ahead depths, each output
    # equal to the shipped kernel's, and kernel 1 without its decisions;
    # then 1 against 2 lanes a block at twice the lanes
    ref_o, ref_l = ef.encode_fused(xs, tab, cap)
    ref_p, ref_e = dk.decode(d, ln, H, W, C, tab)

    def enc_run(xs, ref=None):
        def run():
            return ef.encode_fused(xs, tab, cap)
        if ref is not None:
            check(_stream_err(*run(), *ref) == 0, "encode copy != shipped")
        return run

    def dec_run(d, ln, ref=None):
        def run():
            return dk.decode(d, ln, H, W, C, tab)
        if ref is not None:
            p, e = run()
            check(torch.equal(p, ref[0]) and torch.equal(e, ref[1]),
                  "decode copy != shipped")
        return run

    times = {}
    for (name, tag), so in variants.items():
        if name not in ("encode_fused", "decode_kernel"):
            continue
        with running(name, so):
            if name == "decode_kernel":
                times[name, tag] = _time_cuda(
                    torch, dec_run(d, ln, (ref_p, ref_e)))
            else:
                times[name, tag] = _time_cuda(torch, enc_run(
                    xs, None if tag == "no decisions" else (ref_o, ref_l)))
    xs2 = torch.cat([xs, xs], 1).contiguous()
    d2, ln2 = torch.cat([d, d]), torch.cat([ln, ln])
    ref2 = ef.encode_fused(xs2, tab, cap), dk.decode(d2, ln2, H, W, C, tab)
    wide = {"encode_fused": [_time_cuda(torch, enc_run(xs2))],
            "decode_kernel": [_time_cuda(torch, dec_run(d2, ln2))]}
    for name, tag, run in (
            ("encode_fused", "2 lanes", lambda: enc_run(xs2, ref2[0])),
            ("decode_kernel", "1 lanes", lambda: dec_run(d2, ln2, ref2[1]))):
        with running(name, variants[name, tag]):
            wide[name] += [tag, _time_cuda(torch, run())]
    abl_ms = times.pop(("encode_fused", "no decisions"))
    for name, ms in (("encode_fused", enc_ms), ("decode_kernel", dec_ms)):
        shipped, copy, copy_ms = wide[name]
        log(f"phase 5 {name} ms beside its copies, same output: shipped "
            f"{ms:.3f}; " + "; ".join(
                f"{tag} {t:.3f}" for (n, tag), t in times.items()
                if n == name) + f"; at {2 * S} lanes, shipped {shipped:.3f}, "
            f"{copy} {copy_ms:.3f}")
    log(f"phase 5 kernel 1 split: {enc_ms:.3f} ms whole, {abl_ms:.3f} ms "
        f"with each symbol's decisions replaced by one byte out, so the "
        f"decisions take {enc_ms - abl_ms:.3f} ms "
        f"({100 * (1 - abl_ms / enc_ms):.1f}%)")

    # grayscale: no model word can be loaded ahead (C = 1)
    gray = np.ascontiguousarray(lanes[..., :1])
    xg = encode.precompute(torch.from_numpy(gray).to(dev)).t().contiguous()
    og, lg = ef.encode_fused(xg, tab, encode.outcap(xg.shape[0]))
    dg, lng = decode._pack([og[s, : int(lg[s])].cpu().numpy().tobytes()
                            for s in range(S)])
    dg, lng = torch.from_numpy(dg).to(dev), torch.from_numpy(lng).to(dev)
    pg, eg = dk.decode(dg, lng, H, W, 1, tab)
    check(not eg.any() and torch.equal(pg.t().reshape(S, H, W).cpu(),
                                       torch.from_numpy(gray[..., 0]).int()),
          "grayscale batch did not round-trip")
    gray_ms = _time_cuda(torch, lambda: dk.decode(dg, lng, H, W, 1, tab))
    log(f"phase 5 kernel 2 on channel 0 of the batch (C = 1, {H * W} "
        f"symbols a lane, exact round trip): {gray_ms:.3f} ms, "
        f"{gray_ms * 1e3 / (H * W):.4f} us a symbol against "
        f"{dec_ms * 1e3 / n_sym:.4f} at C = 3")

    # plain versions are Python loops over symbols: time them, and the
    # kernels again, on the first PLAIN_SUBSET_ROWS row(s) of every stripe
    h = PLAIN_SUBSET_ROWS
    sub = np.ascontiguousarray(lanes[:, :h])
    xs_s = encode.precompute(torch.from_numpy(sub).to(dev)).t().contiguous()
    cap_s = encode.outcap(xs_s.shape[0])
    enc_sub_ms = _time_cuda(torch, lambda: ef.encode_fused(xs_s, tab, cap_s))
    enc_plain_ms, (out_p, len_p, _) = _time_plain(
        torch, lambda: ef.encode_fused_plain(xs_s, tab, cap_s))
    out_k, len_k = ef.encode_fused(xs_s, tab, cap_s)
    check(torch.equal(len_k, len_p) and all(
        torch.equal(out_k[s, : int(len_k[s])], out_p[s, : int(len_p[s])])
        for s in range(S)), "subset: encode kernel != plain")
    # decoding the full streams as 1-row lanes gives each stripe's first row
    dec_sub_ms = _time_cuda(torch, lambda: dk.decode(d, ln, h, W, C, tab))
    dec_plain_ms, (p_p, e_p) = _time_plain(
        torch, lambda: dk.decode_plain(d, ln, h, W, C, tab))
    p_k, e_k = dk.decode(d, ln, h, W, C, tab)
    check(torch.equal(p_k, p_p) and torch.equal(e_k, e_p),
          "subset: decode kernel != plain")
    subset = f"{S} lanes x {h * W * C} symbols (row 0 of each stripe)"
    log(f"phase 5 subset {subset}: encode kernel {enc_sub_ms:.3f} ms vs "
        f"plain {enc_plain_ms:.1f} ms; decode kernel {dec_sub_ms:.3f} ms vs "
        f"plain {dec_plain_ms:.1f} ms")

    # bounds at the full shape: symbols in, the streams' bytes out (encode)
    # and the reverse (decode, int32 planes), with this batch's decisions
    _, diff = encode._hash_diff(torch.from_numpy(lanes).to(dev), REV2)
    n_dec, n_all = _decisions(torch, diff), xs.numel()
    per_dec = OPS_DECISION + OPS_STATE + OPS_CODER
    bounds = {
        "encode_fused": bound(4 * n_all + n_bytes + 4 * S,
                              n_dec * per_dec + n_all * OPS_SYMBOL_ENC),
        "decode_kernel": bound(n_bytes + 4 * S + 4 * n_all + 4 * S,
                               n_dec * per_dec + n_all * OPS_SYMBOL_DEC)}
    log(f"phase 5 bounds, {n_all} symbols, {n_dec} decisions: " + ", ".join(
        f"{k} {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} B, "
        f"{b['ops']} ops)" for k, b in bounds.items()))
    return {"encode_ms": enc_ms, "decode_ms": dec_ms, "n_sym": n_sym,
            "encode_sub_ms": enc_sub_ms, "decode_sub_ms": dec_sub_ms,
            "encode_plain_ms": enc_plain_ms, "decode_plain_ms": dec_plain_ms,
            "subset": subset, "bounds": bounds, "seed": tab,
            "encode_s": enc_s, "decode_s": dec_s}


def _device_busy(torch, fn) -> tuple[float, float | None, str]:
    """One synchronised ``fn()`` under ``torch.profiler``: (host ms, ms in
    which the device ran a kernel or a copy, the union of their intervals,
    None when the profiler recorded no device activity; the ten device ops
    that took the most device time, from ``key_averages()``).  The
    profiler's own buffer request is not the program's work and is left
    out of both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name != "Activity Buffer Request")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "Activity Buffer Request"),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    top = "; ".join(f"{e.key[:70]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.2f} ms" for e in ops)
    return wall, busy / 1e3 if spans else None, top or "not measured"


def _idle(name: str, wall: float, busy: float | None) -> str:
    return f"{name} {wall:.2f} ms, " + (
        f"busy {busy:.2f} ms, idle {100 * (1 - busy / wall):.1f}%"
        if busy is not None else "device time not measured")


def _worst_lanes(shape) -> np.ndarray:
    """The most decisions a rev-2 symbol can hold: every channel 0 or 255 at
    random gives residuals up to +-510, 19 decisions, and streams near the
    byte bound."""
    n = int(np.prod(shape))
    return ((_hash64(31, n) >> np.uint64(7)) % np.uint64(2)
            * np.uint64(255)).astype(np.uint8).reshape(shape)


def time_copies(torch, name: str, variants: dict, shipped_ms: float, run,
                want, seg=None, tags=None) -> dict:
    """The kernel of source ``name`` beside its copies ``variants``
    ({VARIANTS key: library}), those tagged ``tags`` where given: each
    copy's output ``run()`` must equal ``want`` (the shipped kernel's); the
    shipped kernel is timed again after each copy.  -> {tag: ([ms], a
    walk's longest thread walk at the copy's chunk count, given the walk's
    ``seg``, or None)}."""
    out = {"shipped": ([shipped_ms], None)}
    for (src, tag), so in variants.items():
        if src != name or (tags is not None and tag not in tags):
            continue
        with running(name, so):
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            err = max(_max_err(a, b) for a, b in zip(got, want))
            check(err == 0, f"{name} copy {tag!r} != shipped ({err})")
            walk = (walk_pieces(seg, int(tag.split()[1]))[1]
                    if seg is not None and tag.startswith("C ") else None)
            out[tag] = ([_time_cuda(torch, run)], walk)
        out["shipped"][0].append(_time_cuda(torch, run))
    return out


def _copies_line(copies: dict) -> str:
    """``time_copies``'s result as 'tag ms, ms (walk); ...'."""
    return "; ".join(f"{tag} " + ", ".join(f"{t:.3f}" for t in ts)
                     + (f" ({w})" if w else "")
                     for tag, (ts, w) in copies.items())


def phase_sort(torch, log, card: str, variants: dict) -> dict:
    """Phase 6: the sort engine on the bench batch: golden, round trip,
    equality with the fused engine (also on a worst-case batch), launches,
    memory against the lane budget, timings, and kernels 3 and 4 against
    their plain versions on the inputs the engine gave them; kernel 3
    beside its copies ``variants`` ({VARIANTS key: library})."""
    from llcomp_tpu_torch import decode, encode, seed
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    dev = torch.device("cuda")
    imgs = bench_images(100)
    lanes = bench_lanes(imgs)
    check(sha(lanes) == IMAGE_SHA["batch"], "bench images drifted")
    S, H, W, C = lanes.shape
    mp = BENCH_IMAGES * BENCH_SIZE * BENCH_SIZE / 1e6
    tab = seed.derive_pooled(imgs[:8], device=dev)
    budget = encode.lane_bytes(H * W * C, "sort")

    def peak_per_lane(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        return out, (torch.cuda.max_memory_allocated() - base) / S

    # the sort engine's main path: seeded encode, then decode (kernel 2)
    kernels = (ef.encode_fused, dk.decode, ek.walk_symbols,
               ek.coder_scan_off_q)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    streams, peak = peak_per_lane(
        lambda: encode.encode_lanes(lanes, seed=tab, device=dev,
                                    engine="sort"))
    t1 = time.perf_counter()
    out = decode.decode_lanes(streams, (H, W, C), seed=tab, device=dev)
    t2 = time.perf_counter()
    counts = {"walk_symbols": ek.walk_symbols.launches,
              "coder_scan_off_q": ek.coder_scan_off_q.launches,
              "decode_kernel": dk.decode.launches,
              "encode_fused": ef.encode_fused.launches}
    check(counts["walk_symbols"] and counts["coder_scan_off_q"]
          and counts["decode_kernel"] and not counts["encode_fused"],
          f"sort path launches wrong: {counts}")
    check(sha(b"".join(streams)) == GOLDEN_SHA["batch"],
          "sort engine: bench batch streams != golden")
    check(np.array_equal(out, lanes), "sort engine: round trip not exact")
    log(f"phase 6 sort engine: {S} lanes x {H * W * C} symbols, golden ok, "
        f"exact through kernel 2; first run encode {t1 - t0:.3f} s, decode "
        f"{t2 - t1:.3f} s; launches on this path {counts}")
    check(encode.encode_lanes(lanes, device=dev, engine="sort")
          == encode.encode_lanes(lanes, device=dev),
          "unprimed batch: sort engine != fused engine")
    log("phase 6 unprimed batch: sort engine bytes == fused engine bytes")

    worst = _worst_lanes(lanes.shape)      # 19 decisions a symbol: K 20
    got, peak_w = peak_per_lane(
        lambda: encode.encode_lanes(worst, device=dev, engine="sort"))
    check(got == encode.encode_lanes(worst, device=dev),
          "worst-case batch: sort engine != fused engine")
    check(max(peak, peak_w) <= budget, f"sort engine peak {max(peak, peak_w)}"
          f" B a lane, above encode.lane_bytes {budget} B")
    log(f"phase 6 worst-case batch (channels 0/255 at random): sort engine "
        f"bytes == fused engine bytes, {sum(map(len, got))} B; peak device "
        f"memory a lane in the encode: bench batch {peak / 1e6:.3f} MB, "
        f"worst case {peak_w / 1e6:.3f} MB, budget {budget / 1e6:.3f} MB "
        f"(encode.lane_bytes)")

    times = {"sort": [], "fused": []}
    for rep in range(3):
        fresh = bench_lanes(bench_images(5000 + 97 * rep))
        order = ("sort", "fused") if rep % 2 == 0 else ("fused", "sort")
        got = {}
        for eng in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[eng] = encode.encode_lanes(fresh, seed=tab, device=dev,
                                           engine=eng)
            torch.cuda.synchronize()
            times[eng].append(time.perf_counter() - t0)
        check(got["sort"] == got["fused"], f"fresh batch {rep}: sort != fused")
    med = {eng: statistics.median(t) for eng, t in times.items()}
    log(f"phase 6 end to end (host numpy in, bytes out), median of 3 fresh "
        f"seeded batches, same batches, on {card}: sort {med['sort']:.4f} s "
        f"= {mp / med['sort']:.2f} MP/s, fused {med['fused']:.4f} s = "
        f"{mp / med['fused']:.2f} MP/s")

    prof, tops = [], {}
    for eng in ("sort", "fused", "sort", "fused"):
        wall, busy, tops[eng] = _device_busy(torch, lambda: encode.encode_lanes(
            lanes, seed=tab, device=dev, engine=eng))
        prof.append(_idle(eng, wall, busy))
    log("phase 6 device idle share under torch.profiler (one seeded batch "
        "encode, host numpy in, bytes out; busy = union of the device's "
        "kernel and copy intervals): " + "; ".join(prof))
    log("phase 6 sort engine, ten largest device ops by device time "
        "(torch.profiler key_averages, second profiled encode): "
        + tops["sort"])

    lanes_t = torch.from_numpy(lanes).to(dev)
    splits = [_stage_run(torch, encode._encode_sort, lanes_t, tab)[0]
              for _ in range(4)][1:]
    split = {n: statistics.median(s[n] for s in splits) for n in splits[0]}
    log("phase 6 sort engine split (encode._encode_sort's stages), device "
        "lanes in, bytes on device out, median of 3 after a warm-up: "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in split.items())
        + f"; sum {sum(split.values()):.2f} ms")

    # the engine's own kernel inputs and outputs at the main path's shape
    _, made, (out_b, lens) = _stage_run(torch, encode._encode_sort, lanes_t,
                                        tab, keep=True)
    lens = lens.cpu().numpy()
    out_b = out_b.cpu().numpy()
    check([out_b[s, : lens[s]].tobytes() for s in range(S)] == streams,
          "the split's sort engine run != encode_lanes(engine='sort')")
    K, Tq = made["precompute and counts"]
    xs, _ = made["sym sort"]
    qlo, qhi = made["compact sort"]
    walk_ms = _time_cuda(torch, lambda: ek.walk_symbols(xs, K, tab))
    coder_ms = _time_cuda(torch, lambda: ek.coder_scan_off_q(qlo, qhi))
    copies4 = time_copies(torch, "coder_scan", variants, coder_ms,
                          lambda: ek.coder_scan_off_q(qlo, qhi),
                          made["coder"], tags=CODER_TAGS["coder_scan_off_q"])
    piece, walk = walk_pieces(((xs >> 12) & 1).bool(),
                              build.constant("walk_symbols", "kChunks"))
    log(f"phase 6 kernels alone, {S} lanes x {H * W * C} symbols (K {K}, "
        f"{Tq} quads): walk_symbols {walk_ms:.3f} ms (longest piece "
        f"{piece} symbols, longest thread walk {walk}), coder_scan_off_q "
        f"{coder_ms:.3f} ms")
    copies = time_copies(torch, "walk_symbols", variants, walk_ms,
                         lambda: ek.walk_symbols(xs, K, tab), made["walk"],
                         ((xs >> 12) & 1).bool())
    log(f"phase 6 walk_symbols ms beside its copies, same output (shipped "
        f"C {WALK_SHIPPED['walk_symbols'][0]}, D "
        f"{WALK_SHIPPED['walk_symbols'][1]}, timed between the copies; each "
        f"copy's longest thread walk): " + _copies_line(copies))
    log(f"phase 6 coder_scan_off_q ms beside its copies, {S} lanes x {Tq} "
        f"quads, same output (shipped {SPLIT_SHIPPED}, timed between the "
        f"copies): "
        + _copies_line(copies4))
    e = _sort_kernels_vs_plain(torch, made, tab)
    check(e["walk"] == 0 and e["coder"] == 0, f"main path: sort kernels != "
          f"plain (walk {e['walk']}, coder {e['coder']})")
    log(f"phase 6 kernels vs plain on the engine's inputs, same shape: walk "
        f"kernel {walk_ms:.3f} ms vs plain {e['walk_plain_ms']:.1f} ms, "
        f"coder kernel {coder_ms:.3f} ms vs plain {e['coder_plain_ms']:.1f} "
        f"ms; lo/hi, kp and fin exact")

    # bounds on the engine's own inputs: the decisions are its valid records
    lo, hi = made["walk"]
    kp, fin = made["coder"]
    n_dec = _valid(qlo, (0, 10)) + _valid(qhi, (0, 10))
    bounds = {
        "walk_symbols": bound(
            4 * (xs.numel() + lo.numel() + hi.numel()),
            n_dec * (OPS_DECISION + OPS_STATE + OPS_RECORD)
            + xs.numel() * OPS_SYMBOL_ENC),
        "coder_scan_off_q": bound(
            4 * (qlo.numel() + qhi.numel() + kp.numel() + fin.numel()),
            n_dec * (OPS_CODER + OPS_RECORD) + 4 * qlo.numel())}
    log(f"phase 6 bounds, {xs.numel()} symbols, {n_dec} decisions: "
        + ", ".join(f"{k} {b['bound_ms']:.4f} ms by {b['bound_by']} "
                    f"({b['bytes']} B, {b['ops']} ops)"
                    for k, b in bounds.items()))
    return {"counts": counts, "walk_ms": walk_ms, "coder_ms": coder_ms,
            "bounds": bounds, "piece": piece, "thread_walk": walk,
            "walk_copies": {k: min(ts) for k, (ts, _) in copies.items()},
            "coder_copies": {k: min(ts) for k, (ts, _) in copies4.items()},
            **e}


def phase_decision(torch, log, card: str, variants: dict) -> dict:
    """Phase 7: the decision variant on the unprimed bench batch: bytes
    against both other encodes (also on a worst-case batch), round trip,
    launches, memory against the lane budget, timings; on one chunk of all
    lanes, kernels 5-8 against their plain versions on the inputs the engine
    gave them, kernel 7 beside its copies ``variants`` ({VARIANTS key:
    library}), and kernel 8's own path to the variant's streams."""
    from llcomp_tpu_torch import coder, decode, encode
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef
    from llcomp_tpu_torch.kernels import encode_kernels as ek

    dev = torch.device("cuda")
    lanes = bench_lanes(bench_images(100))
    check(sha(lanes) == IMAGE_SHA["batch"], "bench images drifted")
    S, H, W, C = lanes.shape
    n = H * W * C
    mp = BENCH_IMAGES * BENCH_SIZE * BENCH_SIZE / 1e6
    kw = {"device": dev, "engine": "sort", "variant": "decision"}
    chunk = min(S, encode.lanes_per_chunk(n, "sort", "decision"))
    budget = encode.lane_bytes(n, "sort", "decision")

    def peak_per_lane(fn):
        """fn()'s result and its peak device bytes a lane of one chunk."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        return out, (torch.cuda.max_memory_allocated() - base) / chunk

    # the main path: unprimed encode through kernels 5-7, decode (kernel 2)
    path = {"build_stream": ek.build_stream, "walk_probs": ek.walk_probs,
            "coder_scan_off": ek.coder_scan_off, "decode_kernel": dk.decode,
            "walk_symbols": ek.walk_symbols,
            "coder_scan_off_q": ek.coder_scan_off_q,
            "encode_fused": ef.encode_fused}
    for k in path.values():
        k.launches = 0
    t0 = time.perf_counter()
    streams, peak = peak_per_lane(lambda: encode.encode_lanes(lanes, **kw))
    t1 = time.perf_counter()
    out = decode.decode_lanes(streams, (H, W, C), device=dev)
    t2 = time.perf_counter()
    counts = {name: k.launches for name, k in path.items()}
    on = ("build_stream", "walk_probs", "coder_scan_off", "decode_kernel")
    check(all(counts[k] for k in on)
          and not any(counts[k] for k in counts if k not in on),
          f"decision path launches wrong: {counts}")
    check(np.array_equal(out, lanes), "decision variant: round trip not exact")
    check(streams == encode.encode_lanes(lanes, device=dev),
          "unprimed batch: decision variant != fused engine")
    check(streams == encode.encode_lanes(lanes, device=dev, engine="sort"),
          "unprimed batch: decision variant != symbol variant")
    log(f"phase 7 decision variant: {S} lanes x {n} symbols unprimed, "
        f"{-(-S // chunk)} chunk(s) of {chunk} lanes, bytes == fused engine "
        f"== symbol variant, exact through kernel 2; first run encode "
        f"{t1 - t0:.3f} s, decode {t2 - t1:.3f} s; launches on this path "
        f"{counts}")

    worst = _worst_lanes(lanes.shape)
    got, peak_w = peak_per_lane(lambda: encode.encode_lanes(worst, **kw))
    check(got == encode.encode_lanes(worst, device=dev),
          "worst-case batch: decision variant != fused engine")
    check(got == encode.encode_lanes(worst, device=dev, engine="sort"),
          "worst-case batch: decision variant != symbol variant")
    check(max(peak, peak_w) <= budget, f"decision variant peak "
          f"{max(peak, peak_w)} B a lane, above encode.lane_bytes {budget} B")
    log(f"phase 7 worst-case batch (channels 0/255 at random): decision "
        f"variant bytes == fused engine == symbol variant, "
        f"{sum(map(len, got))} B; peak device memory a lane of a chunk: "
        f"bench batch {peak / 1e6:.3f} MB, worst case {peak_w / 1e6:.3f} MB, "
        f"budget {budget / 1e6:.3f} MB (encode.lane_bytes)")

    runs = {"decision": kw, "symbol": {"device": dev, "engine": "sort"},
            "fused": {"device": dev}}
    times = {name: [] for name in runs}
    for rep in range(3):
        fresh = bench_lanes(bench_images(5000 + 97 * rep))
        order = list(runs)[rep:] + list(runs)[:rep]
        got = {}
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = encode.encode_lanes(fresh, **runs[name])
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
        check(got["decision"] == got["symbol"] == got["fused"],
              f"fresh batch {rep}: the three encodes differ")
    med = {name: statistics.median(t) for name, t in times.items()}
    log(f"phase 7 end to end (host numpy in, bytes out), median of 3 fresh "
        f"unprimed batches, same batches, on {card}: " + ", ".join(
            f"{name} {med[name]:.4f} s = {mp / med[name]:.2f} MP/s"
            for name in runs))

    wall, busy, top = _device_busy(
        torch, lambda: encode.encode_lanes(lanes, **kw))
    log("phase 7 decision variant under torch.profiler (one unprimed batch "
        "encode, host numpy in, bytes out): " + _idle("decision", wall, busy)
        + "; ten largest device ops: " + top)

    lanes_t = torch.from_numpy(lanes).to(dev)
    splits = [_stage_run(torch, encode._encode_decision, lanes_t, None)[0]
              for _ in range(4)][1:]
    split = {name: statistics.median(s[name] for s in splits)
             for name in splits[0]}
    log(f"phase 7 decision variant split (encode._encode_decision's stages), "
        f"all {S} lanes in one chunk, device lanes in, bytes on device out, "
        f"median of 3 after a warm-up: "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in split.items())
        + f"; sum {sum(split.values()):.2f} ms")

    # the engine's own kernel inputs and outputs at the full shape
    _, made, (out_b, lens) = _stage_run(torch, encode._encode_decision,
                                        lanes_t, None, keep=True)
    lens_h = lens.cpu().numpy()
    out_h = out_b.cpu().numpy()
    check([out_h[s, : lens_h[s]].tobytes() for s in range(S)] == streams,
          "the split's decision run != encode_lanes(variant='decision')")
    K, Tc, h, diff = made["precompute and counts"]
    (stream,), (xs,), (probs,) = made["build"], made["walk xs"], made["walk"]
    (cx,), (kp, fin) = made["back sort"], made["coder"]
    res, outs = {}, {}
    cases = {
        "build_stream": (lambda: ek.build_stream(h, diff, n, K),
                         lambda: ek.build_stream_plain(h, diff, n, K),
                         (stream,)),
        "walk_probs": (lambda: ek.walk_probs(xs),
                       lambda: ek.walk_probs_plain(xs), (probs,)),
        "coder_scan_off": (lambda: ek.coder_scan_off(cx),
                           lambda: ek.coder_scan_off_plain(cx), (kp, fin)),
        "coder_scan": (lambda: ek.coder_scan(cx),
                       lambda: ek.coder_scan_plain(cx), None),
    }
    for name, (kernel, plain, want) in cases.items():
        ms = _time_cuda(torch, kernel)
        if want is None:          # kernel 8 is off the path: its own output
            want = kernel()
        plain_ms, got = _time_plain(torch, plain)
        got = got if isinstance(got, tuple) else (got,)
        err = max(_max_err(a, b) for a, b in zip(want, got))
        check(err == 0, f"{name}: kernel != plain on the engine's inputs "
              f"({err})")
        res[name] = {"ms": ms, "plain_ms": plain_ms, "err": err}
        outs[name] = want
    log(f"phase 7 kernels vs plain on the engine's inputs, {S} lanes x {n} "
        f"symbols (K {K}, Tc {Tc} decisions), exact: " + ", ".join(
            f"{name} kernel {r['ms']:.3f} ms vs plain {r['plain_ms']:.1f} ms"
            for name, r in res.items()))

    # kernel 6 beside its copies (other chunk counts and ring depths), with
    # the critical path of its partition
    seg = (xs & 2) != 0
    piece, walk = walk_pieces(seg, build.constant("walk_probs", "kChunks"))
    copies6 = time_copies(torch, "walk_probs", variants,
                          res["walk_probs"]["ms"], lambda: ek.walk_probs(xs),
                          (probs,), seg)
    log(f"phase 7 walk_probs, {S} lanes x {Tc} entries: "
        f"{res['walk_probs']['ms']:.3f} ms, longest piece {piece} entries, "
        f"longest thread walk {walk}; "
        f"beside its copies, same output (shipped C "
        f"{WALK_SHIPPED['walk_probs'][0]}, D {WALK_SHIPPED['walk_probs'][1]}, "
        f"timed between the copies; each copy's longest thread walk): "
        + _copies_line(copies6))
    res["walk_probs"].update(
        piece=piece, thread_walk=walk,
        copies={k: min(ts) for k, (ts, _) in copies6.items()})

    # kernel 5 beside its copies (one thread a slot, other tiles, scalar
    # stores)
    copies5 = time_copies(torch, "build_stream", variants,
                          res["build_stream"]["ms"], cases["build_stream"][0],
                          (stream,))
    log(f"phase 7 build_stream ms beside its copies, {S} lanes x {n} "
        f"symbols x K {K}, same output (shipped: tiles of "
        f"{build.constant('build_stream', 'kTile')} symbols, 16-byte "
        f"stores; timed between the copies): " + _copies_line(copies5))
    res["build_stream"]["copies"] = {k: min(ts)
                                     for k, (ts, _) in copies5.items()}

    # kernel 7 beside its copies (other lanes a block and ring depths),
    # kernel 8 beside its (other hand-over batches and stages)
    for name, what in (("coder_scan_off",
                        f"ring depth {coder_depth('coder_scan_off')}"),
                       ("coder_scan", f"{SPLIT_SHIPPED}")):
        copies = time_copies(torch, "coder_scan", variants, res[name]["ms"],
                             cases[name][0], outs[name],
                             tags=CODER_TAGS[name])
        log(f"phase 7 {name} ms beside its copies, {S} lanes x {Tc} "
            f"records, same output (shipped {what}, timed between the "
            f"copies): " + _copies_line(copies))
        res[name]["copies"] = {k: min(ts) for k, (ts, _) in copies.items()}

    # kernel 8's own path: the slot-record coder on the variant's records
    ek.coder_scan.launches = 0
    meta, runs_, fin4 = ek.coder_scan(cx)
    meta_f, runs_f = coder.finish_steps(fin4)
    by, ln = coder.expand_slots(torch.cat([meta, meta_f]),
                                torch.cat([runs_, runs_f]), encode.outcap(n))
    res["coder_scan"]["launches"] = ek.coder_scan.launches
    ln_h, by_h = ln.cpu().numpy(), by.cpu().numpy()
    check(res["coder_scan"]["launches"] == 1 and np.array_equal(ln_h, lens_h)
          and [by_h[s, : ln_h[s]].tobytes() for s in range(S)] == streams,
          "coder_scan + finish_steps + expand_slots != the variant's streams")
    log(f"phase 7 slot-record path (coder_scan, coder.finish_steps, "
        f"coder.expand_slots) on the variant's coder records: streams and "
        f"lengths == the variant's; coder_scan launches on this path "
        f"{res['coder_scan']['launches']}")
    for name in ("build_stream", "walk_probs", "coder_scan_off"):
        res[name]["launches"] = counts[name]

    # bounds on the engine's own inputs: the decisions are its valid records
    n_dec = _valid(cx, (0,))
    res["build_stream"]["bound"] = bound(
        4 * (h.numel() + diff.numel() + stream.numel()),
        stream.numel() * (OPS_DECISION + OPS_RECORD))
    res["walk_probs"]["bound"] = bound(4 * (xs.numel() + probs.numel()),
                                       xs.numel() * OPS_STATE)
    res["coder_scan_off"]["bound"] = bound(
        4 * (cx.numel() + kp.numel() + fin.numel()),
        n_dec * (OPS_CODER + OPS_RECORD) + cx.numel())
    res["coder_scan"]["bound"] = bound(
        4 * (cx.numel() + meta.numel() + runs_.numel() + fin4.numel()),
        n_dec * (OPS_CODER + OPS_RECORD) + cx.numel())
    log(f"phase 7 bounds, {n_dec} decisions in {cx.numel()} records: "
        + ", ".join(f"{k} {b['bound_ms']:.4f} ms by {b['bound_by']} "
                    f"({b['bytes']} B, {b['ops']} ops)"
                    for k, b in ((k, res[k]["bound"]) for k in cases)))
    return res


def _library_call(torch, key: str, a: dict):
    """The one PyTorch call that computes probe ``key``'s function on its
    arguments ``a`` (index tensors built here, outside any timed window),
    or None where there is none."""
    if "idx" not in a:
        return None
    idx, lanes = a["idx"][:1], a["idx"].shape[1]
    if key in ("p1", "p2", "pB", "p5", "pE16", "pE32"):
        m = {"p5": 32, "pE16": 16, "pE32": 32}.get(key)
        ix = (idx % m if m else idx).long()
        return lambda: torch.gather(a["src"], 0, ix)
    if key in ("p4", "pD8", "pD16"):
        win = a.get("win", 8)
        ix = (idx.clamp(max=a["src"].shape[0] - win)
              + torch.arange(win, device=idx.device)[:, None]).long()
        return lambda: torch.gather(a["src"], 0, ix)
    if key in ("p0", "p3", "pC"):
        rows = 64 if key == "p0" else 8
        r = idx % rows
        ix, val = r.long(), r if key == "p0" else a["val"]
        out = torch.zeros((rows, lanes), dtype=torch.int32, device=idx.device)
        return lambda: out.scatter_(0, ix, val)
    if key == "p6":
        return lambda: torch.add(idx, 1)
    if key == "pA":
        one = torch.ones((), dtype=torch.int32, device=idx.device)
        return lambda: torch.add(one, idx, alpha=2)
    return None


def _device_us(prof) -> dict:
    """{kernel: device microseconds} of a ``torch.profiler`` session, the
    profiler's own buffer request left out."""
    from torch.autograd import DeviceType

    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.key != "Activity Buffer Request"}


def _in_turns(torch, calls: dict, n: int, attempts: int = 3) -> dict:
    """Device milliseconds a call of each of ``calls`` (name -> fn) under
    one ``torch.profiler`` session in which the calls take turns ``n``
    times, so that all of them meet the same clocks (from one session to
    the next a one-shot kernel's time moves by a third).  A call's time is
    that of the kernels its warm-up (10 calls, profiled alone) launched,
    which no other call may launch.  A session that lost a call's kernels
    (the profiler's buffers sometimes come back empty) is made again, up
    to ``attempts`` times; None where the profiler never saw them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(attempts):
        kernels = {}
        for name, fn in calls.items():
            with profile(activities=activities) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            kernels[name] = set(_device_us(prof))
        check(sum(map(len, kernels.values()))
              == len(set().union(*kernels.values())),
              f"calls timed in turns share a kernel: {kernels}")
        with profile(activities=activities) as prof:
            for _ in range(n):
                for fn in calls.values():
                    fn()
            torch.cuda.synchronize()
        us = _device_us(prof)
        ms = {name: sum(us.get(k, 0) for k in ks) / n / 1e3 or None
              for name, ks in kernels.items()}
        if None not in ms.values():
            break
    return ms


def _empty_launch(torch):
    """A call that launches a kernel doing nothing (one warp of
    ``llct_probe_empty``, ``csrc/probe_mosaic3.cu``): its device time is
    the launch floor."""
    from llcomp_tpu_torch.kernels import build

    fn = build.load("probe_mosaic3", "llct_probe_empty", [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: build.check(fn(stream), "llct_probe_empty")


def _probe_bound(key: str, a: dict, floor_ms: float | None) -> dict:
    """bound() of probe ``key`` on its arguments ``a``, from their shapes:
    the words each argument gives the probe read once, its output written
    once, and a stepped probe's T x lanes x the model words a step stages
    (a lane rarely meets a row again in 15,872).  A one-shot probe's bound,
    and p11's (timed as they are), is at least ``floor_ms``, the device
    time of an empty launch (bound_by "launch" where that wins); work_ms
    and work_by keep the bound of its bytes and operations alone."""
    b = _probe_work_bound(key, a)
    b.update(work_ms=b["bound_ms"], work_by=b["bound_by"])
    alone = not a.get("T") or key == "p11"   # timed beside the empty launch
    if alone and floor_ms is not None and floor_ms > b["bound_ms"]:
        b.update(bound_ms=floor_ms, bound_by="launch")
    return b


def _probe_work_bound(key: str, a: dict) -> dict:
    idx = a["idx"] if "idx" in a else a["x"]
    L, T = idx.shape[1], a.get("T", 0)
    word = 4
    one_shot = {"p1": 1, "p2": 1, "pB": 1, "p5": 1, "pE16": 1, "pE32": 1,
                "p4": 8, "pD8": 8, "pD16": 16}
    if key in one_shot:                   # idx row in, words gathered, out
        return bound(word * L * (1 + 2 * one_shot[key]), L)
    if key in ("p0", "p3", "pC"):         # idx (and val) in, rows out
        n_out = 64 if key == "p0" else 8
        return bound(word * L * (1 + (key != "p0") + n_out), L * n_out)
    if key in ("p6", "pA"):
        return bound(2 * word * L, L * (1 + (key == "pA")))
    if key in ("p9", "p10"):
        return bound(2 * word * L, T * L * 24 * OPS_PROBE_DECISION)
    if key == "pG":
        return bound(2 * word * idx.numel(), 2 * idx.numel())
    if key == "reduce":
        return bound(word * (idx.numel() + 16 * L), 6 * idx.numel())
    step = OPS_PROBE_ROW + 2 * OPS_PROBE_WORD
    if key == "p11":                      # nstage lanes read, no stores
        k = min(8, L)
        return bound(word * (2 * L + T * k),
                     T * k * (OPS_PROBE_ROW + OPS_PROBE_WORD))
    if key == "p8":                       # one word read and written
        return bound(word * (2 * L + 2 * T * L), T * L * step)
    if key in ("p7", "pF"):               # two words read and written
        return bound(word * (2 * L + 4 * T * L),
                     T * L * (step + 24 * OPS_PROBE_DECISION))
    # pH: the idx rows its steps read, two words read and written a step,
    # with the window 8 data words read a step, out [8, lanes]
    win = 8 if a["window"] else 0
    return bound(word * (min(T, idx.shape[0]) * L + (4 + win) * T * L + 8 * L),
                 T * L * (step + win * OPS_PROBE_WORD))


def _call_under(name: str, so: pathlib.Path, fn):
    """``fn`` as a call that launches the library ``so`` in place of
    ``csrc/<name>.cu``'s build (``running``)."""
    def call():
        with running(name, so):
            return fn()
    return call


def one_shot_turns(torch, variants: dict) -> dict:
    """Each one-shot probe beside the empty launch and, where there is
    one, its library call, in turns (``_in_turns``), one profiler session
    a probe, so that a probe's share of the launch floor and its library
    call's time come from the clocks its own time met (from one session to
    the next a one-shot kernel's time moves by a third): {key: {"empty",
    key, "library": device ms}}; the reduce probe and pG also beside their
    copies ``REDUCE_TAGS`` and ``PG_TAGS`` of ``variants`` in the same
    session ({tag: device ms}).  p11, at its T, is timed so too, beside
    its copies ``P11_TAGS``, in a session for each of ``PROBE_LANES``
    ({"p11 <lanes>": {"empty", "p11", tag: device ms}}).  Made before any
    other profiler session of the process: after the profiled encodes of
    phases 6 and 7, short sessions lost the empty launch's and
    ``scatter_``'s kernels in every attempt."""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.probes import mosaic, mosaic2, mosaic3, reduce

    dev = torch.device("cuda")
    empty, out = _empty_launch(torch), {}
    copies = {"reduce": REDUCE_TAGS, "pG": PG_TAGS, "p11": P11_TAGS}
    for m in (mosaic, mosaic2, mosaic3, reduce):
        for key, p in m.PROBES.items():
            if p.T and key != "p11":
                continue
            for lanes in PROBE_LANES if p.T else (128,):
                a = p.make(0, lanes, probes.ROWS, dev)
                if p.T:
                    a["T"] = p.T
                calls = {"empty": empty, key: functools.partial(p.fn, **a)}
                if (call := _library_call(torch, key, a)) is not None:
                    calls["library"] = call
                calls.update({tag: _call_under(
                    m.SRC, variants[m.SRC, tag], calls[key])
                    for tag in copies.get(key, ())})
                out[f"{key} {lanes}" if p.T else key] = _in_turns(
                    torch, calls, probes.LAUNCHES)
    return out


def ph_copies(torch, variants: dict) -> dict:
    """Probe pH beside its copies ``variants`` (one block, and each
    cluster size of ``PH_CLUSTERS``) at ``PROBE_LANES`` x ``PH_STEPS``,
    with and without the window: each copy exact against
    ``pH_stage_plain`` (outputs and planes of random words, through
    ``probes.run_probe``) and its ns a step (median of 3 fresh inputs),
    the shipped kernel timed before the copies and after them.  A copy at
    a cluster size the card refuses (past the portable 8) gives the error
    in place of a time.  -> {(key, lanes, T): {tag: [ns] or the error}}"""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.probes import mosaic3

    dev = torch.device("cuda")
    tags = {tag: variants["probe_mosaic3", tag] for tag in PH_TAGS}
    out = {}
    for key in ("pHw", "pHn"):
        p = mosaic3.PROBES[key]
        for lanes in PROBE_LANES:
            for T in PH_STEPS:
                def ns():
                    return probes.run_probe(p, dev, lanes=lanes, T=T,
                                            check=False)["ns_step"]
                row = {"shipped": [ns()]}
                for tag, so in tags.items():
                    with running("probe_mosaic3", so):
                        try:
                            r = probes.run_probe(p, dev, lanes=lanes, T=T)
                        except RuntimeError as e:
                            check(tag == f"cluster {PH_CLUSTERS[-1]}" and
                                  PH_CLUSTERS[-1] > 8, f"{key} copy {tag!r}"
                                  f", {lanes} lanes, T {T}: {e}")
                            row[tag] = f"refused ({e})"
                            continue
                    check(r["err"] == 0 and r["telling"], f"{key} copy "
                          f"{tag!r}, {lanes} lanes, T {T}: kernel != plain "
                          f"({r['err']})")
                    row[tag] = [r["ns_step"]]
                row["shipped"].append(ns())
                out[key, lanes, T] = row
    return out


def p7_hazard_cases(depths=ROW_DEPTHS) -> list:
    """p7's inputs where its row ring meets its hazards, at every ring depth
    of ``depths`` (p8, on p7's rows, takes them at ``STAGE_DEPTHS``):
    [(name, idx [1, lanes] int32, rows, T)].  On the
    15,872-row plane the lanes at x = 7110 and 7110 + 15,871 (every third
    and the ones after) land on row 7110 at every step (x + 40503 is a
    multiple of 15,871); planes of 2, 3 and 17 rows repeat rows within any
    ring; T around each depth leaves the ring part full."""
    rng = np.random.default_rng(7110)

    def idx(lanes):
        return rng.integers(0, 2**31, (1, lanes), dtype=np.int32)

    same = idx(128)
    same[0, ::3], same[0, 1::3] = 7110, 7110 + 15871
    cases = [("7110 lanes", same, 15872, 64)]
    cases += [(f"{rows} rows", idx(128), rows, 64) for rows in (2, 3, 17)]
    cases += [(f"T {T}", idx(33), 17, T) for T in sorted(
        {0, 1} | {d + e for d in depths for e in (-1, 0, 1)})]
    return cases


def pF_hazard_cases() -> list:
    """pF's inputs where its pair ring meets its hazards, at every ring
    depth of ``PAIR_DEPTHS``: [(name, idx [1, lanes] int32, rows, T)].  On
    the 15,872-row plane (pairs taken mod m = rows/2 - 1 = 7,935) the
    lanes at x = 7107 and 7107 + 7,935 (every third and the ones after)
    land on pair 14,214 at every step (x + 40503 = 6 x 7,935); planes of
    4, 6 and 36 rows (m = 1, 2 and 17) repeat pairs within any ring; T
    around each depth leaves the ring part full.  idx is drawn over the
    whole non-negative int32 range, so that x*(s+1) wraps."""
    rng = np.random.default_rng(7107)

    def idx(lanes):
        return rng.integers(0, 2**31, (1, lanes), dtype=np.int32)

    same = idx(128)
    same[0, ::3], same[0, 1::3] = 7107, 7107 + 7935
    cases = [("7107 lanes", same, 15872, 64)]
    cases += [(f"{rows} rows", idx(128), rows, 64) for rows in (4, 6, 36)]
    cases += [(f"T {T}", idx(33), 36, T) for T in sorted(
        {0, 1} | {d + e for d in PAIR_DEPTHS for e in (-1, 0, 1)})]
    return cases


REDUCE_SHAPES = ((32, 1), (32, 128), (64, 33), (64, 128), (100, 33),
                 (100, 128), (160, 1), (160, 128))   # (rows, lanes)


def reduce_cases() -> list:
    """The reduce probe's inputs where its skip rule meets its edges:
    [(name, x [rows, lanes] int32)] at each of ``REDUCE_SHAPES`` (rows
    past the last multiple of 32 unread; acc restarting every 32 rows
    while the count of slices since the last flush runs on).  Each
    shape takes every pattern: all words odd (a flush every 4th slice),
    all even (never a flush, a maximum on every slice from the 4th), one
    odd word a slice in one lane (the first flush at slice 3), sparse odd
    words in one lane (flushes at gaps of 5 and more), words over the
    whole int32 range (``v & 1`` of a negative word), and the probe's own
    words 0-3."""
    rng = np.random.default_rng(3)
    cases = []
    for rows, lanes in REDUCE_SHAPES:
        def words(low, high):
            return rng.integers(low, high, (rows, lanes), dtype=np.int64)

        even = 2 * words(-2**30, 2**30)
        one = even.copy()
        one[::8, lanes // 2] |= 1
        sparse = even.copy()
        sparse[::8, lanes - 1] |= rng.random(-(-rows // 8)) < 0.6
        for name, x in (("odd", 2 * words(-2**30, 2**30) + 1),
                        ("even", even), ("one odd", one),
                        ("sparse", sparse), ("int32", words(-2**31, 2**31)),
                        ("0-3", words(0, 4))):
            cases.append((f"{name} {rows}x{lanes}", x.astype(np.int32)))
    return cases


def p9_hazard_idx(lanes: int = 128) -> np.ndarray:
    """p9's idx [1, lanes] at the byte's edges: bytes 0xFF (the step to
    0x00 wraps) and 0x00, and values past 255 (only the low byte is
    read), then random words."""
    out = np.random.default_rng(255).integers(0, 2**31, (1, lanes),
                                              dtype=np.int32)
    edges = [0xFF, 0, 0x1FF, 0x100, 0xFFFF, 2**31 - 1, 0x80, 0xFE]
    out[0, :len(edges)] = edges[:lanes]
    return out


P11_LANES = (100, 128, 1024)   # a ragged warp, the probe's and the bench's


def p11_cases() -> list:
    """p11's edges: [(name, lanes, rows, T, nstage)], each at every lane
    count of ``P11_LANES``: nstage -1 and 0 (no lane staged), 1, 8, 9
    and 33 (ragged blocks of a warp a lane) and past the lanes, at T 33;
    T 0, 1, 31, 32 and 33 (threads of a warp with no step, one, and a
    second pass) and 512, at nstage 33; planes of 2 and 3 rows (m = 1, 2)
    at T 512.  The plane has 300 rows where not said (``p11_inputs``
    makes idx and the plane)."""
    cases = []
    for lanes in P11_LANES:
        cases += [(f"nstage {n}, {lanes} lanes", lanes, 300, 33, n)
                  for n in (-1, 0, 1, 8, 9, 33, lanes + 1)]
        cases += [(f"T {T}, {lanes} lanes", lanes, 300, T, 33)
                  for T in (0, 1, 31, 32, 33, 512)]
        cases += [(f"{rows} rows, {lanes} lanes", lanes, rows, 512, 33)
                  for rows in (2, 3)]
    return cases


def p11_inputs(name: str, lanes: int, rows: int) -> tuple:
    """The inputs of p11 case ``name``: idx [1, lanes] and a plane [rows,
    lanes] of random words over the whole int32 range (idx negative too,
    the sums wrapping), from a seed of the name."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.integers(-2**31, 2**31, (1, lanes), dtype=np.int32),
            rng.integers(-2**31, 2**31, (rows, lanes), dtype=np.int32))


# pG's sizes: words and the shape of x
PG_WORDS = {1: (1, 1), 3: (1, 3), 1024: (8, 128), 1027: (1, 1027),
            8192: (64, 128)}


def pG_cases() -> list:
    """pG's edges: [(name, x int32 of a ``PG_WORDS`` shape, offset)], x
    to start ``offset`` words past a 16-byte boundary on the card (0: the
    int4 path from word 0; 1 and 3: a head of 3 and 1 words).  At every
    size and offset, words below 100 but for: one word of exactly 100 (x
    - 1) or 101 (x + 1); the maximum only in the last word (in the tail
    where n mod 4 != 0 and the head leaves one) or only in the first (in
    the head where the offset leaves one); INT32_MAX first and last (+1
    wraps to INT32_MIN); INT32_MIN first and last with the maximum below
    100 (-1 wraps to INT32_MAX)."""
    rng = np.random.default_rng(101)
    lo, hi = -2**31, 2**31 - 1
    cases = []
    for n, shape in PG_WORDS.items():
        for off in (0, 1, 3):
            for pattern in ("max 100", "max 101", "max last", "max first",
                            "INT32_MAX + 1", "INT32_MIN - 1"):
                x = rng.integers(-1000, 100, n, dtype=np.int64)
                at = int(rng.integers(0, n))
                if pattern in ("max 100", "max 101"):
                    x[at] = int(pattern[4:])
                elif pattern == "max last":
                    x[-1] = 5000
                elif pattern == "max first":
                    x[0] = 5000
                else:
                    x[0] = x[-1] = hi if pattern[6:9] == "MAX" else lo
                cases.append((f"{pattern}, n {n}, offset {off}",
                              x.astype(np.int32).reshape(shape), off))
    return cases


def at_offset(torch, x: np.ndarray, offset: int):
    """``x`` on the card as a contiguous view that starts ``offset`` words
    past a 16-byte boundary."""
    buf = torch.empty(x.size + offset, dtype=torch.int32, device="cuda")
    check(buf.data_ptr() % 16 == 0, "a fresh allocation off 16 bytes")
    view = buf[offset:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


def few_copies(torch, variants: dict) -> int:
    """p11 and its copies ``P11_TAGS`` against ``p11_stage_few_plain``,
    exactly (output and plane), on every ``p11_cases`` input and at the
    probe's shape (15,872 rows of random words, T 512, nstage 8) at
    ``PROBE_LANES``: the number of cases."""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.probes import mosaic

    dev = torch.device("cuda")
    cases = []
    for name, lanes, rows, T, nstage in p11_cases():
        idx, plane = p11_inputs(name, lanes, rows)
        cases.append((name, torch.from_numpy(idx).to(dev),
                      torch.from_numpy(plane).to(dev), T, nstage))
    p = mosaic.PROBES["p11"]
    for lanes in PROBE_LANES:
        a = p.make(0, lanes, probes.ROWS, dev)
        cases.append((f"the probe's shape, {lanes} lanes", a["idx"],
                      probes.words(lanes, a["model"].shape, dev), p.T, 8))
    for name, idx, plane, T, nstage in cases:
        want = mosaic.p11_stage_few_plain(idx, T, nstage, plane.clone())
        for tag in ("shipped", *P11_TAGS):
            model = plane.clone()
            with (contextlib.nullcontext() if tag == "shipped" else
                  running(mosaic.SRC, variants[mosaic.SRC, tag])):
                out = mosaic.p11_stage_few(idx, T, nstage, model)
            check(torch.equal(out, want) and torch.equal(model, plane),
                  f"p11 {tag}, {name}: kernel != plain")
    return len(cases)


def gate_copies(torch, variants: dict) -> int:
    """pG and its copies ``PG_TAGS`` against ``pG_scalar_gate_plain``,
    exactly, on every ``pG_cases`` input, x at its offset (the wrapper
    gives out the same one: the int4 path after the head); the shipped
    entry point refuses an out at a 16-byte boundary where x is not: the
    number of cases."""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.probes import mosaic3

    cases = pG_cases()
    for name, x, off in cases:
        xd = at_offset(torch, x, off)
        want = mosaic3.pG_scalar_gate_plain(xd)
        for tag in ("shipped", *PG_TAGS):
            with (contextlib.nullcontext() if tag == "shipped" else
                  running(mosaic3.SRC, variants[mosaic3.SRC, tag])):
                out = mosaic3.pG_scalar_gate(xd)
            check(torch.equal(out, want), f"pG {tag}, {name}: kernel != "
                  "plain")
        if off:     # out on a 16-byte boundary where x is not
            try:
                probes.launch(mosaic3.SRC, "llct_probe_pG", xd,
                              torch.empty_like(xd), x.size)
                refused = False
            except RuntimeError:
                refused = True
            check(refused, f"pG, {name}: launched with x and out apart "
                  "mod 16")
    return len(cases)


def step_copies(torch, variants: dict) -> dict:
    """The stepped probes p7-p10 and pF beside their copies
    ``PROBE_TAGS`` (the serial step they replaced, p7, p8 and pF at other
    ring depths, p9 unrolled, p10 and pF on the steps not taken, p8 with
    its rows stepped by additions).  Each copy is held exactly (output and
    planes) against one plain output a case: p7 on ``p7_hazard_cases``, p8
    on the same at its depths, pF on ``pF_hazard_cases``, p9 and p10 on
    ``p9_hazard_idx`` at T 0, 1, 2 and 64, all at ``PROBE_LANES`` x the
    probe's T on planes of random words; the plain version runs once a
    case, each copy on a copy of its inputs.  Then ns a step at
    ``PROBE_LANES`` x the probe's T in turns, ``PROBE_ROUNDS`` rounds, the
    order reversed in every other round (``probes.run_probe``: median of 3
    fresh inputs, zeroed planes), the SM clock read after them.  ->
    {"cases": n, "ns": {(key, lanes): {tag: [ns]}}, "clock_mhz": (SM
    clock, its maximum)}"""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.probes import mosaic, mosaic2

    dev = torch.device("cuda")
    module = {key: m for m in (mosaic, mosaic2) for key in m.PROBES
              if key in PROBE_TAGS}

    def under(key, tag):
        src = module[key].SRC
        return (contextlib.nullcontext() if tag == "shipped" else
                running(src, variants[src, tag]))

    def copied(kw):
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}

    def held(key, kw, what):
        p, ref = module[key].PROBES[key], copied(kw)
        want = p.plain(**ref)
        for tag in ("shipped", *PROBE_TAGS[key]):
            a = copied(kw)
            with under(key, tag):
                out = p.fn(**a)
            check(torch.equal(out, want) and all(
                torch.equal(v, ref[k]) for k, v in a.items()
                if isinstance(v, torch.Tensor)),
                f"{key} {tag}, {what}: kernel != plain")

    cases = 0
    for key, hazards in (("p7", p7_hazard_cases()),
                         ("p8", p7_hazard_cases(STAGE_DEPTHS)),
                         ("pF", pF_hazard_cases())):
        for name, idx, rows, T in hazards:
            shape = ((2,) if key == "p7" else ()) + (rows, idx.shape[1])
            held(key, {"idx": torch.from_numpy(idx).to(dev), "T": T,
                       "model": probes.words(rows, shape, dev)}, name)
            cases += 1
    for key in ("p9", "p10"):
        for T in (0, 1, 2, 64):
            held(key, {"idx": torch.from_numpy(p9_hazard_idx()).to(dev),
                       "T": T}, f"byte edges, T {T}")
            cases += 1
    for key in PROBE_TAGS:
        p = module[key].PROBES[key]
        for lanes in PROBE_LANES:
            kw = {**p.make(0, lanes, probes.ROWS, dev), "T": p.T}
            if "model" in kw:
                kw["model"] = probes.words(0, kw["model"].shape, dev)
            held(key, kw, f"{lanes} lanes, T {p.T}")
            cases += 1
    ns = {}
    for key, tags in PROBE_TAGS.items():
        p = module[key].PROBES[key]
        for lanes in PROBE_LANES:
            row = ns[key, lanes] = {tag: [] for tag in ("shipped", *tags)}
            for r in range(PROBE_ROUNDS):
                turn = list(row.items())    # reversed every other round
                for tag, v in turn if r % 2 == 0 else turn[::-1]:
                    with under(key, tag):
                        v.append(probes.run_probe(p, dev, lanes=lanes,
                                                  check=False)["ns_step"])
    clock = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split(",")
    return {"cases": cases, "ns": ns,
            "clock_mhz": tuple(float(c) for c in clock)}


def reduce_copies(torch, variants: dict) -> int:
    """The reduce probe and its copies ``REDUCE_TAGS`` against
    ``run_plain``, exactly, on every ``reduce_cases`` input: the number
    of cases."""
    from llcomp_tpu_torch.probes import reduce

    cases = reduce_cases()
    for name, x in cases:
        x = torch.from_numpy(x).cuda()
        want = reduce.run_plain(x)
        for tag in ("shipped", *REDUCE_TAGS):
            with (contextlib.nullcontext() if tag == "shipped" else
                  running(reduce.SRC, variants[reduce.SRC, tag])):
                out = reduce.run(x)
            check(torch.equal(out, want), f"reduce {tag}, {name}: kernel "
                  "!= plain")
    return len(cases)


# The integer pipes of an SM sub-partition that each opcode issues to:
# the ALU pipe and the FMA pipe (IMAD in all its forms), each taking a
# warp instruction every two clocks.
ALU_OPCODES = ("IADD3", "LOP3", "PRMT", "SHF", "LEA", "ISETP", "SEL")
FMA_OPCODES = ("IMAD",)
# Each decision loop's kernel, the copy it is built in (shipped: the
# shipped source) and the decisions its innermost loop takes
DECISION_LOOPS = {
    ("p9", "shipped"): ("decisions_perm<false>", 1),
    ("p9", "serial step"): ("decisions_only<false>", 1),
    ("p9", "p9 unrolled"): ("decisions_perm<true>", 24),
    ("p10", "shipped"): ("decisions_perm<true>", 24),
    ("p10", "serial step"): ("decisions_only<true>", 24),
    ("p10", "p10 split"): ("decisions_split", 24),
    ("p10", "p10 pipes"): ("decisions_pipes", 24)}


def decision_sass(variants: dict) -> dict:
    """p9's and p10's decision loops in the shipped build and their
    copies, from the SASS: {(probe, tag): (kernel, instructions a
    decision, dependent instructions a decision on the loop's carried
    chain (``sass_chain``), that chain's opcodes, instructions a decision
    to the ALU pipe, to the FMA pipe)}.  The rolled kernels' innermost
    loop is one decision; the unrolled ones' a step of 24."""
    from llcomp_tpu_torch.kernels import build

    out = {}
    for (key, tag), (name, per) in DECISION_LOOPS.items():
        so = (build.build("probe_mosaic") if tag == "shipped"
              else variants["probe_mosaic", tag])
        ins, labels = sass_functions(sass(so))[name]
        a, b = max(inner_loops(ins, labels), key=lambda ab: ab[1] - ab[0])
        body = [t for x, t in ins if a <= x <= b]
        chain, ops = sass_chain(body)
        pipe = [sass_opcode(t) for t in body]
        out[key, tag] = (name, len(body) / per, chain / per, ops,
                         sum(o in ALU_OPCODES for o in pipe) / per,
                         sum(o in FMA_OPCODES for o in pipe) / per)
    return out


# p8's, pF's and p11's step loops: the source, the copies, the kernel of
# each (by tag; "shipped" the shipped build's), and the opcode that a step
# issues a fixed number of times with that number: p8 one store, pF two,
# p11 one load (it stores nothing).  A loop pass takes as many steps as it
# has of those over that: the ring's depth, a serial loop one or as many
# as the compiler unrolled, p11's warp design a thread's batch.
STEP_LOOPS = {
    "p8": ("probe_mosaic", PROBE_TAGS["p8"], "stage_only", "STG", 1),
    "pF": ("probe_mosaic2", PROBE_TAGS["pF"], "pair_steps", "STG", 2),
    "p11": ("probe_mosaic", P11_TAGS, {
        "shipped": "stage_few<1>", "p11 serial": "stage_few_serial",
        "p11 ring": "stage_few_ring", "p11 8 warps": "stage_few<8>"},
        "LDG", 1)}


def step_sass(variants: dict) -> dict:
    """The step loops of ``STEP_LOOPS`` in the shipped build and each
    copy, from the SASS (``sass_functions``, as ``decision_sass`` reads
    them): {(probe, tag): (instructions a step, dependent instructions a
    step on the loop's carried chain (``sass_chain``), steps a loop
    pass)}."""
    from llcomp_tpu_torch.kernels import build

    out = {}
    for key, (src, tags, names, opcode, per) in STEP_LOOPS.items():
        for tag in ("shipped", *tags):
            so = (build.build(src) if tag == "shipped"
                  else variants[src, tag])
            name = names if isinstance(names, str) else names[tag]
            ins, labels = sass_functions(sass(so))[name]
            a, b = max(inner_loops(ins, labels), key=lambda ab: ab[1] - ab[0])
            body = [t for x, t in ins if a <= x <= b]
            steps = sum(sass_opcode(t) == opcode for t in body) / per
            check(steps > 0, f"{key} {tag}: no {opcode} in {name}'s loop")
            chain, _ = sass_chain(body)
            out[key, tag] = (len(body) / steps, chain / steps, steps)
    return out


def phase_probes(torch, log, card: str, turns: dict,
                 variants: dict) -> dict:
    """Phase 8: the 21 probes of ``llcomp_tpu_torch.probes`` (the TPU
    probes of ``tools/``) on the card.  Their path: every probe through
    ``probes.run_probe``, as its module's command line runs it, at the TPU
    probes' shape (128 lanes, a 15,872-row plane), the stepped probes also
    at 1,024 lanes and pH also at T 32 and 512; each wrapper must launch.
    Then each probe's kernel against its plain version, exactly (outputs
    and planes of random words; at 1,024 lanes too for the stepped ones),
    on inputs where the plain output differs across lanes or a plane
    changes; pH beside its copies ``variants`` (``ph_copies``); p7-p10 and
    pF beside theirs (``step_copies``), the decision loops' and the step
    loops' SASS (``decision_sass``, ``step_sass``; p11's too) and chain
    floors; p11 and pG and their copies exact on ``p11_cases`` and
    ``pG_cases`` (``few_copies``, ``gate_copies``); the reduce probe and its copies
    exact on ``reduce_cases`` (``reduce_copies``); the one-shot probes'
    device time, each beside the launch floor and its library call in
    turns in a profiler session of its own (``turns``:
    ``one_shot_turns``; the reduce probe's and pG's copies in their
    sessions, p11 with its copies at each of ``PROBE_LANES``), and
    the floor's share of it; the one PyTorch
    call that computes the same function where there is one; and
    bounds."""
    from llcomp_tpu_torch import probes
    from llcomp_tpu_torch.kernels import build
    from llcomp_tpu_torch.probes import mosaic, mosaic2, mosaic3, reduce

    dev = torch.device("cuda")
    mods = (mosaic, mosaic2, mosaic3, reduce)
    allp = {k: p for m in mods for k, p in m.PROBES.items()}
    source = {k: m.SRC for m in mods for k in m.PROBES}
    for p in allp.values():
        p.fn.launches = 0
    runs = {}
    for key, p in allp.items():
        shapes = [(128, p.T)]
        if p.T:
            steps = PH_STEPS if key in ("pHw", "pHn") else (p.T,)
            shapes = [(lanes, T) for lanes in PROBE_LANES for T in steps]
        for lanes, T in shapes:
            runs[key, lanes, T] = probes.run_probe(p, dev, lanes=lanes, T=T,
                                                   check=False)
    counts = {row: allp[keys[0]].fn.launches
              for row, (keys, _) in PROBE_ROWS.items()}
    check(all(counts.values()), f"phase 8: a probe never launched: {counts}")
    log(f"phase 8 probes: {len(allp)} probes and variants through "
        f"probes.run_probe, launches on this path {counts}")
    log(f"phase 8 one-shot probes, 128 lanes, ms a launch (CUDA events, "
        f"{probes.LAUNCHES} launches back to back through the wrapper, "
        f"host-bound, median of 3 fresh inputs) on {card}: " + ", ".join(
            f"{k} {runs[k, 128, 0]['ms']:.5f}" for k, p in allp.items()
            if not p.T))
    log(f"phase 8 stepped probes, ns a symbol step (CUDA events, one launch, "
        f"median of 3 fresh inputs and zeroed planes) at "
        f"{' | '.join(map(str, PROBE_LANES))} lanes on {card}: " + "; ".join(
            f"{k} T {T}: " + " | ".join(
                f"{runs[k, n, T]['ns_step']:.1f}" for n in PROBE_LANES)
            for k, p in allp.items() if p.T
            for T in (PH_STEPS if k in ("pHw", "pHn") else (p.T,))))

    errs, plain_ms = {}, {}
    for key, p in allp.items():
        for lanes in PROBE_LANES if p.T else (128,):
            r = probes.run_probe(p, dev, lanes=lanes, reps=0)
            check(r["telling"], f"probe {key}, {lanes} lanes: the plain "
                  "output is the same in every lane and no plane changed")
            check(r["err"] == 0, f"probe {key}, {lanes} lanes: kernel != "
                  f"plain ({r['err']})")
            errs[key] = max(errs.get(key, 0), r["err"])
            plain_ms.setdefault(key, r["plain_ms"])
    log(f"phase 8 probes vs plain: all {len(allp)} exact at 128 lanes (the "
        f"stepped ones also at 1,024), outputs and planes of random words, "
        f"each output differing across lanes or a plane changed; plain ms "
        f"at 128 lanes: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in plain_ms.items()))

    ph = ph_copies(torch, variants)
    log(f"phase 8 pH ns a step beside its copies (one block, the cluster "
        f"sizes {PH_CLUSTERS}; each exact against pH_stage_plain, outputs "
        f"and planes of random words; the shipped kernel timed before and "
        f"after them) on {card}: " + "; ".join(
            f"{key} {lanes} lanes T {T}: " + ", ".join(
                f"{tag} " + (", ".join(f"{v:.1f}" for v in ns)
                             if isinstance(ns, list) else ns)
                for tag, ns in row.items())
            for (key, lanes, T), row in ph.items()))

    pp = step_copies(torch, variants)
    clock, clock_max = pp["clock_mhz"]
    log(f"phase 8 p7-p10 and pF beside their copies ({PROBE_TAGS}), every "
        f"copy exact against one plain output a case, outputs and planes, on "
        f"{pp['cases']} cases (p7 and p8: the 7110 lanes, planes of 2, 3 and "
        f"17 rows, T around each ring depth, p7's {ROW_DEPTHS} and p8's "
        f"{STAGE_DEPTHS}; pF: the 7107 lanes, planes of 4, 6 and 36 rows, T "
        f"around each ring depth {PAIR_DEPTHS}; p9 and p10: idx bytes "
        f"0xFF, 0x00 and past 255; all at {PROBE_LANES} lanes and the "
        f"probe's T, planes "
        f"of random words); ns a step in turns, {PROBE_ROUNDS} rounds, the "
        f"order reversed every other round, median (quartiles; least-most) "
        f"and the rounds in which a copy ran under the shipped kernel, on "
        f"{card}, SM clock after them {clock:g} MHz (max {clock_max:g}): "
        + "; ".join(f"{key} {lanes} lanes: " + ", ".join(
            "{} {:.1f} ({:.1f}-{:.1f}; {:.1f}-{:.1f})".format(
                tag, statistics.median(ns),
                *statistics.quantiles(ns)[::2], min(ns), max(ns))
            + ("" if tag == "shipped" else ", under it in " + str(sum(
                a < b for a, b in zip(ns, row["shipped"]))))
            for tag, ns in row.items())
            for (key, lanes), row in pp["ns"].items()))
    dsass = decision_sass(variants)
    log("phase 8 SASS of p9's and p10's decision loops (cuobjdump -sass), "
        f"a decision (ALU pipe: {' '.join(ALU_OPCODES)}; FMA pipe: IMAD*): "
        + "; ".join(f"{key} {tag} {name}: {n:.2f} instructions ({alu:.2f} "
                    f"ALU, {fma:.2f} FMA), {c:.2f} dependent on the carried "
                    f"chain ({' '.join(ops)})"
                    for (key, tag), (name, n, c, ops, alu, fma)
                    in dsass.items()))
    ssass = step_sass(variants)
    log("phase 8 SASS of p8's, pF's and p11's step loops (cuobjdump -sass "
        f"of the sm_90a builds run on {card}), a step (steps a loop pass: the "
        "loop's stores over a step's, p11's loads over a step's): "
        + "; ".join(f"{key} {tag}: {n:.2f} instructions, {c:.2f} dependent "
                    f"on the carried chain ({steps:g} steps a pass)"
                    for (key, tag), (n, c, steps) in ssass.items()))
    # chain floors at each probe's T: p9's and p10's, their carried
    # chain's dependent instructions at ALU_LATENCY_CLOCKS each; p7's,
    # p9's measured step, and pF's, p10's (the least of the rounds at 128
    # lanes); p8's, the larger of its carried chain and one load latency
    # (the step of p11's serial copy at 128 lanes: a load a step, each
    # waiting for the one before) over its ring depth
    T = mosaic.PROBES["p9"].T
    chain_ms = {key: 24 * T * dsass[key, "shipped"][2] * ALU_LATENCY_CLOCKS
                / (clock * 1e3) for key in ("p9", "p10")}
    chain_ms["p7"] = min(pp["ns"]["p9", 128]["shipped"]) * T / 1e6
    T_pF = mosaic2.PROBES["pF"].T
    chain_ms["pF"] = min(pp["ns"]["p10", 128]["shipped"]) * T_pF / 1e6
    depth = build.constant("probe_mosaic", "kStageDepth")
    p8_chain_ns = ssass["p8", "shipped"][1] * ALU_LATENCY_CLOCKS / clock * 1e3
    with running(mosaic.SRC, variants[mosaic.SRC, "p11 serial"]):
        serial_ns = probes.run_probe(allp["p11"], dev, check=False)["ns_step"]
    p8_load_ns = serial_ns / depth
    serial_dev = (turns["p11 128"]["p11 serial"] or float("nan")) * 1e6 / T
    chain_ms["p8"] = T * max(p8_chain_ns, p8_load_ns) / 1e6
    log(f"phase 8 chain floors: " + "; ".join(
        f"{key} 24 x T {T} x {dsass[key, 'shipped'][2]:.2f} dependent "
        f"instructions x {ALU_LATENCY_CLOCKS} clocks at {clock:g} MHz = "
        f"{chain_ms[key]:.5f} ms" for key in ("p9", "p10"))
        + f"; p7 p9's step at 128 lanes x T {T} = {chain_ms['p7']:.5f} ms"
        + f"; pF p10's step at 128 lanes x T {T_pF} = "
        f"{chain_ms['pF']:.5f} ms; p8 T {T} x the larger of its chain "
        f"({ssass['p8', 'shipped'][1]:.2f} dependent instructions x "
        f"{ALU_LATENCY_CLOCKS} clocks = {p8_chain_ns:.1f} ns) and the step "
        f"of p11's serial copy at 128 lanes ({serial_ns:.1f} ns, CUDA "
        f"events, median of 3; in its turns {serial_dev:.1f} ns of device "
        f"time) over its ring depth {depth} ({p8_load_ns:.1f} ns) = "
        f"{chain_ms['p8']:.5f} ms, on {card}")
    n_few, n_gate = few_copies(torch, variants), gate_copies(torch, variants)
    log(f"phase 8 p11 and its copies ({P11_TAGS}) exact against "
        f"p11_stage_few_plain, output and plane, on {n_few} cases "
        f"(p11_cases: nstage -1, 0, 1, 8, 9, 33 and past the lanes; T 0, "
        f"1, 31, 32, 33 and 512; planes of 2, 3 and 300 rows of random "
        f"words, idx over int32; at {P11_LANES} lanes; and the probe's "
        f"shape at {PROBE_LANES} lanes); pG and its copies ({PG_TAGS}) "
        f"exact against pG_scalar_gate_plain on {n_gate} cases (pG_cases: "
        f"n {tuple(PG_WORDS)}, x 0, 1 and 3 words past a 16-byte boundary; "
        f"maximum 100 and 101, in the last word, in the first, INT32_MAX "
        f"+ 1 and INT32_MIN - 1); the entry point refuses out on a 16-byte "
        f"boundary where x is not")
    n_reduce = reduce_copies(torch, variants)
    log(f"phase 8 reduce and its copies ({REDUCE_TAGS}) exact against "
        f"run_plain on {n_reduce} cases (reduce_cases: rows and lanes "
        f"{REDUCE_SHAPES}, words all odd, all even, one odd word a slice, "
        f"sparse, over int32, 0-3)")

    floors = {k: t["empty"] for k, t in turns.items()}
    floors["p11"] = floors["p11 128"]
    # the bounds' floor is the least empty launch
    floor_ms = min((f for f in floors.values() if f is not None),
                   default=None)
    library, library_ev, device, bounds = {}, {}, {}, {}
    for key, p in allp.items():
        a = p.make(0, 128, probes.ROWS, dev)
        if p.T:
            a["T"] = p.T
        call = _library_call(torch, key, a)
        if not p.T or key == "p11":  # the kernel's own time, not the host's
            device[key] = turns[f"{key} 128" if p.T else key][key]
        if call is not None:
            check(torch.equal(call(), p.fn(**p.make(0, 128, probes.ROWS,
                                                      dev))),
                  f"probe {key}: the library call != the kernel")
            library_ev[key] = _time_cuda(torch, call, calls=probes.LAUNCHES)
            library[key] = turns[key].get("library")
        bounds[key] = _probe_bound(key, a, floor_ms)
    log("phase 8 library calls, ms a call (CUDA events, "
        f"{probes.LAUNCHES} calls back to back, median of 3; host-bound), "
        "equal to the kernels: " + ", ".join(
            f"{k} {v:.5f}" for k, v in library_ev.items()))
    log(f"phase 8 device ms a call (torch.profiler, {probes.LAUNCHES} turns "
        "with the empty launch in one session a probe) of the one-shot "
        "probes' kernels | the library calls: " + ", ".join(
            f"{k} " + " | ".join(f"{v:.5f}" if v is not None
                                 else "not measured" for v in pair)
            for k, pair in ((k, (device[k], library.get(k)))
                            for k in device)))

    def us(ms):
        return f"{ms * 1e3:.3f}" if ms is not None else "not measured"

    shares = {k: floors[k] / v for k, v in device.items()
              if v and floors[k] is not None}
    log(f"phase 8 reduce in turns with its copies and the empty launch "
        f"(torch.profiler, {probes.LAUNCHES} turns, one session), device us "
        f"a call: " + ", ".join(f"{tag} {us(turns['reduce'].get(tag))}"
                                for tag in ("empty", "reduce", *REDUCE_TAGS)))
    log(f"phase 8 pG in turns with its copies and the empty launch "
        f"(torch.profiler, {probes.LAUNCHES} turns, one session), device us "
        f"a call, at (8, 128) on {card}: " + ", ".join(
            f"{tag} {us(turns['pG'].get(tag))}"
            for tag in ("empty", "pG", *PG_TAGS)))
    def floor_share(t: dict, key: str) -> str:
        return (f"{t['empty'] / t[key]:.1%}" if t["empty"] and t.get(key)
                else "not measured")

    log(f"phase 8 p11 in turns with its copies and the empty launch "
        f"(torch.profiler, {probes.LAUNCHES} turns, one session a lane "
        f"count), device us a call, T {allp['p11'].T}, nstage 8, on {card}: "
        + "; ".join(f"{lanes} lanes: " + ", ".join(
            f"{tag} {us(t.get(tag))}" for tag in ("empty", "p11", *P11_TAGS))
            + f", the floor's share of p11 {floor_share(t, 'p11')}"
            for lanes, t in ((n, turns[f"p11 {n}"]) for n in PROBE_LANES)))
    log(f"phase 8 device us a call (torch.profiler, {probes.LAUNCHES} turns "
        f"in one session a probe): the launch floor (an empty kernel, one "
        f"warp) in each session and its share of the probe's time: "
        + ", ".join(f"{k} {us(floors[k])} ({shares[k]:.1%} of "
                    f"{us(device[k])})" for k in shares)
        + "; row store " + ", ".join(
            f"{k} {us(device[k])} (scatter_ {us(library[k])})"
            for k in ("p3", "pC")))
    log("phase 8 bounds at 128 lanes (a one-shot probe's at least the "
        "launch floor): " + ", ".join(
            f"{k} {b['bound_ms'] * 1e3:.5g} us by {b['bound_by']} "
            f"({b['bytes']} B, {b['ops']} ops: {b['work_ms'] * 1e3:.5g} us "
            f"by {b['work_by']})" for k, b in bounds.items()))

    # ms: a stepped probe's one launch (CUDA events); a one-shot probe's
    # and its library call's device time, where the profiler saw it, else
    # their host-bound event time (ms_from says which).  bound_ms and
    # bound_by: the bytes and operations alone; a one-shot probe's bound
    # with the launch floor in launch_bound_ms and launch_bound_by
    rows = []
    for row, (keys, replaces) in PROBE_ROWS.items():
        k = keys[0]
        ev_ms = runs[k, 128, allp[k].T]["ms"]
        on_device = device.get(k) is not None and (
            k not in library_ev or library[k] is not None)
        b = bounds[k]
        rows.append({
            "name": row, "route": "cuda",
            "source": f"llcomp_tpu_torch/csrc/{source[k]}.cu",
            "replaces": replaces, "launches": counts[row],
            "max_abs_err": max(errs[key] for key in keys),
            "ms": device[k] if on_device else ev_ms, "plain_ms": plain_ms[k],
            "bound_ms": b["work_ms"], "bound_by": b["work_by"],
            "library_ms": (library if on_device else library_ev).get(k),
            "ms_from": ("torch.profiler, device" if on_device else
                        "CUDA events" + ("" if allp[k].T else
                                         ", through the wrapper")),
            **({} if k not in device else {
                "wrapper_ms": ev_ms, "launch_floor_ms": floor_ms,
                "launch_bound_ms": b["bound_ms"],
                "launch_bound_by": b["bound_by"],
                "launch_floor_share": shares.get(k)}),
            **({"chain_floor_ms": chain_ms[row], "copies_ns_step": {
                f"{row} {lanes} T {allp[k].T}": {
                    tag: min(v) for tag, v in pp["ns"][row, lanes].items()}
                for lanes in PROBE_LANES}} if row in chain_ms else {}),
            **({"copies_ns_step": {
                f"{key} {lanes} T {T}": {
                    tag: min(v) if isinstance(v, list) else v
                    for tag, v in r.items()}
                for (key, lanes, T), r in ph.items()}}
               if row == "pH" else {}),
            **({"sass_a_decision": {
                tag: {"instructions": n, "chain": c, "alu": alu, "fma": fma}
                for (key, tag), (_, n, c, _, alu, fma) in dsass.items()
                if key == row}} if row in ("p9", "p10") else {}),
            **({"sass_a_step": {
                tag: {"instructions": n, "chain": c}
                for (key, tag), (n, c, _) in ssass.items() if key == row}}
               if row in STEP_LOOPS else {}),
            **({"copies_ms": {tag: turns[k].get(tag) for tag in REDUCE_TAGS}}
               if row == "reduce" else {}),
            **({"copies_ms": {tag: turns[k].get(tag) for tag in PG_TAGS}}
               if row == "pG" else {}),
            **({"replaced": {"design": REPLACED[row][1],
                             "ms": turns[f"{k} 128" if allp[k].T else k].get(
                                 REPLACED[row][0])}}
               if row in REPLACED else {}),
            **({"ns_step": {lanes: runs[k, lanes, allp[k].T]["ns_step"]
                            for lanes in PROBE_LANES},
                "turns_ms": {f"{lanes} lanes": turns[f"p11 {lanes}"]
                             for lanes in PROBE_LANES}}
               if row == "p11" else {})})
    return {"rows": rows, "runs": runs}


PHASE10_LIMIT_S = 120   # phase 10 fails past this many seconds
POD_RANKS = 2           # gloo ranks of phase 10's pod, each on cuda:0
SHARD_REPS = 5          # fresh bench batches phase 10 times each list on
# phase 10's explicit slice counts: photo512 and photo2048 in 8-row stripes,
# the tiled image in 32 full-width stripes
EXPLICIT_SLICES = {"photo512": 64, "photo2048": 256, "tiled8192": 32}
STAGE_LABELS = ("encode/upload", "encode/precompute", "encode/fused_kernel",
                "encode/download", "decode/upload", "decode/kernel",
                "decode/download")
KERNEL_NAMES = {"encode_fused": "encode_fused_kernel",
                "decode_kernel": "decode_kernel"}


def _meshes(torch) -> dict:
    """Phase 10's device lists: one card, the card twice, every card."""
    meshes = {"[cuda:0]": ["cuda:0"], "[cuda:0, cuda:0]": ["cuda:0"] * 2}
    if torch.cuda.device_count() > 1:
        meshes[f"all {torch.cuda.device_count()}"] = [
            f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return meshes


def multi_containers(torch, log, meshes: dict) -> None:
    """Phase 10, parallel: photo512, photo2048 and the tiled image through
    ``compress_sharded``/``decompress_sharded`` on every list, explicit
    slices equal to the native backend's, 'auto' exact with the mesh's
    slice height (the tiled one its phase 9 golden); a flipped slice fails
    its crc, a corrupt stream is named by its global lane."""
    from llcomp_tpu_torch import api, container, parallel

    tiled, th, tw, tseed = TILED
    imgs = {"photo512": make_image(512, 512, 3, 1512),
            "photo2048": make_image(2048, 2048, 3, 3048),
            tiled: make_image(th, tw, 3, tseed)}
    native = {name: api.compress(img, slices=EXPLICIT_SLICES[name],
                                 backend="native")
              for name, img in imgs.items()}
    secs = {}
    for mname, mesh in meshes.items():
        t0 = time.perf_counter()
        for name, img in imgs.items():
            blob = parallel.compress_sharded(img, mesh,
                                             slices=EXPLICIT_SLICES[name])
            check(blob == native[name], f"{name} on {mname}: slices="
                  f"{EXPLICIT_SLICES[name]} != the native backend's")
            check(np.array_equal(parallel.decompress_sharded(blob, mesh),
                                 img), f"{name} on {mname}: not exact")
            blob = parallel.compress_sharded(img, mesh)
            streams, W, H, C, slice_h = container.unpack_sliced(blob)[:5]
            if name == tiled:
                check(sha(blob) == GOLDEN_SHA[tiled],
                      f"{name} on {mname}: 'auto' != its golden")
            else:
                want = api.pick_slice_height(H, W, C,
                                             target_lanes=8 * len(mesh))
                check(slice_h == want, f"{name} on {mname}: slice height "
                      f"{slice_h}, want {want}")
            check(np.array_equal(parallel.decompress_sharded(blob, mesh),
                                 img), f"{name} on {mname}: 'auto' not exact")
        k = len(streams) // 2 + 1
        try:
            parallel.decompress_sharded(_flip_slice(blob, streams, k), mesh)
            check(False, f"{mname}: a flipped slice decoded")
        except ValueError as e:
            check(f"slices [{k}]" in str(e), f"{mname}: {e}")
        secs[mname] = time.perf_counter() - t0
    log("phase 10 parallel containers: photo512, photo2048 and "
        f"{tiled} on " + ", ".join(
            f"{m} in {v:.1f} s" for m, v in secs.items())
        + f"; slices={EXPLICIT_SLICES} == backend='native', 'auto' exact "
        "at 8 stripes a device (the tiled image its golden), a flipped "
        "slice refused by its crc")


def multi_bench(torch, log, card: str, meshes: dict, bench: dict) -> dict:
    """Phase 10, the bench batch over each list: phase 5's golden, exact,
    one launch of kernels 1 and 2 a CUDA shard; a corrupt stream named by
    its global lane; end to end on ``SHARD_REPS`` fresh batches, the lists
    and one ``encode_lanes``/``decode_lanes`` call in turns; and kernel 1
    on the whole batch against its two halves on two side streams."""
    from llcomp_tpu_torch import decode, encode, parallel
    from llcomp_tpu_torch import device as devmod
    from llcomp_tpu_torch.core.config import REV2
    from llcomp_tpu_torch.kernels import decode_kernel as dk
    from llcomp_tpu_torch.kernels import encode_fused as ef

    tab = bench["seed"]
    lanes = bench_lanes(bench_images(100))
    S, H, W, C = lanes.shape
    mp = BENCH_IMAGES * BENCH_SIZE * BENCH_SIZE / 1e6
    launches = {}
    for mname, mesh in meshes.items():
        ef.encode_fused.launches = dk.decode.launches = 0
        streams = parallel.encode_lanes_sharded(lanes, mesh, seed=tab)
        out = parallel.decode_lanes_sharded(streams, (H, W, C), mesh,
                                            seed=tab)
        launches[mname] = {"encode_fused": ef.encode_fused.launches,
                           "decode_kernel": dk.decode.launches}
        check(sha(b"".join(streams)) == GOLDEN_SHA["batch"],
              f"bench batch on {mname}: streams != golden")
        check(np.array_equal(out, lanes), f"bench batch on {mname}: "
              "round trip not exact")
        check(launches[mname] == dict.fromkeys(launches[mname], len(mesh)),
              f"bench batch on {mname}: launches {launches[mname]}, want "
              "one a shard")
        plain = parallel.encode_lanes_sharded(lanes[:64], mesh)
        plain[45] = _malicious_stream()
        try:
            parallel.decode_lanes_sharded(plain, (H, W, C), mesh)
            check(False, f"{mname}: a corrupt stream decoded")
        except ValueError as e:
            check("lanes [45]" in str(e), f"{mname}: {e}")

    calls = {"one call": (
        lambda b: encode.encode_lanes(b, seed=tab),
        lambda st: decode.decode_lanes(st, (H, W, C), seed=tab))}
    for mname, mesh in meshes.items():
        calls[mname] = (
            lambda b, m=mesh: parallel.encode_lanes_sharded(b, m, seed=tab),
            lambda st, m=mesh: parallel.decode_lanes_sharded(
                st, (H, W, C), m, seed=tab))
    enc = {k: [] for k in calls}
    dec = {k: [] for k in calls}
    for rep in range(SHARD_REPS):
        fresh = bench_lanes(bench_images(5000 + 97 * rep))
        order = list(calls) if rep % 2 == 0 else list(calls)[::-1]
        for name in order:
            encode_fn, decode_fn = calls[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = encode_fn(fresh)
            t1 = time.perf_counter()
            back = decode_fn(st)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(np.array_equal(back, fresh),
                  f"fresh batch {rep} on {name}: not exact")
            enc[name].append(t1 - t0)
            dec[name].append(t2 - t1)
    enc_s = {k: statistics.median(v) for k, v in enc.items()}
    dec_s = {k: statistics.median(v) for k, v in dec.items()}

    # kernel 1 alone: one launch of the batch against its halves on two
    # side streams of one card, in turns (host clock around a sync)
    dev = torch.device("cuda", 0)
    xs = encode._fused_input(torch.from_numpy(lanes).to(dev), REV2)
    cap = encode.outcap(xs.shape[0])
    halves = [xs[:, : S // 2].contiguous(), xs[:, S // 2 :].contiguous()]
    side = devmod.side_streams(dev, 2)

    def one():
        ef.encode_fused_async(xs, tab, cap)

    def two():
        for s, h in zip(side, halves):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                ef.encode_fused_async(h, tab, cap)
        for s in side:
            torch.cuda.current_stream(dev).wait_stream(s)

    k1 = {"one launch": [], "two halves": []}
    for rep in range(6):
        for name in (("one launch", "two halves") if rep % 2 == 0
                     else ("two halves", "one launch")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (one if name == "one launch" else two)()
            torch.cuda.synchronize()
            k1[name].append((time.perf_counter() - t0) * 1e3)
    k1_ms = {k: statistics.median(v[1:]) for k, v in k1.items()}  # warm
    twice = "[cuda:0, cuda:0]"
    log(f"phase 10 bench batch ({S} lanes x {H * W * C} symbols, seeded) on "
        + ", ".join(meshes) + ": golden ok, exact, launches "
        f"{launches}; a corrupt stream named by its global lane (45) on each")
    log(f"phase 10 end to end on {card}, median of {SHARD_REPS} fresh "
        "batches in turns (host numpy in, bytes/pixels out; each batch's ms "
        "in brackets): " + "; ".join(
            f"{k} encode {enc_s[k] * 1e3:.2f} ms = {mp / enc_s[k]:.2f} MP/s "
            f"({', '.join(f'{t * 1e3:.1f}' for t in enc[k])}), decode "
            f"{dec_s[k] * 1e3:.2f} ms = {mp / dec_s[k]:.2f} MP/s "
            f"({', '.join(f'{t * 1e3:.1f}' for t in dec[k])})"
            for k in calls)
        + f"; two shards on one card over one: encode "
        f"{enc_s[twice] / enc_s['[cuda:0]']:.3f}x, decode "
        f"{dec_s[twice] / dec_s['[cuda:0]']:.3f}x the time; phase 5's "
        f"encode_lanes in this run {bench['encode_s'] * 1e3:.2f} ms, "
        f"decode_lanes {bench['decode_s'] * 1e3:.2f} ms")
    log(f"phase 10 kernel 1 alone ({S} lanes, host clock around a sync, "
        f"median of 5 in turns): one launch {k1_ms['one launch']:.3f} ms, "
        f"two launches of {S // 2} lanes on two side streams "
        f"{k1_ms['two halves']:.3f} ms, ratio "
        f"{k1_ms['two halves'] / k1_ms['one launch']:.3f} (1 if they "
        "overlap, 2 if they run in turn)")
    return {"launches": launches, "encode_s": enc_s, "decode_s": dec_s,
            "k1_ms": k1_ms}


def multi_distributed(torch, log) -> dict:
    """Phase 10, distributed: ``POD_RANKS`` gloo ranks, each on cuda:0,
    compress photo512 with ``compress_image_pod`` (equal on every rank, to
    the call in this process and to the native backend's container of the
    same stripes and flags) and run ``compress_corpus_distributed`` on 4
    images; one NCCL rank of a world of 1 gathers CUDA streams exactly."""
    import tempfile

    from llcomp_tpu_torch import api, corpus, distributed

    # by path: ``import tests...`` can find another package named tests
    path = pathlib.Path(__file__).resolve().parent / "tests" / (
        "test_torch_distributed.py")
    spec = importlib.util.spec_from_file_location("torch_distributed_ranks",
                                                  path)
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    spawn = ranks.spawn

    img = make_image(512, 512, 3, 1512)
    imgs = [make_image(64 + 32 * i, 96, 3, 700 + i) for i in range(4)]
    t0 = time.perf_counter()
    alone = distributed.compress_image_pod(img, slice_h=8)
    alone_s = time.perf_counter() - t0
    native = api.compress(img, slices=512 // 8, seeded=False,
                          backend="native")
    check(alone == native, "compress_image_pod in one process != the "
          "native backend's container")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            res = spawn(POD_RANKS, img, pathlib.Path(tmp) / "pod",
                        device="cuda:0", corpus=imgs, timeout=120)
            spawn_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gather = spawn(1, img, pathlib.Path(tmp) / "nccl",
                           backend="nccl", device="cuda:0", mode="gather",
                           timeout=120)
            nccl_s = time.perf_counter() - t0
        except RuntimeError as e:
            raise Failed(f"phase 10 distributed: {e}") from e
    pods = {bytes.fromhex(r["pod"]) for r in res}
    check(pods == {alone}, f"pod: {len(pods)} distinct containers over "
          f"{POD_RANKS} ranks, or != the single-process call")
    got = [bytes.fromhex(b) for r in res for b in r["blobs"]]
    for r in res:
        lo, hi = r["span"]
        want, _ = corpus.compress_corpus(imgs[lo:hi], slice_h=8,
                                         backend="native")
        check(got[lo:hi] == want, f"rank {r['rank']}'s corpus blobs != the "
              "native backend's")
    check(gather[0]["equal"] and gather[0]["world"] == 1,
          f"NCCL world-1 gather: {gather[0]}")
    pod_s = [r["pod_s"] for r in res]
    log(f"phase 10 distributed: {POD_RANKS} gloo ranks on cuda:0, photo512 "
        f"in 8-row stripes: every rank's container == the single-process "
        f"call == backend='native'; compress_image_pod "
        + ", ".join(f"{s:.3f}" for s in pod_s) + f" s on the ranks, "
        f"{alone_s:.3f} s alone; compress_corpus_distributed of 4 images, "
        f"spans {[r['span'] for r in res]}, == native; ranks' wall "
        f"{spawn_s:.1f} s; NCCL world of 1: _allgather_streams of CUDA "
        f"blocks exact ({nccl_s:.1f} s)")
    return {"pod_s": pod_s, "alone_s": alone_s}


def multi_profiling(torch, log) -> dict:
    """Phase 10, profiling: one compress + decompress of photo512 under
    ``trace_to`` (the trace names the stage labels and kernels 1 and 2),
    then under LLCT_PROFILE=1 (the stage report)."""
    import os
    import tempfile

    from llcomp_tpu_torch import api, profiling

    img = make_image(512, 512, 3, 1512)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace_to(tmp) as path:
            out = api.decompress(api.compress(img, slices="auto"))
        events = json.loads(path.read_text())["traceEvents"]
        size = path.stat().st_size
    check(np.array_equal(out, img), "profiled round trip not exact")
    names = {e.get("name", "") for e in events}
    missing = [lb for lb in STAGE_LABELS if lb not in names]
    missing += [k for k in KERNEL_NAMES.values()
                if not any(k in n for n in names)]
    check(not missing, f"trace lacks {missing}")
    profiling.stages.totals.clear()
    profiling.stages.counts.clear()
    os.environ["LLCT_PROFILE"] = "1"
    try:
        t0 = time.perf_counter()
        blob = api.compress(img, slices="auto")
        t1 = time.perf_counter()
        api.decompress(blob)
        t2 = time.perf_counter()
    finally:
        del os.environ["LLCT_PROFILE"]
    report = profiling.stages.report()
    check(set(STAGE_LABELS) <= set(report), f"stage report {report}")
    log(f"phase 10 profiling: trace_to wrote {size} B, {len(events)} events "
        f"naming {len(STAGE_LABELS)} stage labels and kernels "
        f"{list(KERNEL_NAMES.values())}; LLCT_PROFILE=1 photo512 compress "
        f"{t1 - t0:.3f} s, decompress {t2 - t1:.3f} s (synced at every "
        f"stage: an attribution, not a throughput), stages: "
        + json.dumps(report))
    return report


def phase_multi(torch, log, card: str, bench: dict) -> dict:
    """Phase 10: the multi-device and multi-process surface; fails past
    ``PHASE10_LIMIT_S``."""
    from llcomp_tpu_torch import graft_entry

    meshes = _meshes(torch)
    t = {}
    t0 = time.perf_counter()
    multi_containers(torch, log, meshes)
    t["containers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = multi_bench(torch, log, card, meshes, bench)
    t["bench batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pod = multi_distributed(torch, log)
    t["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = multi_profiling(torch, log)
    t["profiling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    out, lens = fn(*args)
    fn_c, args_c = graft_entry.entry("cpu")
    out_c, lens_c = fn_c(*args_c)
    check(torch.equal(lens.cpu(), lens_c) and all(
        torch.equal(out[s, : lens_c[s]].cpu(), out_c[s, : lens_c[s]])
        for s in range(len(lens_c))), "entry('cuda') != entry('cpu')")
    graft_entry.dryrun_multichip(2, mesh=["cuda:0", "cuda:0"])
    t["graft entry"] = time.perf_counter() - t0
    total = sum(t.values())
    log("phase 10 graft entry: entry('cuda') == entry('cpu'), "
        "dryrun_multichip(2, [cuda:0, cuda:0]) passed")
    log("phase 10 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items())
        + f"; total {total:.1f} of the {PHASE10_LIMIT_S} s limit")
    check(total < PHASE10_LIMIT_S,
          f"phase 10 took {total:.1f} s, over its {PHASE10_LIMIT_S} s limit")
    return {**shards, **pod, "stages": stages, "seconds": t}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    def log(msg: str) -> None:
        print(msg, flush=True)

    try:
        # phase 1: device
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(f"phase 1 device: torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
        print(card, flush=True)

        # phase 2: build
        from llcomp_tpu_torch.kernels import build

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(KERNEL_SOURCES) + len(VARIANTS)) as pool:
            variants = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
            list(pool.map(build.build, KERNEL_SOURCES))
        log(f"phase 2 build: {len(KERNEL_SOURCES)} kernel sources from "
            f"llcomp_tpu_torch/csrc and {len(VARIANTS)} copies of kernels "
            f"1-8 and probes p7-p11, pF, pG, pH and reduce, one nvcc each in "
            f"parallel, in "
            f"{time.perf_counter() - t0:.2f} s")
        regs = {name: registers(build.compiler_log(name))
                for name in PTXAS_SOURCES}
        copied = {f"{name} {tag} {k}": v
                  for (name, tag), (_, rep) in variants.items()
                  if name in COPIED_KERNEL
                  for k, v in registers(rep).items()
                  if k.startswith(COPIED_KERNEL[name])}
        spills = {f"{name} {k}": v for name, r in regs.items()
                  for k, v in r.items() if v[1]}
        spills.update({k: v for k, v in copied.items() if v[1]})
        check(not spills, f"ptxas reports spills: {spills}")
        log("phase 2 ptxas -v (sm_90a), registers a thread, no spills: "
            + "; ".join(f"{name} " + ", ".join(f"{k} {v[0]}"
                                               for k, v in r.items())
                        for name, r in regs.items())
            + "; copies: " + ", ".join(f"{k} {v[0]}"
                                       for k, v in copied.items()))
        variants = {k: so for k, (so, _) in variants.items()}

        took = {}

        def timed(phase, fn, *args):
            t0 = time.perf_counter()
            r = fn(*args)
            took[phase] = round(time.perf_counter() - t0, 1)
            return r

        turns = timed("8, one-shot turns", one_shot_turns, torch, variants)
        errs = timed(3, phase_kernels_vs_plain, torch, log)
        counts = timed(4, phase_main_path, torch, log)
        surface = timed(9, phase_surface, torch, log)
        bench = timed(5, phase_bench, torch, log, card, variants)
        multi = timed(10, phase_multi, torch, log, card, bench)
        sort = timed(6, phase_sort, torch, log, card, variants)
        decision = timed(7, phase_decision, torch, log, card, variants)
        probe = timed(8, phase_probes, torch, log, card, turns, variants)
        log("phase seconds: " + ", ".join(f"{k} {v}" for k, v in
                                           took.items()))
        if "jax" in sys.modules or "llcomp_tpu" in sys.modules:
            raise Failed("the port imported JAX or llcomp_tpu")
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: phases 1-10 passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    def bound_of(b: dict) -> dict:
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None}

    note = f"plain_ms and ms_subset on {bench['subset']}"
    kernels = [
        {"name": "encode_fused", "route": "cuda",
         "source": "llcomp_tpu_torch/csrc/encode_fused.cu",
         "replaces": "llcomp_tpu/pallas/encode_fused.py:150",
         "launches": counts["encode_fused"], "max_abs_err": errs["encode"],
         "ms": bench["encode_ms"], "plain_ms": bench["encode_plain_ms"],
         "us_symbol": bench["encode_ms"] * 1e3 / bench["n_sym"],
         **bound_of(bench["bounds"]["encode_fused"]),
         "ms_subset": bench["encode_sub_ms"], "note": note,
         "launches_phase9": {
             "reencode_slice": surface["reencode"],
             "corpus": surface["corpus"]["counts"]["encode_fused"]},
         "launches_phase10": {m: c["encode_fused"]
                              for m, c in multi["launches"].items()}},
        {"name": "decode_kernel", "route": "cuda",
         "source": "llcomp_tpu_torch/csrc/decode_kernel.cu",
         "replaces": "llcomp_tpu/pallas/decode_kernel.py:444",
         "launches": counts["decode_kernel"], "max_abs_err": errs["decode"],
         "ms": bench["decode_ms"], "plain_ms": bench["decode_plain_ms"],
         "us_symbol": bench["decode_ms"] * 1e3 / bench["n_sym"],
         **bound_of(bench["bounds"]["decode_kernel"]),
         "ms_subset": bench["decode_sub_ms"], "note": note,
         "launches_phase9": {
             "corpus": surface["corpus"]["counts"]["decode_kernel"]},
         "launches_phase10": {m: c["decode_kernel"]
                              for m, c in multi["launches"].items()}},
    ]
    for name, src, line, err in (("walk_symbols", "walk_symbols", 175, "walk"),
                                 ("coder_scan_off_q", "coder_scan", 574,
                                  "coder")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"llcomp_tpu_torch/csrc/{src}.cu",
            "replaces": f"llcomp_tpu/pallas/encode_kernels.py:{line}",
            "launches": sort["counts"][name],
            "max_abs_err": max(errs[err], sort[err]),
            "ms": sort[f"{err}_ms"], "plain_ms": sort[f"{err}_plain_ms"],
            **bound_of(sort["bounds"][name]),
            **({"copies_ms": sort["walk_copies"], "piece": sort["piece"],
                "thread_walk": sort["thread_walk"]}
               if name == "walk_symbols" else
               {"copies_ms": sort["coder_copies"]})})
    for name, src, line in (("build_stream", "build_stream", 74),
                            ("walk_probs", "walk_probs", 356),
                            ("coder_scan_off", "coder_scan", 475),
                            ("coder_scan", "coder_scan", 416)):
        r = decision[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"llcomp_tpu_torch/csrc/{src}.cu",
            "replaces": f"llcomp_tpu/pallas/encode_kernels.py:{line}",
            "launches": r["launches"],
            "max_abs_err": max(r["err"], errs.get(name, 0)),
            "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_of(r["bound"]),
            **({"copies_ms": r["copies"]} if "copies" in r else {}),
            **({k: r[k] for k in ("piece", "thread_walk")}
               if name == "walk_probs" else {})})
    kernels += probe["rows"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
