// Probes pA-pF of llcomp_tpu_torch.probes.mosaic2: the TPU's vector-to-
// scalar bridge, per-lane row access at a scalar offset, and the mock
// symbol step on a pair of rows, on the H100.
//
// Replaces the six Pallas kernels of tools/probe_mosaic2.py:
//   pA  pA_dma_bridge    :71  (pallas_call :87)
//   pB  pB_dyn_row_load  :103 (:120)
//   pC  pC_dyn_row_rmw   :136 (:154)
//   pD  pD_window_load   :171 (:188), windows of 8 and 16 rows
//   pE  pE_taa           :204 (:210), gathers from 16 and 32 rows
//   pF  pF_symbol_step   :222 (:280)
//
// What the TPU probes asked: whether a DMA from VMEM into SMEM gives the
// scalar core each lane's row index (pA), and whether row loads (pB),
// row read-modify-writes (pC) and windows (pD) at that index, and a gather
// from a tall block (pE), lower; pF timed a whole mock symbol step built
// from them: per-lane stage-in of a two-row model entry (rows r, r+1), 24
// unrolled decisions, stage-out.  On Hopper a thread holds its own index
// in a register, so there is no bridge: pA is an elementwise kernel, and
// the others are the loads and stores of probe_mosaic.cu at the same
// shapes (one thread a lane, the plane in device memory).
//
// What bounds them on the H100: latency.  pA-pE move a few KB in one
// launch.  pF is a serial chain a lane of T steps: the row pair (two
// sectors, 4*lanes bytes apart) of a step, its 24 dependent decisions and
// two stores.  The plane is 8.1 MB at 128 lanes (inside the 50 MB L2) and
// 65 MB at 1,024 (outside it).
//
// What pF's design does about it.  Its pair h depends on idx and the step
// alone, never on acc, as p7's row does (probe_mosaic.cu): so the pairs of
// the next kPairDepth steps are worked out ahead (StepRows), and the two
// words of step s + kPairDepth are loaded while step s decides, into a
// register ring indexed statically (the loop unrolled by kPairDepth).  A
// load issued before a store of the same pair reads the pair as it was,
// so after each step's two stores every pending slot of that pair takes
// the stored words from registers, into forward slots of its own (nothing
// waits on a load in flight before the step that consumes it).  h is even
// and a pair is (h, h+1), so two pairs overlap only where their h is
// equal: one compare a slot covers both words.  The decisions are p10's
// step, decide24_perm<true> (probe_common.cuh), acc carried unmasked
// across steps and masked once at the end.  With its loads off the chain,
// a step is held by instruction issue: p10's 24 decisions and the row,
// loads, stores and forwarding around them.
//
// The H100's answer (one H100 80GB HBM3 at 700 W, chip_smoke.py phase 8):
// pA-pE each run 0.8-1.8 us on the device a launch (pC, the row store of
// p3 in probe_mosaic.cu, 1.16 us against scatter_'s 1.55 us in turns in
// one profiler session).  pF's design before this one
// (tools/designs/probe_mosaic2_serial_step.cu: the pair loaded after the
// previous step's stores, the shift-and-select step decide) took
// 1,081-1,172 ns a step at 128 lanes and 1,363-1,437 ns at 1,024, the
// staging of p8 plus the unrolled decisions of p10's serial step.  This
// design, in 10 rounds of turns with it: medians 596.8 and 702.4 ns a step
// against 1,150.7 and 1,453.0, 448 SASS instructions a step with 86 on its
// carried chain (p10's 24 decisions take 392); ring depths 2 and 3 alike,
// 8 slower (its unrolled loop 8 x 475 instructions); p10's split step and
// 8 lanes a block a few per cent faster, inside the rounds' spread at one
// lane count.  chip_smoke.py phase 8 times pF in turns with these copies;
// PERF.md keeps the numbers.
#include "probe_common.cuh"

namespace {

using namespace probe;

// Steps of pF's row pairs in flight ahead of the step that decides (D).
constexpr int kPairDepth = 4;

// pF: T mock symbol steps on the row pair (h, h+1), h = 2 * ((x*(s+1) +
// s*40503) mod (rows/2 - 1)); decisions unrolled, as in the TPU probe.
// Slot k of the ring holds step s0 + k: its pair's h, the words loaded for
// it (lo, hi) and the words forwarded to it by a later store (flo, fhi,
// taken where fw).
__global__ void __launch_bounds__(kLaneBlock)
pair_steps(const int32_t* __restrict__ idx, int32_t* __restrict__ M,
           int32_t* __restrict__ out, int lanes, int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  int32_t* const col = M + l;              // row h of the pair
  int32_t* const col1 = col + lanes;       // row h + 1
  const uint32_t pitch = 4u * static_cast<uint32_t>(lanes);
  StepRows pairs(idx[l], rows / 2 - 1);
  int32_t h[kPairDepth];
  uint32_t lo[kPairDepth], hi[kPairDepth], flo[kPairDepth], fhi[kPairDepth];
  bool fw[kPairDepth];
#pragma unroll
  for (int k = 0; k < kPairDepth; ++k) {
    h[k] = 2 * pairs.next();
    lo[k] = hi[k] = flo[k] = fhi[k] = 0u;
    fw[k] = false;
    if (k < T) {
      lo[k] = static_cast<uint32_t>(*word_at(col, h[k], pitch));
      hi[k] = static_cast<uint32_t>(*word_at(col1, h[k], pitch));
    }
  }
  uint32_t t = 0, ctx = 0;
  for (int s0 = 0; s0 < T; s0 += kPairDepth) {
#pragma unroll
    for (int k = 0; k < kPairDepth; ++k) {
      if (s0 + k >= T) break;
      const int32_t r = h[k];
      uint32_t wlo = fw[k] ? flo[k] : lo[k];
      uint32_t whi = fw[k] ? fhi[k] : hi[k];
      h[k] = 2 * pairs.next();   // step s + D
      fw[k] = false;
      if (s0 + k + kPairDepth < T) {
        lo[k] = static_cast<uint32_t>(*word_at(col, h[k], pitch));
        hi[k] = static_cast<uint32_t>(*word_at(col1, h[k], pitch));
      }
      decide24_perm<true>(wlo, whi, ctx, t);
      *word_at(col, r, pitch) = static_cast<int32_t>(wlo);
      *word_at(col1, r, pitch) = static_cast<int32_t>(whi);
#pragma unroll
      for (int j = 0; j < kPairDepth; ++j) {
        const bool hit = h[j] == r;
        flo[j] = hit ? wlo : flo[j];
        fhi[j] = hit ? whi : fhi[j];
        fw[j] = fw[j] || hit;
      }
    }
  }
  out[l] = static_cast<int32_t>(t & 0x7FFFu);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Entry points: one a probe.  idx is [k, lanes] (row 0 read), planes
// [rows, lanes]; every pointer is int32.  Each returns cudaGetLastError().

extern "C" int llct_probe_pA(const void* idx, void* out, int lanes,
                             void* stream) {
  affine<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(out), lanes, 2, 1);
  return done();
}

extern "C" int llct_probe_pB(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 0);
  return done();
}

extern "C" int llct_probe_pC(const void* idx, const void* val, void* model,
                             void* out, int lanes, void* stream) {
  row_store<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(val), io(model), io(out), lanes);
  return done();
}

extern "C" int llct_probe_pD(const void* idx, const void* src, void* out,
                             int lanes, int rows, int win, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, win, 0);
  return done();
}

extern "C" int llct_probe_pE(const void* idx, const void* src, void* out,
                             int lanes, int rows, int height, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, height);
  return done();
}

extern "C" int llct_probe_pF(const void* idx, void* M, void* out, int lanes,
                             int rows, int T, void* stream) {
  pair_steps<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(M), io(out), lanes, rows, T);
  return done();
}
