// The design that probe pF (llcomp_tpu_torch/csrc/probe_mosaic2.cu,
// pair_steps) replaced, kept whole as a copy that chip_smoke.py (VARIANTS,
// copy "serial step") builds and times beside the shipped kernel on the
// same inputs: each step loads its row pair after the previous step's two
// stores and decides with the shift-and-select step `decide`
// (probe_serial_decide.cuh in this directory).  Its note follows as it
// stood.
//
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
// launch; pF is a serial chain a lane of two dependent row loads (r and
// r+1: two sectors, 4*lanes bytes apart), 24 dependent decisions and two
// stores a step.
//
// The H100's answer (one H100 80GB HBM3 at 700 W, chip_smoke.py phase 8,
// two runs): pA-pE each run 0.8-1.8 us on the device a launch (pC, the
// row store of p3 in probe_mosaic.cu, 1.16 us against scatter_'s 1.55 us
// in turns in one profiler session); pF takes
// 1,081-1,172 ns a step at 128 lanes and 1,363-1,437 ns at 1,024, the
// staging of p8 plus the unrolled decisions of the serial step's p10
// (decide24<true>, which p10 in probe_mosaic.cu took before
// decide24_perm<true>).
#include "probe_common.cuh"
#include "probe_serial_decide.cuh"

namespace {

using namespace probe;

// pF: T mock symbol steps on the row pair (h, h+1), h = 2 * ((x*(s+1) +
// s*40503) mod (rows/2 - 1)); decisions unrolled, as in the TPU probe.
__global__ void __launch_bounds__(kLaneBlock)
pair_steps(const int32_t* __restrict__ idx, int32_t* __restrict__ M,
           int32_t* __restrict__ out, int lanes, int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t x = idx[l];
  const size_t n = static_cast<size_t>(lanes);
  int32_t acc = 0;
  for (int s = 0; s < T; ++s) {
    const size_t at = 2 * step_row(x, s, rows / 2 - 1) * n + l;
    uint32_t lo = static_cast<uint32_t>(M[at]);
    uint32_t hi = static_cast<uint32_t>(M[at + n]);
    decide24<true>(lo, hi, acc);
    M[at] = static_cast<int32_t>(lo);
    M[at + n] = static_cast<int32_t>(hi);
  }
  out[l] = acc;
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
