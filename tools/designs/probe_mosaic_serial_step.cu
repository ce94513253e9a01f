// The design that probes p7, p8, p9 and p10 (llcomp_tpu_torch/csrc/
// probe_mosaic.cu) replaced, kept whole as a copy that chip_smoke.py
// (VARIANTS, copy "serial step") builds and times beside the shipped
// kernels on the same inputs: p7 and p8 load their row after the previous
// step's store, and p9's and p10's decision is the shift-and-select step
// `decide` (probe_serial_decide.cuh in this directory; probe_common.cuh
// held it then).  Its note follows as it stood.
//
// Probes p0-p11 of llcomp_tpu_torch.probes.mosaic: per-lane access to a
// model plane, and the cost split of one symbol step, on the H100.
//
// Replaces the twelve Pallas kernels of tools/probe_mosaic.py:
//   p0  p0_scalar_store       :65  (pallas_call :74)
//   p1  p1_scalar_load        :85  (:99)
//   p2  p2_row_load_blend     :110 (:124)
//   p3  p3_row_rmw            :135 (:150)
//   p4  p4_window_load        :162 (:176)
//   p5  p5_sublane_gather32   :187 (:193)
//   p6  p6_smem_staging       :204 (:221)
//   p7  p7_symbol_step_cost   :233 (:292)
//   p8  p8_stage_only_cost    :308 (:337)
//   p9  p9_decision_only_cost :352 (:377)
//   p10 p10_decision_unrolled :388 (:409)
//   p11 p11_stage_few         :420 (:440)
//
// What the TPU probes asked: whether Mosaic lowers a per-lane scalar store
// (p0), load (p1) or row read-modify-write (p2, p3, p4) of a model plane
// held in VMEM, and what one symbol step costs when 128 lanes stage their
// model rows in and out one lane at a time (p7), split into staging alone
// (p8), decisions alone (p9, p10 unrolled) and staging of 8 lanes (p11).
// On Hopper every one of these primitives is an ordinary load or store of
// one thread, so the question left is its cost: one thread owns one lane
// and reads its row straight from the plane in device memory, with no
// staging loop over lanes, no SMEM bridge and no lane blends.
//
// What bounds them on the H100: latency, not bytes or operations.  p0-p6
// move a few KB; one launch costs what a launch costs.  p7, p8, p11 and
// the decision probes are serial chains a lane: one dependent load of the
// lane's model row a step (the row depends on the step), then p7's 24
// dependent decisions.  The plane is [rows, lanes] int32, 8.1 MB at 128
// lanes (inside the 50 MB L2) and 65 MB at 1,024 (outside it), and a
// warp's 32 lanes read 32 different rows, so each load is 32 sectors.
//
// The H100's answer (one H100 80GB HBM3 at 700 W, chip_smoke.py phase 8,
// two runs): p0-p6 each run 0.8-1.8 us on the device a launch, over an
// empty launch's 0.6-0.9 us; p3's row store, its loads issued before its
// stores (probe_common.cuh), 1.16 us against scatter_'s 1.55 us in turns
// in one profiler session (1.8 us when it loaded after its store).  A symbol
// step costs 400-461 ns of staging one word in and out (p8) at 128 lanes
// and 676-726 ns at 1,024 (the plane past L2), 783-858 ns of 24 decisions
// (p9) at either, 634-696 ns unrolled (p10), and 1,192-1,264 ns at 128
// lanes, 1,491-1,575 ns at 1,024 for both (p7): the sum, so the row's
// load latency is not hidden behind the decisions.  Reading 8 lanes (p11),
// with no store, still costs one load latency a step (171-287 ns).
#include "probe_common.cuh"
#include "probe_serial_decide.cuh"

namespace {

using namespace probe;

__global__ void __launch_bounds__(kLaneBlock)
scalar_store(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
             int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t r = fmod_floor(idx[l], 64);
  const size_t n = static_cast<size_t>(lanes);
  for (int i = 0; i < 64; ++i) out[i * n + l] = i == r ? r : 0;
}

// p7: T full symbol steps on two planes A (bytes 0-3 of a row) and B
// (bytes 4-7): stage the row in, 24 decisions (the loop kept, as the TPU
// probe's fori_loop), stage it out.
__global__ void __launch_bounds__(kLaneBlock)
symbol_steps(const int32_t* __restrict__ idx, int32_t* __restrict__ A,
             int32_t* __restrict__ B, int32_t* __restrict__ out, int lanes,
             int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t x = idx[l];
  const size_t n = static_cast<size_t>(lanes);
  int32_t acc = 0;
  for (int s = 0; s < T; ++s) {
    const size_t at = step_row(x, s, rows - 1) * n + l;
    uint32_t lo = static_cast<uint32_t>(A[at]);
    uint32_t hi = static_cast<uint32_t>(B[at]);
    decide24<false>(lo, hi, acc);
    A[at] = static_cast<int32_t>(lo);
    B[at] = static_cast<int32_t>(hi);
  }
  out[l] = acc;
}

// p8: T steps of staging alone: read the row, write (word + carry + 1) &
// 0xFFFF back, carry = (carry + word) & 0x7FFF.
__global__ void __launch_bounds__(kLaneBlock)
stage_only(const int32_t* __restrict__ idx, int32_t* __restrict__ A,
           int32_t* __restrict__ out, int lanes, int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t x = idx[l];
  const size_t n = static_cast<size_t>(lanes);
  int32_t carry = 0;
  for (int s = 0; s < T; ++s) {
    const size_t at = step_row(x, s, rows - 1) * n + l;
    const int32_t w = A[at];
    A[at] = wadd(wadd(w, carry), 1) & 0xFFFF;
    carry = wadd(carry, w) & 0x7FFF;
  }
  out[l] = carry;
}

// p9 (Unroll false) and p10 (true): T steps of 24 decisions alone, on a
// row that starts as idx[0, l] & 0xFF in all 8 bytes.
template <bool Unroll>
__global__ void __launch_bounds__(kLaneBlock)
decisions_only(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int lanes, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  uint32_t lo = (static_cast<uint32_t>(idx[l]) & 0xFFu) * 0x01010101u;
  uint32_t hi = lo;
  int32_t acc = 0;
#pragma unroll 1
  for (int s = 0; s < T; ++s) decide24<Unroll>(lo, hi, acc);
  out[l] = acc;
}

// p11: T steps in which only lanes below nstage read their row:
// carry = (carry + word) & 0x7FFF, the plane left as it is.
__global__ void __launch_bounds__(kLaneBlock)
stage_few(const int32_t* __restrict__ idx, const int32_t* __restrict__ A,
          int32_t* __restrict__ out, int lanes, int rows, int T, int nstage) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t x = idx[l];
  const size_t n = static_cast<size_t>(lanes);
  int32_t carry = 0;
  if (l < nstage) {
    for (int s = 0; s < T; ++s)
      carry = wadd(carry, A[step_row(x, s, rows - 1) * n + l]) & 0x7FFF;
  }
  out[l] = carry;
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Entry points: one a probe.  idx is [k, lanes] (row 0 read), planes
// [rows, lanes]; every pointer is int32.  Each returns cudaGetLastError().

extern "C" int llct_probe_p0(const void* idx, void* out, int lanes,
                             void* stream) {
  scalar_store<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(out), lanes);
  return done();
}

extern "C" int llct_probe_p1(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 0);
  return done();
}

extern "C" int llct_probe_p2(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 0);
  return done();
}

extern "C" int llct_probe_p3(const void* idx, const void* val, void* model,
                             void* out, int lanes, void* stream) {
  row_store<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(val), io(model), io(out), lanes);
  return done();
}

extern "C" int llct_probe_p4(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 8, 0);
  return done();
}

extern "C" int llct_probe_p5(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 32);
  return done();
}

extern "C" int llct_probe_p6(const void* idx, void* out, int lanes,
                             void* stream) {
  affine<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(out), lanes, 1, 1);
  return done();
}

extern "C" int llct_probe_p7(const void* idx, void* A, void* B, void* out,
                             int lanes, int rows, int T, void* stream) {
  symbol_steps<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(A), io(B), io(out), lanes, rows, T);
  return done();
}

extern "C" int llct_probe_p8(const void* idx, void* A, void* out, int lanes,
                             int rows, int T, void* stream) {
  stage_only<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(A), io(out), lanes, rows, T);
  return done();
}

extern "C" int llct_probe_p9(const void* idx, void* out, int lanes, int T,
                             void* stream) {
  decisions_only<false>
      <<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
          in(idx), io(out), lanes, T);
  return done();
}

extern "C" int llct_probe_p10(const void* idx, void* out, int lanes, int T,
                              void* stream) {
  decisions_only<true>
      <<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
          in(idx), io(out), lanes, T);
  return done();
}

extern "C" int llct_probe_p11(const void* idx, const void* A, void* out,
                              int lanes, int rows, int T, int nstage,
                              void* stream) {
  stage_few<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(A), io(out), lanes, rows, T, nstage);
  return done();
}
