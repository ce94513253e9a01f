// Kernel 6 of llcomp_tpu_torch: the decision variant's state walk, one
// thread per lane (one lane = one independent rev-2 stream).
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_walk_kernel (walk_probs,
// encode_kernels.py:356).  Input: each lane's decisions sorted by (context,
// position) (encode.stage_walk_xs), one int32 each, bit | seg<<1, lane-minor
// [T, S]; seg is set where a new context starts.  A context's decisions
// arrive together, so the lane's whole model is one 8-bit state: it resets
// to 0 at seg, gives the decision's coding probability (the state table's
// prob) and moves to the table's next state for the bit.  Output: the
// probability of every entry, [T, S] int32.  Padding entries (the sort's
// dead tail) are walked like the others; the back sort drops them.
//
// What bounds it on the H100: latency.  Each lane is one serial chain of a
// shared-memory lookup per decision; bytes moved are 4 B in and 4 B out per
// decision, coalesced, and 1,024 lanes put only 32 warps in flight.
//
// What the design does about it: the state is one register, the 128-entry
// table (prob | next0 << 8 | next1 << 16) sits in shared memory (the lanes
// of a warp read different entries, which constant memory would
// serialise), and the loads do not depend on the state, so the compiler may
// issue them ahead of the chain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;    // lanes (threads) per block

__global__ void __launch_bounds__(kBlock)
walk_probs_kernel(const int32_t* __restrict__ xs,      // [T, S]
                  const int32_t* __restrict__ fused,   // [128]
                  int32_t* __restrict__ probs,         // [T, S]
                  int T, int S) {
  __shared__ int32_t s_fused[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = fused[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t s = static_cast<size_t>(S);
  int32_t st = 0;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const int32_t x = xs[t * s + lane];
    if (x & 2) st = 0;                               // a new context
    const int32_t f = s_fused[st];
    probs[t * s + lane] = f & 0xFF;
    st = (f >> ((x & 1) ? 16 : 8)) & 0xFF;
  }
}

}  // namespace

extern "C" int llct_walk_probs(const void* xs, const void* fused, void* probs,
                               int T, int S, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  const int grid = (S + kBlock - 1) / kBlock;
  walk_probs_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(fused),
      static_cast<int32_t*>(probs), T, S);
  return static_cast<int>(cudaGetLastError());
}
