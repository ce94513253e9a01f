// Kernel 6 of llcomp_tpu_torch: the decision variant's state walk, each lane
// (one independent rev-2 stream) cut at its context runs into kChunks pieces
// walked at once.
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_walk_kernel (walk_probs,
// encode_kernels.py:356).  Input: each lane's decisions sorted by (context,
// position) (encode.stage_walk_xs), one int32 each, bit | seg<<1, lane-minor
// [T, S]; seg is set where a new context starts.  A context's decisions
// arrive together, so the lane's whole model is one 8-bit state: it resets
// to 0 at seg, gives the decision's coding probability (the state table's
// prob) and moves to the table's next state for the bit.  Output: the
// probability of every entry, [T, S] int32.  Padding entries (the sort's
// dead tail, one context run) are walked like the others; the back sort
// drops them.
//
// What bounds it on the H100: the walk moves 4 B in and 4 B out an entry
// (505 MB at 1,024 lanes x 61,696 entries, 151 us at 3.35 TB/s), and its
// integer work is a few operations an entry; the bytes bound it.  Walked
// as one chain a lane, as the TPU kernel walks it (a lane group there is
// one vector register), it is bound by latency instead: 61,696 dependent
// steps a lane, ~135 ns each, and 1,024 lanes fill 32 of the 132 SMs with
// one warp each.  Cut as below it is bound by its longest thread walk (L
// plus the longest piece, 2,892 entries on the bench batch) at ~160-180 ns
// a step: each step waits on its input's line (128 B of a lane-minor row,
// 4 KB from the last) and stores one; the lookup costs next to nothing
// (tools/torch_walk_copies.py: at one chunk a lane, copies with the
// inputs' misses, the stores or the lookup taken out ran 3.2-3.4, 4.7-4.9
// and 6.2-6.4 ms against 6.2-6.3).
//
// What the design does about it:
// - The chain is cut.  The state resets to a known value (0) at every seg,
//   so a lane falls apart at its seg bits into independent pieces.  Lane s
//   is cut into kChunks chunks of L = ceil(T / kChunks) entries; chunk c's
//   thread skips from c*L to the first seg at or after it (chunk 0 starts
//   at entry 0, in state 0) and walks from there up to the first seg at or
//   after (c+1)*L, or to T.  Every entry is walked and written by exactly
//   one thread; no thread waits for another.  A thread's chain is at most
//   L plus the lane's longest piece (the padding tail is one piece).
// - One warp is one chunk of 32 neighbouring lanes, so each step still
//   reads and writes one 128-byte line; kWarps warps a block, and the grid
//   over (lane groups x chunks) puts 2,048 warps on the 132 SMs at 1,024
//   lanes.  Lanes past S and threads past their chunk are masked.
// - The inputs do not depend on the state: each thread keeps its next
//   kDepth inputs in flight in a register ring (the loop is unrolled by the
//   depth, so each slot keeps its register), and a thread whose chunk is
//   done loads nothing more.  An entry past T loads as a seg, which ends
//   every walk.  A cp.async ring of 24 rows a warp in shared memory ran
//   slower (0.48-0.58 ms against 0.44-0.46).
// - The state table (prob | next0 << 8 | next1 << 16) sits in shared
//   memory: the lanes of a warp read different entries, which constant
//   memory would serialise (a copy of it a lane, free of bank conflicts,
//   ran no faster).
// Measured at 1,024 lanes x 61,696 entries (one H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 7, which times copies of this file built with other
// kChunks and kDepth beside it, each output equal to this one's): 8.3 ms
// as one chain a lane, 0.46-0.54 ms as shipped (64 chunks, 16 entries in
// flight); 6.3, 1.04, 0.60 and 0.62 ms at 1, 8, 16 and 32 chunks; 1.19,
// 0.59, 0.59 and 0.48 ms at depths 1, 4, 8 and 32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunks = 64;   // pieces a lane is cut into (C)
constexpr int kWarps = 4;     // warps a block, one chunk of 32 lanes each
constexpr int kDepth = 16;    // inputs in flight ahead of each chain (D)
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kSeg = 2;

__global__ void __launch_bounds__(kWarps * kWarp)
walk_probs_kernel(const int32_t* __restrict__ xs,      // [T, S]
                  const int32_t* __restrict__ fused,   // [128]
                  int32_t* __restrict__ probs,         // [T, S]
                  int T, int S, int groups) {
  __shared__ int32_t s_fused[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = fused[i];
  __syncthreads();

  const int w = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w >= groups * kChunks) return;                 // a whole warp
  const int c = w / groups;
  const int lane = (w % groups) * kWarp + threadIdx.x % kWarp;
  const int L = (T + kChunks - 1) / kChunks;
  const int first = c * L;                           // chunk c: [c*L, end)
  const int end = min(first + L, T);
  const size_t s = static_cast<size_t>(S);
  const int32_t* xl = xs + lane;                     // entry t at xl[t * s]
  int32_t* pl = probs + lane;
  bool done = lane >= S || first >= T;
  auto load_x = [&](int t) -> int32_t {
    return !done && t < T ? xl[t * s] : kSeg;
  };
  int32_t xv[kDepth];                                // slot k: entry t0 + k
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
      st = seg ? 0 : st;
      const int32_t f = s_fused[st];
      if (on && !done) pl[t * s] = f & 0xFF;
      st = (f >> ((x & 1) ? 16 : 8)) & 0xFF;
    }
  }
}

}  // namespace

extern "C" int llct_walk_probs(const void* xs, const void* fused, void* probs,
                               int T, int S, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  const int groups = (S + kWarp - 1) / kWarp;
  const int grid = (groups * kChunks + kWarps - 1) / kWarps;
  walk_probs_kernel<<<grid, kWarps * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(fused),
      static_cast<int32_t*>(probs), T, S, groups);
  return static_cast<int>(cudaGetLastError());
}
