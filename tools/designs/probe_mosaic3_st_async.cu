// Probe pH of llcomp_tpu_torch.probes.mosaic3 as a design not taken: the
// shipped kernel (llcomp_tpu_torch/csrc/probe_mosaic3.cu) with its one
// cluster barrier a step replaced by asynchronous stores into distributed
// shared memory that count themselves on a transaction barrier
// (st.async ... mbarrier::complete_tx) in each destination block.
//
// Why: a barrier.cluster arrive with release semantics waits for the
// thread's earlier global stores (the previous step's model words) to be
// performed, 330-390 ns a step on one H100 80GB HBM3 at 700 W
// (tools/torch_stream_copies.py, its relaxed-arrive ablation).  Here each
// warp's word goes to every block by st.async, which needs no fence; block
// b's thread 0 arms that block's mbarrier of the step's parity for
// (warps of the cluster) x 4 bytes, and every thread waits on it (acquire
// at cluster scope) before it reads the words.  The words and the
// mbarriers are double-buffered by step parity: the words of step s + 2
// reach a block only after its warps have sent their words of step s + 1,
// so after they have read those of step s.  A wait that does not end
// within kSpins tries traps, so a fault here fails the launch instead of
// hanging the card.  chip_smoke.py does not run it; the copies script
// times it beside the shipped kernel and holds it against the plain
// version.
#include "probe_common.cuh"

#include <cooperative_groups.h>

namespace {

using namespace probe;
namespace cg = cooperative_groups;

constexpr int kMaxBlock = 1024;
constexpr int kIdxDepth = 4;         // pH: idx rows loaded ahead, a lane
constexpr int kMaxCluster = 16;      // pH: the non-portable cluster size
constexpr long kSpins = 1L << 22;    // pH: tries of a wait before it traps

// pH's cluster size at `lanes` lanes: the blocks the lanes are spread
// over (chip_smoke.py phase 8 times copies at 1, 2, 4, 8 and 16).
int cluster_blocks(int lanes) {
  const int pick = lanes > 512 ? 16 : 8;
  return pick;
}

// pG: out = x + 1 if max(x) > 100 else x - 1, over all n words of x.
__global__ void __launch_bounds__(kMaxBlock)
scalar_gate(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n) {
  __shared__ int32_t red[kWarp];
  int32_t m = INT_MIN;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max(m, x[i]);
  const int32_t d = block_max(m, red) > 100 ? 1 : -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = wadd(x[i], d);
}

// pH: T steps; at step s lane l stages the words (r, r+1) of its model
// column in and out (+1 each), r = ((idx[s mod idx_rows, l] + carry) mod
// (rows - 16)) rounded down to even, and with Window sums the data words
// b..b+7 of its column, b = r mod 992; carry = (carry + the sum over all
// lanes) mod 1009.  out [8, lanes] = the last carry.  Block b of the
// cluster takes lanes b*per .. b*per + per - 1, thread t lane b*per + t.
__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of shared address `addr` in block `rank`.
__device__ __forceinline__ uint32_t in_block(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long i = 0; !done; ++i) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (i == kSpins) __trap();
  }
}

template <bool Window>
__global__ void __launch_bounds__(kMaxBlock)
stage_steps(const int32_t* __restrict__ idx, const int32_t* __restrict__ data,
            int32_t* __restrict__ M, int32_t* __restrict__ out, int lanes,
            int idx_rows, int rows, int T, int per) {
  __shared__ int32_t red[2][kWarp];   // a word a warp of the cluster
  __shared__ alignas(8) uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int t = threadIdx.x, lane = t % kWarp;
  const int l = blockIdx.x * per + t;
  const bool live = t < per && l < lanes;
  const int gw = blockIdx.x * (blockDim.x / kWarp) + t / kWarp;   // < 32
  const uint32_t bytes = blocks * (blockDim.x / kWarp) * 4;
  for (int i = t; i < 2 * kWarp; i += blockDim.x)
    red[i / kWarp][i % kWarp] = 0;
  if (t == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem(&bar[p])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane j of each warp sends the warp's word to block j
  const uint32_t to_red = lane < blocks ? in_block(smem(&red[0][gw]), lane)
                                        : 0;
  const uint32_t to_bar = lane < blocks ? in_block(smem(&bar[0]), lane) : 0;
  const size_t n = static_cast<size_t>(lanes);
  int32_t ring[kIdxDepth];
  int ahead = 0;                       // (s + kIdxDepth) mod idx_rows
#pragma unroll
  for (int j = 0; j < kIdxDepth; ++j) {
    ring[j] = live && j < T ? idx[ahead * n + l] : 0;
    if (++ahead == idx_rows) ahead = 0;
  }
  cluster.sync();                      // red zeroed, mbarriers set up
  int32_t carry = 0;
  for (int s0 = 0; s0 < T; s0 += kIdxDepth) {
#pragma unroll
    for (int j = 0; j < kIdxDepth; ++j) {
      const int s = s0 + j;
      if (s >= T) break;               // T is the same for every thread
      const int p = s & 1;
      if (t == 0)
        asm volatile("{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta"
                     ".b64 st, [%0], %1; }"
                     :: "r"(smem(&bar[p])), "r"(bytes) : "memory");
      const int32_t x = ring[j];
      if (live && s + kIdxDepth < T) ring[j] = idx[ahead * n + l];
      if (++ahead == idx_rows) ahead = 0;
      int32_t part = 0, wa = 0, wb = 0;
      size_t at = 0;
      if (live) {
        const int32_t r = fmod_floor(wadd(x, carry), rows - 16) & ~1;
        at = r * n + l;
        wa = M[at];
        wb = M[at + n];
        if constexpr (Window) {
          const int32_t b = r % 992;
#pragma unroll
          for (int i = 0; i < 8; ++i) part = wadd(part, data[(b + i) * n + l]);
        }
      }
      part = static_cast<int32_t>(
          __reduce_add_sync(0xFFFFFFFFu, static_cast<uint32_t>(part)));
      if (lane < blocks)
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                     ".u32 [%0], %1, [%2];"
                     :: "r"(to_red + p * kWarp * 4), "r"(part),
                        "r"(to_bar + p * 8) : "memory");
      if (live) {
        M[at] = wadd(wa, 1);
        M[at + n] = wadd(wb, 1);
      }
      wait_parity(smem(&bar[p]), (s >> 1) & 1);
      const int32_t sum = static_cast<int32_t>(__reduce_add_sync(
          0xFFFFFFFFu, static_cast<uint32_t>(red[p][lane])));
      carry = fmod_floor(wadd(carry, sum), 1009);
    }
  }
  if (live) {
    for (int i = 0; i < 8; ++i) out[i * n + l] = carry;
  }
  cluster.sync();                      // no block leaves before the last word
}

// A kernel that does nothing: its device time is the floor under every
// one-shot probe's, whatever the bytes and operations of its work.
__global__ void empty() {}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

template <bool Window>
int launch_pH(const void* idx, const void* data, void* M, void* out,
              int lanes, int idx_rows, int rows, int T, void* stream) {
  const int blocks = cluster_blocks(lanes);
  if (blocks < 1 || blocks > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = stage_steps<Window>;
  if (blocks > 8) {            // past the portable size: asked for, or fail
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (done(), static_cast<int>(e));
  }
  const int per = (lanes + blocks - 1) / blocks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(whole_warps(per));
  cfg.stream = as_stream(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, in(idx), in(data), io(M), io(out), lanes, idx_rows, rows,
      T, per);
  const int last = done();     // also clears a refused launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}

}  // namespace

// Entry points: one a probe; every pointer is int32.  Each returns
// cudaGetLastError().

extern "C" int llct_probe_pG(const void* x, void* out, int n, void* stream) {
  const int threads = n < kMaxBlock ? whole_warps(n) : kMaxBlock;
  scalar_gate<<<1, threads, 0, as_stream(stream)>>>(in(x), io(out), n);
  return done();
}

// 1 <= lanes <= 1,024, idx_rows >= 1; data has at least 1,000 rows, so
// that every window b..b+7 lies inside it.  One cluster of
// cluster_blocks(lanes) blocks; a launch the card refuses (a cluster of 16
// where the non-portable size is not allowed) returns its error.
extern "C" int llct_probe_pH(const void* idx, const void* data, void* M,
                             void* out, int lanes, int idx_rows, int rows,
                             int T, int window, void* stream) {
  if (lanes < 1 || lanes > kMaxBlock || idx_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return window ? launch_pH<true>(idx, data, M, out, lanes, idx_rows, rows,
                                  T, stream)
                : launch_pH<false>(idx, data, M, out, lanes, idx_rows, rows,
                                   T, stream);
}

// The launch floor: one block of one warp running `empty`.
extern "C" int llct_probe_empty(void* stream) {
  empty<<<1, kWarp, 0, as_stream(stream)>>>();
  return done();
}
