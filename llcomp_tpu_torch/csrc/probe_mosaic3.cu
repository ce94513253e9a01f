// Probes pG and pH of llcomp_tpu_torch.probes.mosaic3: a reduction over a
// whole block as a branch predicate, and the stage cost split with and
// without a per-lane data window, on the H100.
//
// Replaces the two Pallas kernels of tools/probe_mosaic3.py:
//   pG  pG_scalar_gate :48 (pallas_call :62)
//   pH  pH_stage       :76 (:127), with and without the window
//
// What the TPU probes asked: whether jnp.max over a vector block can
// drive pl.when (pG), and what a symbol step's staging costs (two model
// words in and out a lane) with and without an 8-row data window a lane
// (pH), when a scalar that every lane feeds (the window's sum, mod 1009)
// picks the next step's rows.
//
// What bounds them on the H100: latency.  pG moves 8 KB: one launch, one
// trip to memory and the reduction.  Its first design (tools/designs/
// probe_pG_block.cu: a block of one word a thread, block_max's warp redux,
// shared word a warp and two __syncthreads, then x read again to store)
// made two trips to memory and two block barriers, 1.79-1.82 us of device
// time at (8, 128).  pG now reads x once, in 16-byte loads, and keeps it
// in registers: one warp holds 1,024 words (8 int4 a thread), takes one
// warp redux and stores from registers, with no shared memory and no
// barrier; past 1,024 words, a block of more warps adds a shared word a
// warp and one __syncthreads.  The wrapper gives out x's address mod 16,
// so that both take the int4 path after the same head words.  On one H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 8, in turns with an empty
// launch of 0.87 us in one profiler session): 1.275 us against the block
// design's 1.793, and 8 warps of one int4 a thread 1.422.  pH is a serial
// chain: a step's rows wait for the carry, and the carry for every lane's
// window.  Run as one block (one thread a lane), each step's loads are
// uncoalesced (each lane reads its own rows) and pass through one SM's L1
// one line a lane: 32 warps x 12 scattered accesses at 1,024 lanes, 8.2-8.4
// us a step with the window (4.1-4.2 without), 1.3-1.4 us at 128 lanes (one
// H100 80GB HBM3 at 700 W, T 512, chip_smoke.py phase 8; the design kept
// as tools/designs/probe_mosaic3_one_block.cu).
//
// What the design does about it: pH runs as one thread-block cluster of
// cluster_blocks(lanes) blocks (up to 16, the non-portable size), the lanes
// split evenly over them, so that each SM serves a share of the scattered
// accesses.  Each step, each warp sums its lanes' windows with a redux and
// writes the one word into every block of the cluster (distributed shared
// memory, a lane a destination block); one cluster barrier (arrive with
// release, wait with acquire) a step publishes the words, and each warp
// adds them up with one redux over at most 32 words.  The words are
// double-buffered by step parity, so one barrier a step is enough: a word
// of buffer p is written again two steps later, after every reader of it
// has arrived at the barrier between.  The carry-independent idx rows are
// loaded kIdxDepth steps ahead into a register ring, and the model stores
// are issued after the arrive, off the barrier's release.  Threads of dead
// lanes, and blocks with no live lane, take part in every barrier.
// Measured on the same card (T 512, with the window): 1,540-1,639 ns a step
// at 1,024 lanes (16 blocks), 1,033-1,111 at 128 (8 blocks); the arrive's
// release still waits for the previous step's model stores, 330-390 ns a
// step (tools/torch_stream_copies.py).
#include "probe_common.cuh"

#include <cooperative_groups.h>

namespace {

using namespace probe;
namespace cg = cooperative_groups;

constexpr int kMaxBlock = 1024;
constexpr int kIdxDepth = 4;         // pH: idx rows loaded ahead, a lane
constexpr int kMaxCluster = 16;      // pH: the non-portable cluster size

// pH's cluster size at `lanes` lanes: the blocks the lanes are spread
// over (chip_smoke.py phase 8 times copies at 1, 2, 4, 8 and 16).
int cluster_blocks(int lanes) {
  const int pick = lanes > 512 ? 16 : 8;
  return pick;
}

// pG: 16-byte words (int4) a thread: one warp holds 32 x 8 x 4 = 1,024
// words of x in registers, a block of 1,024 threads kGateMaxWords.
constexpr int kGateVec = 8;
constexpr int kGateMaxWords = kMaxBlock * 4 * kGateVec;
// The fewest warps a pG block takes: one, so that up to 1,024 words need
// no shared memory and no barrier (chip_smoke.py times a copy at 8).
constexpr int kGateWarps = 1;

// pG: out = x + 1 if max(x) > 100 else x - 1, over all n words of x, x
// read once.  Words head .. head + 4*nv - 1 go as int4 i = t + j*threads
// of thread t (j < kGateVec), 16-byte loads and stores (x + head and out +
// head lie on a 16-byte boundary).  The head words before them and the
// tail words after them (at most 3 each) go one a thread to threads 0-5.
// Every load is issued before the maximum; one warp redux takes it, and a
// block of more than one warp adds a shared word a warp and one
// __syncthreads; the stores come from registers.
template <int MinWarps>
__global__ void __launch_bounds__(kMaxBlock)
scalar_gate(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n,
            int head, int nv) {
  const int t = threadIdx.x, threads = blockDim.x;
  const int4* const body = reinterpret_cast<const int4*>(x + head);
  int4 v[kGateVec];
#pragma unroll
  for (int j = 0; j < kGateVec; ++j) {
    const int i = t + j * threads;
    v[j] = i < nv ? body[i] : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  }
  const int tail = n - head - 4 * nv;
  const int e = t < head ? t : t - head < tail ? head + 4 * nv + t - head : -1;
  const int32_t w = e >= 0 ? x[e] : INT_MIN;
  int32_t m = w;
#pragma unroll
  for (int j = 0; j < kGateVec; ++j)
    m = max(m, max(max(v[j].x, v[j].y), max(v[j].z, v[j].w)));
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if (MinWarps > 1 || threads > kWarp) {
    __shared__ int32_t red[kWarp];
    if ((t & (kWarp - 1)) == 0) red[t / kWarp] = m;
    __syncthreads();
    m = red[0];
    for (int k = 1; k < threads / kWarp; ++k) m = max(m, red[k]);
  }
  const int32_t d = m > 100 ? 1 : -1;
  int4* const to = reinterpret_cast<int4*>(out + head);
#pragma unroll
  for (int j = 0; j < kGateVec; ++j) {
    const int i = t + j * threads;
    if (i < nv)
      to[i] = make_int4(wadd(v[j].x, d), wadd(v[j].y, d), wadd(v[j].z, d),
                        wadd(v[j].w, d));
  }
  if (e >= 0) out[e] = wadd(w, d);
}

// pH: T steps; at step s lane l stages the words (r, r+1) of its model
// column in and out (+1 each), r = ((idx[s mod idx_rows, l] + carry) mod
// (rows - 16)) rounded down to even, and with Window sums the data words
// b..b+7 of its column, b = r mod 992; carry = (carry + the sum over all
// lanes) mod 1009.  out [8, lanes] = the last carry.  Block b of the
// cluster takes lanes b*per .. b*per + per - 1, thread t lane b*per + t.
template <bool Window>
__global__ void __launch_bounds__(kMaxBlock)
stage_steps(const int32_t* __restrict__ idx, const int32_t* __restrict__ data,
            int32_t* __restrict__ M, int32_t* __restrict__ out, int lanes,
            int idx_rows, int rows, int T, int per) {
  __shared__ int32_t red[2][kWarp];   // a word a warp of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int t = threadIdx.x, lane = t % kWarp;
  const int l = blockIdx.x * per + t;
  const bool live = t < per && l < lanes;
  const int gw = blockIdx.x * (blockDim.x / kWarp) + t / kWarp;   // < 32
  for (int i = t; i < 2 * kWarp; i += blockDim.x)
    red[i / kWarp][i % kWarp] = 0;
  // lane j of each warp writes the warp's word into block j
  int32_t* to = lane < blocks ? cluster.map_shared_rank(&red[0][gw], lane)
                              : nullptr;
  const size_t n = static_cast<size_t>(lanes);
  int32_t ring[kIdxDepth];
  int ahead = 0;                       // (s + kIdxDepth) mod idx_rows
#pragma unroll
  for (int j = 0; j < kIdxDepth; ++j) {
    ring[j] = live && j < T ? idx[ahead * n + l] : 0;
    if (++ahead == idx_rows) ahead = 0;
  }
  cluster.sync();                      // red zeroed in every block
  int32_t carry = 0;
  for (int s0 = 0; s0 < T; s0 += kIdxDepth) {
#pragma unroll
    for (int j = 0; j < kIdxDepth; ++j) {
      const int s = s0 + j;
      if (s >= T) break;               // T is the same for every thread
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
      if (to) to[(s & 1) * kWarp] = part;
      asm volatile("barrier.cluster.arrive.release;" ::: "memory");
      if (live) {
        M[at] = wadd(wa, 1);
        M[at + n] = wadd(wb, 1);
      }
      asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
      const int32_t sum = static_cast<int32_t>(__reduce_add_sync(
          0xFFFFFFFFu, static_cast<uint32_t>(red[s & 1][lane])));
      carry = fmod_floor(wadd(carry, sum), 1009);
    }
  }
  if (live) {
    for (int i = 0; i < 8; ++i) out[i * n + l] = carry;
  }
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

// 1 <= n <= kGateMaxWords, and x and out at the same address mod 16 (the
// wrapper allocates out so), so that the head words bring both to a
// 16-byte boundary; cudaErrorInvalidValue otherwise.
extern "C" int llct_probe_pG(const void* x, void* out, int n, void* stream) {
  const auto ax = reinterpret_cast<uintptr_t>(x);
  if (n < 1 || n > kGateMaxWords ||
      ax % 16 != reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head = min(static_cast<int>((16 - ax % 16) % 16 / 4), n);
  const int nv = (n - head) / 4;
  const int warps = max(kGateWarps,
                        (nv + kWarp * kGateVec - 1) / (kWarp * kGateVec));
  scalar_gate<kGateWarps><<<1, warps * kWarp, 0, as_stream(stream)>>>(
      in(x), io(out), n, head, nv);
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
