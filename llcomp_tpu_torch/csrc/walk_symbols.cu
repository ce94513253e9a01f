// Kernel 3 of llcomp_tpu_torch: the sort chain's symbol walk, one thread per
// lane (one lane = one independent rev-2 stream).
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_make_symwalk_kernel
// (walk_symbols, encode_kernels.py:175).  Input: each lane's symbols sorted
// by (context hash, position) (encode.stage_sym_sort), one int32 each,
// bucket<<14 | live<<13 | seg<<12 | diff+1274.  A context's symbols arrive
// together, so the lane's whole model is one row of 8 substates x 8 bits
// (two 32-bit registers, substates 0-3 and 4-7) that resets where seg is
// set: to zeros, or to the bucket's prior or seed row.  For each live symbol
// the kernel regenerates its decisions (zero flag, unary exponent with ctx
// min(k, 4), stop, mantissa MSB first with ctx 5..6, sign with ctx 7; at
// most K), moves the row along the state table, and writes each decision's
// coder record valid<<9 | bit<<8 | prob.  Records are pair-packed, 10 bits
// each: quad q of symbol j holds records 4q, 4q+1 in lo[j*K/4 + q] and
// 4q+2, 4q+3 in hi[j*K/4 + q].  Records past a symbol's last decision, and
// every record of a dead symbol, are 0.
//
// What bounds it on the H100: latency, not bandwidth.  Each lane is a serial
// chain of table lookups and row updates, and the lanes of a warp diverge on
// their symbols' decision counts; with 1,024 lanes only 32 warps are in
// flight.  Bytes moved: 4 B in per symbol and 8 B out per quad (K/4 quads
// per symbol), all coalesced, because every array is lane-minor [T, S].
//
// What the design does about it: no model in device memory at all (the
// sort made it one register row); the state table (prob | next0 << 8 |
// next1 << 16) and the 128 reset rows sit in shared memory, not
// __constant__, because the lanes of a warp read different entries and
// constant memory serialises divergent reads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;    // lanes (threads) per block
constexpr int kRows = 128;    // reset rows, indexed by the 7-bit bucket field

// Registers are named, not indexed: a register array indexed by a run-time
// value (ctx, k) would live in local memory.
struct Walker {
  uint32_t row_lo = 0, row_hi = 0;    // substates 0-3 and 4-7, 8 bits each
  uint32_t quad_lo = 0, quad_hi = 0;  // records of the open quad
  int k = 0;                          // decisions of this symbol so far
  int K;
  const int32_t* fused;
  int32_t* lo;                        // this symbol's quad 0 of this lane
  int32_t* hi;
  size_t S;                           // stride between quads

  // Walk one decision (dropped past K): look the substate up, move it, and
  // append the record to the open quad.
  __device__ __forceinline__ void decide(int ctx, uint32_t bit) {
    if (k >= K) return;
    const bool upper = ctx >= 4;
    const int sh = (ctx & 3) * 8;
    const uint32_t word = upper ? row_hi : row_lo;
    const uint32_t st = (word >> sh) & 0xFF;
    const uint32_t f = static_cast<uint32_t>(fused[st]);
    const uint32_t ns = (f >> (bit ? 16 : 8)) & 0xFF;
    const uint32_t moved = (word & ~(0xFFu << sh)) | (ns << sh);
    if (upper) row_hi = moved; else row_lo = moved;
    const uint32_t rec = (0x200u | (bit << 8) | (f & 0xFF)) << (10 * (k & 1));
    if (k & 2) quad_hi |= rec; else quad_lo |= rec;
    if ((k & 3) == 3) store(k >> 2);
    ++k;
  }

  __device__ __forceinline__ void store(int q) {
    lo[q * S] = static_cast<int32_t>(quad_lo);
    hi[q * S] = static_cast<int32_t>(quad_hi);
    quad_lo = quad_hi = 0;
  }

  // Close the symbol: store the open quad, zero the quads left.
  __device__ __forceinline__ void finish_symbol() {
    int q = k >> 2;
    if (k & 3) store(q++);
    for (; q < K / 4; ++q) store(q);
    k = 0;
  }
};

__global__ void __launch_bounds__(kBlock)
walk_symbols_kernel(const int32_t* __restrict__ xs,      // [n, S]
                    const int32_t* __restrict__ fused,   // [128]
                    const uint64_t* __restrict__ rows,   // [128]
                    int32_t* __restrict__ lo,            // [n*K/4, S]
                    int32_t* __restrict__ hi,            // [n*K/4, S]
                    int n, int S, int K) {
  __shared__ int32_t s_fused[128];
  __shared__ uint64_t s_rows[kRows];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = fused[i];
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) s_rows[i] = rows[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t qs = static_cast<size_t>(K / 4);
  Walker w;
  w.K = K;
  w.fused = s_fused;
  w.S = static_cast<size_t>(S);

  for (int j = 0; j < n; ++j) {
    const int32_t x = xs[static_cast<size_t>(j) * S + lane];
    if (x & (1 << 12)) {                   // a new context run
      const uint64_t r = s_rows[(x >> 14) & 0x7F];
      w.row_lo = static_cast<uint32_t>(r);
      w.row_hi = static_cast<uint32_t>(r >> 32);
    }
    w.lo = lo + static_cast<size_t>(j) * qs * S + lane;
    w.hi = hi + static_cast<size_t>(j) * qs * S + lane;
    if (x & (1 << 13)) {                   // live
      const int d = (x & 0xFFF) - 1274;
      const uint32_t ad = static_cast<uint32_t>(d < 0 ? -d : d);
      w.decide(0, ad == 0);                                  // zero flag
      if (ad) {
        const int e = 31 - __clz(ad);                        // floor(log2)
        for (int i = 1; i <= e; ++i) w.decide(min(i, 4), 1);  // exponent
        w.decide(min(e + 1, 4), 0);                           // stop
        for (int i = 0; i < e; ++i)                           // mantissa
          w.decide(min(5 + i, 6), (ad >> (e - 1 - i)) & 1);
        w.decide(7, d < 0);                                   // sign
      }
    }
    w.finish_symbol();
  }
}

}  // namespace

extern "C" int llct_walk_symbols(const void* xs, const void* fused,
                                 const void* rows, void* lo, void* hi, int n,
                                 int S, int K, void* stream) {
  if (K < 4 || K % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || n <= 0) return 0;
  const int grid = (S + kBlock - 1) / kBlock;
  walk_symbols_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(fused),
      static_cast<const uint64_t*>(rows), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), n, S, K);
  return static_cast<int>(cudaGetLastError());
}
