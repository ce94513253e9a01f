// Shared pieces of the probe kernels (probe_mosaic.cu, probe_mosaic2.cu,
// probe_mosaic3.cu, probe_reduce.cu).
//
// Every probe array is [rows, lanes] int32, row-major, lanes the minor
// dimension (the TPU probes' layout), and one thread owns one lane: thread
// l reads and writes column l only, so lanes that pick the same row never
// touch the same word.  Integer arithmetic follows the JAX probes: sums and
// products wrap around in 32 bits, and `%` is a floor modulo (JAX's and
// torch's), which agrees with C's on the non-negative values the probes
// make.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace probe {

constexpr int kWarp = 32;
// Threads a block where lanes are independent: one warp, as the library's
// serial kernels launch (1,024 lanes spread over 32 SMs).
constexpr int kLaneBlock = 32;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t fmod_floor(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return r < 0 ? r + m : r;
}

// The staging probes' per-lane model row at step s: (x*(s+1) + s*40503)
// mod m (probe_mosaic.py:242, probe_mosaic2.py:230).
__device__ __forceinline__ int32_t step_row(int32_t x, int s, int32_t m) {
  return fmod_floor(wadd(wmul(x, s + 1), wmul(s, 40503)), m);
}

// The word at row r (r >= 0) of a lane's column of a plane: `col` points at
// the column's word in row 0, and rows lie `pitch` bytes apart (4 x lanes).
// One 32 x 32 -> 64-bit multiply-add (IMAD.WIDE.U32) a word.
__device__ __forceinline__ int32_t* word_at(int32_t* col, int32_t r,
                                            uint32_t pitch) {
  return reinterpret_cast<int32_t*>(
      reinterpret_cast<char*>(col) +
      static_cast<uint64_t>(static_cast<uint32_t>(r)) * pitch);
}

__device__ __forceinline__ const int32_t* word_at(const int32_t* col,
                                                  int32_t r, uint32_t pitch) {
  return word_at(const_cast<int32_t*>(col), r, pitch);
}

// A lane's step_row(x, s, m) for s = 0, 1, 2, ... in turn (p7, p8, pF):
// the wrapped 32-bit step value x*(s+1) + s*40503 grows by x + 40503 a
// step, and each row is its floor modulo.  A row depends on x and s alone,
// so the rows of later steps are known before the earlier steps run.
struct StepRows {
  uint32_t v, dv;
  int32_t m;
  __device__ StepRows(int32_t x, int32_t m_)
      : v(static_cast<uint32_t>(x)), dv(static_cast<uint32_t>(x) + 40503u),
        m(m_) {}
  __device__ __forceinline__ int32_t next() {
    const int32_t r = fmod_floor(static_cast<int32_t>(v), m);
    v += dv;
    return r;
  }
};

// PTX prmt: the bytes of {b:a} that the four low nibbles of s select
// (values 0-7 here).  __byte_perm masks s with 0x7777 first, one more
// instruction, which would sit on decide_perm's chain.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The prmt selector that writes byte 0 of the second word over byte c of
// the first where m is 0xF << 4c (nibble c 4, the rest 0x3210), and keeps
// the first word where m's nibble lies in the upper half, which prmt does
// not read: 0x3210 ^ (0x7654 & m), one LOP3.
__device__ __forceinline__ uint32_t put_byte_sel(uint32_t m) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;"
      : "=r"(d) : "r"(m), "r"(0x7654u), "r"(0x3210u));
  return d;
}

// One stand-in decision (probe_mosaic.py:258-266), the step of p7, p9,
// p10 and pF: ctx = (acc + d) & 7 picks byte ctx of the lane's 8-byte
// model row, acc = (acc*5 + byte + 1) & 0x7FFF, and the byte steps to
// (byte + 1) & 0xFF.  The row stays in two 32-bit registers (bytes 0-3 in
// lo, 4-7 in hi): an int[8] indexed by ctx would live in local memory.
// The chain is cut to what the next ctx needs (the shift-and-select step
// it replaced, decide, 10 dependent instructions a decision, stays in
// tools/designs/probe_serial_decide.cuh for the copies of the designs
// replaced).  acc is carried as t = acc + d in 32 bits, wrapping and
// unmasked: acc's & 0x7FFF commutes with wrapping arithmetic (2^15
// divides 2^32), so the caller masks once, where acc leaves.  Then ctx =
// t & 7, and t' = 5t + byte + k with k = 2 - 4d (d's and the +1's
// constants folded).  ctx is a chain of its own, three dependent
// instructions: one prmt reads byte ctx of {hi:lo} into byte 0 (bytes 1-3
// are lo's byte 0, which no bit of ctx' sees), then ctx' = (raw + 5ctx +
// k) & 7, 5ctx + k formed beside the read.  The row and t hang off that
// chain: one prmt a word writes byte 0 of raw + 1, (byte + 1) & 0xFF, over
// byte ctx & 3 of the word ctx is in, its selector from a rotate of a
// nibble mask by 4ctx (put_byte_sel).
__device__ __forceinline__ void decide_perm(uint32_t& lo, uint32_t& hi,
                                            uint32_t& ctx, uint32_t& t,
                                            uint32_t k) {
  const uint32_t raw = prmt(lo, hi, ctx);
  const uint32_t sh = ctx << 2;
  const uint32_t ahead = ctx * 5u + k;
  const uint32_t next = raw + 1u;
  lo = prmt(lo, next, put_byte_sel(__funnelshift_l(0xFu, 0xFu, sh)));
  hi = prmt(hi, next, put_byte_sel(__funnelshift_l(0xF0000u, 0xF0000u, sh)));
  uint32_t sum;   // raw + ahead as its own add, after the read
  asm("add.u32 %0, %1, %2;" : "=r"(sum) : "r"(raw), "r"(ahead));
  ctx = sum & 7u;
  t = t * 5u + (raw & 0xFFu) + k;
}

// One step of 24 decide_perm, the loop kept (Unroll false) or unrolled
// (true): t goes in and out as acc (t - 24 after decision 23 is the next
// step's t at d = 0), ctx = t & 7 on both sides.
template <bool Unroll>
__device__ __forceinline__ void decide24_perm(uint32_t& lo, uint32_t& hi,
                                              uint32_t& ctx, uint32_t& t) {
  if constexpr (Unroll) {
#pragma unroll
    for (int d = 0; d < 24; ++d) decide_perm(lo, hi, ctx, t, 2u - 4u * d);
  } else {
#pragma unroll 1
    for (uint32_t k = 2u; k != 2u - 96u; k -= 4u)
      decide_perm(lo, hi, ctx, t, k);
  }
  t -= 24u;
}

// Per-lane window gather: out[i, l] = src[r + i, l] for i < win, where
// r = idx[0, l] mod m (m > 0) or idx[0, l] (m == 0), clamped into
// [0, rows - win].  Probes p1, p2, p4, p5 and pB, pD, pE.
__global__ void __launch_bounds__(kLaneBlock)
window_gather(const int32_t* __restrict__ idx, const int32_t* __restrict__ src,
              int32_t* __restrict__ out, int lanes, int rows, int win, int m) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  int32_t r = idx[l];
  if (m > 0) r = fmod_floor(r, m);
  r = min(max(r, 0), rows - win);
  const size_t n = static_cast<size_t>(lanes);
  for (int i = 0; i < win; ++i) out[i * n + l] = src[(r + i) * n + l];
}

// Per-lane row store (the TPU's row read-modify-write): model[idx[0, l]
// mod 8, l] = val[0, l]; out = model[0:8].  Probes p3 and pC.
// What bounds it: one launch; it moves a few KB.  A load after the store
// would have to wait for it (the row r is data, so any of the 8 words may
// be the one stored), putting a store and a load round trip in series.  So
// the lane's 8 words are loaded first, beside idx and val, as independent
// loads; val replaces word r in registers; then out and the one model word
// are stored, and no load follows a store.
__global__ void __launch_bounds__(kLaneBlock)
row_store(const int32_t* __restrict__ idx, const int32_t* __restrict__ val,
          int32_t* __restrict__ model, int32_t* __restrict__ out, int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t n = static_cast<size_t>(lanes);
  int32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = model[i * n + l];
  const int r = fmod_floor(idx[l], 8);
  const int32_t v = val[l];
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * n + l] = i == r ? v : w[i];
  model[r * n + l] = v;
}

// Elementwise out[0, l] = idx[0, l] * a + b.  Probes p6 (1, 1) and pA (2, 1).
__global__ void __launch_bounds__(kLaneBlock)
affine(const int32_t* __restrict__ idx, int32_t* __restrict__ out, int lanes,
       int32_t a, int32_t b) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < lanes) out[l] = wadd(wmul(idx[l], a), b);
}

// Block-wide reductions for a block of whole warps, every thread taking
// part: the warp's redux (sm_80+), then one word a warp in shared memory
// (`red`, 32 words), read back by every thread.  Both __syncthreads keep
// `red` safe to reuse by the next call.
__device__ __forceinline__ int32_t block_max(int32_t v, int32_t* red) {
  v = __reduce_max_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & (kWarp - 1)) == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  int32_t r = red[0];
  for (int w = 1; w < blockDim.x / kWarp; ++w) r = max(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
  v = static_cast<int32_t>(
      __reduce_add_sync(0xFFFFFFFFu, static_cast<uint32_t>(v)));
  if ((threadIdx.x & (kWarp - 1)) == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  int32_t r = red[0];
  for (int w = 1; w < blockDim.x / kWarp; ++w) r = wadd(r, red[w]);
  __syncthreads();
  return r;
}

inline int lane_blocks(int lanes) {
  return (lanes + kLaneBlock - 1) / kLaneBlock;
}

inline int whole_warps(int n) {
  return (n + kWarp - 1) / kWarp * kWarp;
}

inline int done(void) { return static_cast<int>(cudaGetLastError()); }

}  // namespace probe
