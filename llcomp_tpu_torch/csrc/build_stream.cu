// Kernel 5 of llcomp_tpu_torch: the decision variant's stream builder, one
// block a tile of one lane's symbols.
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_make_build_kernel
// (build_stream, encode_kernels.py:74).  Input: each lane's folded context
// hash and residual per symbol, lane-major [S, n_pad] int32; symbols at or
// past n_sym are padding.  Output: K slots per symbol, lane-major
// [S, n_pad*K] int32, as the forward sort reads them: slot k of a live
// symbol holds (hash*8 + ctx)*2 + bit of its decision k (zero flag, unary
// exponent with ctx min(k, 4), stop, mantissa MSB first with ctx 5..6, sign
// with ctx 7), and -1 past its last decision and on every padding symbol.
// The exponent e counts bits 1..11 of |d| (floor(log2 |d|) for |d| < 2^12,
// 11 above), and the mantissa shift is clipped to 0..30, as in the TPU
// kernel.
//
// What bounds it on the H100: bytes, once the arithmetic a slot is small.
// At 1,024 lanes x 12,288 symbols x K 24 it writes 1.2 GB (391 us at 3.35
// TB/s).  One thread a slot, with each slot's symbol and lane found by
// 64-bit division (a software routine of dozens of instructions) and its
// symbol's terms recomputed, made it instruction-bound (1.54 ms on one
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 7).
//
// What the design does about it: a block takes a tile of kTile symbols of
// one lane, whose kTile*K slots are one contiguous run of the output.  It
// loads the tile's hashes and residuals once, coalesced, and works out each
// symbol's terms once into shared memory (slot()'s per-symbol part); then
// its threads write the run, four slots a thread as one 16-byte streaming
// store where K % 4 == 0 (the engine's K 8, 16 and 24), one slot a store
// otherwise, each slot from its symbol's terms and k (slot()'s per-k part).
// K is a template parameter for 8, 16 and 24 (a division by K/4 is a
// multiply), with one instantiation for any other K; a slot's symbol in the
// tile is found with 32-bit arithmetic, and the row's offset in size_t once
// a block.  Measured on the same card: 0.565-0.637 ms, 61-69% of the bound
// (chip_smoke.py phase 7, tools/torch_stream_copies.py); what holds it now
// is instructions, 51.75 SASS instructions a slot in the store loop
// (slot()'s branches) against the one-thread design's 136 and two calls.
//
// Other codec configurations (codec_cfg.cuh, built once a cfg): slot k
// holds (hash*kSub + ctx)*2 + bit, with contexts exp_ctx(k) (the stop
// too), mant_ctx(j) and kSignCtx; at rev 2's constants these fold to rev
// 2's contexts, and the REV2 build is the rev-2 kernel.
#include <cstdint>
#include <cuda_runtime.h>

#include "codec_cfg.cuh"

namespace {

constexpr int kTile = 256;      // symbols a block
constexpr int kThreads = 128;   // threads a block
constexpr bool kVector = true;  // 16-byte stores where K % 4 == 0

// slot()'s per-symbol part: the decision terms of residual d.
struct Terms {
  int32_t h16;   // hash * 2 * kSub: hash * 16 at rev 2's 8 substates
  int32_t ad;    // |d|
  int e;         // exponent, 0..11
  bool nz;       // d != 0
  bool neg;      // d < 0
  bool live;     // j < n_sym
};

__device__ __forceinline__ Terms terms(int32_t h, int32_t d, bool live) {
  const int32_t ad = d < 0 ? -d : d;
  const int e = ad > 1 ? min(31 - __clz(ad), 11) : 0;
  return {static_cast<int32_t>(static_cast<uint32_t>(h) * (2u * kSub)), ad,
          e, ad != 0, d < 0, live};
}

// slot()'s per-k part: slot k of a symbol with terms t.  Rev 2's
// contexts are min(k, 4) (the stop too), min(k - e + 3, 6) and 7.
__device__ __forceinline__ int32_t slot(const Terms& t, int k) {
  const int e = t.e;
  const int32_t ad = t.ad;
  const bool nz = t.nz;
  const bool in_exp = k >= 1 && k <= e;
  const bool is_stop = k == e + 1;
  const bool in_mant = k >= e + 2 && k <= 2 * e + 1;
  const bool is_sign = k == 2 * e + 2;
  if (!t.live || !(k == 0 || (nz && (in_exp || is_stop || in_mant ||
                                     is_sign))))
    return -1;
  int ctx = 0, bit;
  if (k == 0) {
    bit = !nz;
  } else if (in_exp) {
    ctx = exp_ctx(k);
    bit = 1;
  } else if (is_stop) {
    ctx = exp_ctx(e + 1);
    bit = 0;
  } else if (in_mant) {
    ctx = mant_ctx(k - e - 2);
    bit = (ad >> min(max(2 * e + 1 - k, 0), 30)) & 1;
  } else {
    ctx = kSignCtx;
    bit = t.neg;
  }
  return t.h16 + ctx * 2 + bit;
}

// Terms in shared memory, one word each: h16, |d|, and e | nz << 4 |
// neg << 5 | live << 6.
__device__ __forceinline__ Terms load_terms(const int32_t* h16,
                                            const int32_t* ad,
                                            const int32_t* bits, int j) {
  const int32_t b = bits[j];
  return {h16[j], ad[j], b & 15, (b & 16) != 0, (b & 32) != 0,
          (b & 64) != 0};
}

// Block b of the grid takes tile b % tiles of lane b / tiles.  KT > 0 is
// K; KT == 0 takes K at run time.
template <int KT>
__global__ void __launch_bounds__(kThreads)
build_stream_kernel(const int32_t* __restrict__ hash,   // [S, n_pad]
                    const int32_t* __restrict__ diff,   // [S, n_pad]
                    int32_t* __restrict__ out,          // [S, n_pad*K]
                    int n_pad, int n_sym, int K_rt, unsigned tiles) {
  const int K = KT > 0 ? KT : K_rt;
  __shared__ int32_t h16[kTile], ad[kTile], bits[kTile];
  const unsigned lane = blockIdx.x / tiles;
  const int j0 = static_cast<int>(blockIdx.x - lane * tiles) * kTile;
  const int n = min(kTile, n_pad - j0);          // symbols in this tile
  const size_t row = static_cast<size_t>(lane) * n_pad + j0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const Terms t = terms(hash[row + j], diff[row + j], j0 + j < n_sym);
    h16[j] = t.h16;
    ad[j] = t.ad;
    bits[j] = t.e | t.nz << 4 | t.neg << 5 | t.live << 6;
  }
  __syncthreads();
  int32_t* o = out + row * K;
  if (kVector && K % 4 == 0) {                   // 16-byte aligned rows
    const int q = K / 4;
    int4* o4 = reinterpret_cast<int4*>(o);
    for (int v = threadIdx.x; v < n * q; v += kThreads) {
      const int j = v / q;
      const int k = (v - j * q) * 4;
      const Terms t = load_terms(h16, ad, bits, j);
      __stcs(o4 + v, make_int4(slot(t, k), slot(t, k + 1), slot(t, k + 2),
                               slot(t, k + 3)));
    }
  } else {
    for (int i = threadIdx.x; i < n * K; i += kThreads) {
      const int j = i / K;
      __stcs(o + i, slot(load_terms(h16, ad, bits, j), i - j * K));
    }
  }
}

template <int KT>
void launch(const void* hash, const void* diff, void* out, unsigned blocks,
            int n_pad, int n_sym, int K, unsigned tiles, cudaStream_t s) {
  build_stream_kernel<KT><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(hash), static_cast<const int32_t*>(diff),
      static_cast<int32_t*>(out), n_pad, n_sym, K, tiles);
}

}  // namespace

extern "C" int llct_build_stream(const void* hash, const void* diff,
                                 void* out, int S, int n_pad, int n_sym,
                                 int K, void* stream) {
  if (K <= 0 || S < 0 || n_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || n_pad == 0) return 0;
  const unsigned tiles = (static_cast<unsigned>(n_pad) + kTile - 1) / kTile;
  const size_t blocks = static_cast<size_t>(S) * tiles;
  if (blocks > 0x7FFFFFFFu) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<unsigned>(blocks);
  switch (K) {
    case 8: launch<8>(hash, diff, out, b, n_pad, n_sym, K, tiles, s); break;
    case 16: launch<16>(hash, diff, out, b, n_pad, n_sym, K, tiles, s); break;
    case 24: launch<24>(hash, diff, out, b, n_pad, n_sym, K, tiles, s); break;
    default: launch<0>(hash, diff, out, b, n_pad, n_sym, K, tiles, s);
  }
  return static_cast<int>(cudaGetLastError());
}
