// The codec configuration that a build of kernels 1 and 2 codes
// (llcomp_tpu_torch/core/config.py: CodecConfig, check, defines), and the
// model rows it gives.
//
// The JAX package specialises its Pallas kernels on the cfg at trace time;
// here the cfg is fixed at compile time.  The wrappers pass each field that
// differs from rev 2 as a -D define (config.defines) and build each cfg once
// into llcomp_tpu_torch/_build/.  With no define, every value is rev 2's and
// the kernels are the rev-2 kernels.  config.check has passed every cfg that
// is built: each context a valid stream needs lies in [0, kSub).
//
// A model row is kWords 64-bit words a context hash, substate c in byte
// c % 8 of word c / 8 (one word at 8 substates, as rev 2 always had); a
// lane's model is kRowWords words.  Rows start at zero, or, at 8 substates
// only, at the bucket table's row h % 121 (the static prior or the stored
// seed, whose rows hold 8 substates).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LLCT_E_LIM
#define LLCT_E_LIM 4
#endif
#ifndef LLCT_R_LIM
#define LLCT_R_LIM 6
#endif
#ifndef LLCT_SIGN_CTX
#define LLCT_SIGN_CTX 7
#endif
#ifndef LLCT_SUBSTATES
#define LLCT_SUBSTATES 8
#endif
#ifndef LLCT_LARGE_MODEL
#define LLCT_LARGE_MODEL 1
#endif
#ifndef LLCT_MAX_BINS
#define LLCT_MAX_BINS 24
#endif
#ifndef LLCT_NUM_HASHES
#define LLCT_NUM_HASHES 7926
#endif

namespace {

constexpr int kELim = LLCT_E_LIM;       // exponent contexts min(k, kELim)
constexpr int kRLim = LLCT_R_LIM;       // mantissa: min(kELim + 1 + j, kRLim)
constexpr int kSignCtx = LLCT_SIGN_CTX;
constexpr int kSub = LLCT_SUBSTATES;    // substates (one byte each) a hash
constexpr bool kLargeModel = LLCT_LARGE_MODEL != 0;
constexpr int kMaxBins = LLCT_MAX_BINS; // decisions a symbol may take
// reachable folded hashes, CodecConfig.num_hashes: 5 + 5*11 + 5*121
// (+ 2*605 + 2*3025) + 1, 7926 or 666
constexpr int kNumHashes = LLCT_NUM_HASHES;
constexpr int kWords = (kSub + 7) / 8;  // model words a hash
constexpr int kRowWords = (kNumHashes * kWords + 1) / 2 * 2;
constexpr int kBuckets = 121;           // prior/seed table rows
// the start tables hold 8 substates a bucket: other cfgs start at zero
constexpr bool kTableStart = kSub == 8;
// rev 2's contexts: 0, 1-4 exponent, 5-6 mantissa, 7 sign, one word a row;
// the kernels keep their rev-2 decision code for these, at either model and
// any cap below 64 (past it kernel 2's int32 value could overflow)
constexpr bool kRev2Layout =
    kELim == 4 && kRLim == 6 && kSignCtx == 7 && kSub == 8 && kMaxBins < 64;

static_assert(kSub >= 1 && kMaxBins >= 23, "config.check refuses this cfg");

// One context hash's row of the model.
struct Row {
  uint64_t w[kWords];
};

__device__ __forceinline__ Row load_row(const uint64_t* model, int h) {
  Row r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = model[h * kWords + i];
  return r;
}

__device__ __forceinline__ void store_row(uint64_t* model, int h,
                                          const Row& r) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) model[h * kWords + i] = r.w[i];
}

__device__ __forceinline__ Row zero_row() {
  Row r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = 0ull;
  return r;
}

// The state of substate c (any c in [0, kSub)) of a row held in registers:
// the word is picked by selects, not by an index, so the row stays there.
__device__ __forceinline__ uint32_t row_state(const Row& r, int c) {
  uint64_t w = r.w[0];
#pragma unroll
  for (int i = 1; i < kWords; ++i)
    if ((c >> 3) == i) w = r.w[i];
  return static_cast<uint32_t>(w >> (8 * (c & 7))) & 0xFF;
}

__device__ __forceinline__ void set_row_state(Row& r, int c, uint32_t st) {
  const int sh = 8 * (c & 7);
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    if ((c >> 3) == i)
      r.w[i] = (r.w[i] & ~(0xFFull << sh)) | (static_cast<uint64_t>(st) << sh);
}

// Contexts of a symbol's exponent decision k (k = 1 .. e + 1) and mantissa
// decision j (j = 0 .. e - 1, most significant bit first): config.exp_ctx
// and config.mant_ctx.
__device__ __forceinline__ int exp_ctx(int k) { return min(k, kELim); }
__device__ __forceinline__ int mant_ctx(int j) {
  return min(kELim + 1 + j, kRLim);
}

// Fill the models of lanes lane0 .. lane0 + n_lanes - 1 (rows 16-byte
// aligned), threads tid, tid + nt, ... of the block: word i of a lane's
// model (hash i / kWords) starts at s_init[(i / kWords) % kBuckets].  The
// stride keeps its caller's type (kernel 1's int constant, kernel 2's
// unsigned blockDim.x), so each rev-2 build compiles as it did before.
template <typename Stride>
__device__ __forceinline__ void fill_models(uint64_t* model,
                                            const uint64_t* s_init,
                                            int lane0, int n_lanes, int tid,
                                            Stride nt) {
  for (int l = 0; l < n_lanes; ++l) {
    ulonglong2* row2 = reinterpret_cast<ulonglong2*>(
        model + static_cast<size_t>(lane0 + l) * kRowWords);
    for (int h = tid; h < kRowWords / 2; h += nt)
      row2[h] = make_ulonglong2(s_init[(2 * h / kWords) % kBuckets],
                                s_init[((2 * h + 1) / kWords) % kBuckets]);
  }
}

}  // namespace
