// Kernel 2 of llcomp_tpu_torch: the decoder, one thread per lane, for every
// stripe geometry (any W * C, any C), built once a codec configuration
// (codec_cfg.cuh; rev 2 without defines).
//
// Replaces: llcomp_tpu/pallas/decode_kernel.py::_make_kernel_blocked and its
// per-symbol twin ::_make_kernel (both launched by _decode_groups_impl; they
// compute the same function).  Per lane: range-decode the lane's bytes, where
// any read at or past the lane's length gives 0 (llcomp.hpp:91-127); rebuild
// the samples in raster order with the reference's edge folds, context hash
// (three quant11 and two quant5 terms, sign fold) and median prediction; run
// getSymbol (llcomp.hpp:219-247) through the same 128-state model as encode.
// A sticky per-lane error flag is set when an exponent exceeds 31 or a symbol
// is still unfinished after 24 decisions (docs/COVERAGE.md:36-39).
//
// What bounds it on the H100: latency.  Every decision depends on the one
// before (range state and model), every symbol on its decoded neighbours,
// and the model word of a symbol sits at a hash of those neighbours: an
// 8-byte load from a 63,408-byte model a lane, past L2 at 1,024 lanes.
//
// What the design does about it: only the model load stays on the chain,
// and only where the format puts it there.
//  * Model words ahead, with forwarding: once sample s is known, the hash of
//    symbol s + C is (its l is sample s), so its model word is loaded C - 1
//    symbols before its use, into a ring of U slots (U = C for C <= 4; the
//    ring is unrolled, so each slot keeps its registers).  When a symbol
//    stores its word, every pending slot of the same hash takes that word,
//    as in kernel 1.  For C = 1 no word can be loaded early: a grayscale
//    symbol pays one load latency.
//  * Neighbours without loads on the chain: l and L (this lane's own last
//    samples of the channel) stay in the slot's registers; t, tl, tr and T
//    come from rows y-1 and y-2, finished before, and are loaded one ring
//    turn (U symbols) before the hash that needs them, into the slot's
//    registers.  Stripes too narrow for that (W * C < 2U + C) load them when
//    the hash is formed.  Edge folds and the int32 wrap (add32/sub32) are
//    the reference's.
//  * Templated on C in {1, 2, 3, 4}; any other C runs the generic
//    instantiation (CT = 0): a ring of 2 slots, l and L loaded a ring turn
//    ahead like the rows (C >= 5 keeps them two symbols old).
//  * A symbol's 8 state-table entries are looked up together when it starts
//    (Substates): a decision waits on a shared-memory lookup only when its
//    context repeats (4 and 6).
//  * Stream bytes 16 at a time: each lane keeps two aligned 16-byte words of
//    its row in registers, the next loaded a word ahead; a byte at or past
//    min(len, cap) reads 0, and nothing past the row's cap (a multiple of
//    16) is loaded.
//  * Lanes a block (lanes_a_block): one while that keeps at most
//    kWarpsPerSm blocks a SM, else the fewest that do.  A warp runs the
//    union of its lanes' decision paths, so at 1,024 lanes one lane a block
//    is fastest (2 and 32 ran 1.1x and 2.6x slower), while at 2,048 (15.5
//    one-lane blocks a SM) 2 lanes a block ran 1.2x faster than one
//    (chip_smoke.py phase 5 times copies of this file that force each).
//    Tables in shared memory; models start as in encode (zeros, or bucket
//    tab[h % 121]).
// Registers a thread (nvcc -Xptxas -v, sm_90a): 52 at C = 1, 88 at C = 2,
// 107 at C = 3, 123 at C = 4, 94 generic; no spills.
// Left for later: the decisions themselves, and C = 1's exposed load.
//
// Other codec configurations (codec_cfg.cuh): the small model's hash drops
// the two quant5 terms (kLargeModel), the error cap is kMaxBins, and the
// model row is a Row of ceil(substates / 8) words, loaded, forwarded and
// stored whole.  A cfg with rev 2's contexts (kRev2Layout) decodes with the
// Substates path; any other decodes each decision on its context's state
// read afresh from the row in registers (symbol_generic), since its
// contexts can repeat and alias.  There a decision whose context lies at or
// past kSub (only a corrupt stream reaches one: config.check keeps every
// context of a valid symbol inside) flags the lane and ends the symbol.
// Registers at C = 1, 2, 3, 4 and generic (sm_90a): 50, 69, 96, 116, 89 for
// the small model; 56, 77, 96, 115-116, 80 at e_lim 3 and at substates 4;
// 58, 87, 116, 128 (20 bytes spilled), 90 at substates 16.  At 1,024 lanes
// of 8x512x3 those builds ran 9.21, 10.72, 10.19 and 13.12 ms against rev
// 2's 10.18 (chip_smoke.py phase 12).
#include <cstdint>
#include <cuda_runtime.h>

#include "codec_cfg.cuh"

namespace {

constexpr int kMaxBlock = 32;      // lanes (threads) a block, at most
constexpr int kWarpsPerSm = 8;     // one-warp blocks a SM, at most, past one lane

// int32 arithmetic that wraps like the reference's (and XLA's) on overflow
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// A lane's stream bytes, read from two 16-byte words held in registers.
struct ByteStream {
  const uint4* src;   // the lane's row, 16-byte aligned
  int32_t lim;        // min(len, cap): bytes at or past it read 0
  int32_t pos = 0;
  uint4 cur, nxt;     // words pos/16 and pos/16 + 1

  __device__ __forceinline__ uint4 word(int i) const {
    return 16 * i < lim ? src[i] : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void start() {
    cur = word(0);
    nxt = word(1);
  }
  __device__ __forceinline__ int32_t byte() {
    const int i = pos & 15;
    const uint32_t w = i < 8 ? (i < 4 ? cur.x : cur.y)
                             : (i < 12 ? cur.z : cur.w);
    const int32_t b = pos < lim ? (w >> (8 * (i & 3))) & 0xFF : 0;
    if (++pos % 16 == 0) {
      cur = nxt;
      nxt = word(pos / 16 + 1);
    }
    return b;
  }
};

struct RangeDecoder {
  ByteStream in;
  int32_t low;
  int32_t rng = 0xFF00;

  // llcomp.hpp:99-127 (oracle.RangeDecoder.get), int32 state
  __device__ __forceinline__ int get(int32_t prob) {
    const int32_t range1 = (rng * prob) >> 8;
    const int32_t rng0 = rng - range1;
    int bit;
    if (low >= rng0) {
      low = sub32(low, rng0);
      rng = range1;
      bit = 1;
    } else {
      rng = rng0;
      bit = 0;
    }
    if (rng < 0x100) {
      rng <<= 8;
      low = static_cast<int32_t>((static_cast<uint32_t>(low) << 8) |
                                 static_cast<uint32_t>(in.byte()));
    }
    return bit;
  }
};

// A symbol's 8 substates (s[c], one byte each) and their state-table
// entries (f[c] = fused[s[c]]), looked up together when the symbol starts:
// a decision then waits on a shared-memory lookup only when its context
// repeats (4 and 6), after the bit that picks the next state.
struct Substates {
  uint32_t s[8], f[8];

  __device__ __forceinline__ Substates(uint64_t w, const int32_t* fused) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[c] = static_cast<uint32_t>(w >> (8 * c)) & 0xFF;
      f[c] = static_cast<uint32_t>(fused[s[c]]);
    }
  }
  __device__ __forceinline__ uint64_t word() const {
    const uint32_t lo = s[0] | s[1] << 8 | s[2] << 16 | s[3] << 24;
    const uint32_t hi = s[4] | s[5] << 8 | s[6] << 16 | s[7] << 24;
    return static_cast<uint64_t>(hi) << 32 | lo;
  }
  // Decode one bit on context C (a constant, so s and f stay in registers).
  template <int C>
  __device__ __forceinline__ int get(RangeDecoder& dec, const int32_t* fused) {
    const int bit = dec.get(static_cast<int32_t>(f[C] & 0xFF));
    s[C] = (f[C] >> (bit ? 16 : 8)) & 0xFF;
    if (C == 4 || C == 6) f[C] = static_cast<uint32_t>(fused[s[C]]);
    return bit;
  }
};

// getSymbol (llcomp.hpp:219-247) capped at kMaxBins decisions (24 for rev
// 2); `bad` is set on an exponent above 31 or an unfinished symbol.  The
// value returned on a bad symbol is the partial one, as in the JAX kernels'
// phase machine.  The exponent's contexts 1-3 are written out, so every
// context is a constant.
__device__ __forceinline__ int32_t symbol(RangeDecoder& dec, Substates& m,
                                          const int32_t* fused, int& bad) {
  if (m.get<0>(dec, fused)) return 0;
  int32_t value = 1;
  int e = 0;
  int steps = 2;                         // decisions made after the next
  if (m.get<1>(dec, fused)) {
    e = 1;
    ++steps;
    if (m.get<2>(dec, fused)) {
      e = 2;
      ++steps;
      if (m.get<3>(dec, fused)) {
        e = 3;
        for (;;) {
          if (steps == kMaxBins) { bad = 1; return value; }
          ++steps;
          if (!m.get<4>(dec, fused)) break;
          if (++e > 31) bad = 1;
        }
      }
    }
  }
  for (int j = 0; j < e; ++j) {
    if (steps == kMaxBins) { bad = 1; return value; }
    ++steps;
    value = 2 * value + (j == 0 ? m.get<5>(dec, fused) : m.get<6>(dec, fused));
  }
  if (steps == kMaxBins) { bad = 1; return value; }
  return m.get<7>(dec, fused) ? -value : value;
}

// One decision of any cfg on context ctx of row w.
__device__ __forceinline__ int get_generic(RangeDecoder& dec, Row& w, int ctx,
                                           const int32_t* fused) {
  const uint32_t f = static_cast<uint32_t>(fused[row_state(w, ctx)]);
  const int bit = dec.get(static_cast<int32_t>(f & 0xFF));
  set_row_state(w, ctx, (f >> (bit ? 16 : 8)) & 0xFF);
  return bit;
}

// getSymbol under any cfg, capped at kMaxBins decisions: contexts exp_ctx(k)
// and mant_ctx(j).  `bad` is set on an exponent above 31, an unfinished
// symbol, or a decision whose context lies past the row; the value returned
// on a bad symbol is the partial one (decode_plain's phase machine).  The
// value wraps as the reference's int32 arithmetic does.
__device__ __forceinline__ int32_t symbol_generic(RangeDecoder& dec, Row& w,
                                                  const int32_t* fused,
                                                  int& bad) {
  int steps = 0;
  // the next decision on context ctx into *bit, false where the symbol
  // stops short: its cap is spent or the context is past the row
  auto next = [&](int ctx, int* bit) {
    if (steps == kMaxBins || ctx >= kSub) {
      bad = 1;
      return false;
    }
    ++steps;
    *bit = get_generic(dec, w, ctx, fused);
    return true;
  };
  int bit;
  next(0, &bit);                         // kMaxBins >= 23, kSub >= 1
  if (bit) return 0;
  uint32_t value = 1;
  int e = 0;
  for (;;) {
    if (!next(exp_ctx(e + 1), &bit)) return static_cast<int32_t>(value);
    if (!bit) break;
    if (++e > 31) bad = 1;
  }
  for (int j = 0; j < e; ++j) {
    if (!next(mant_ctx(j), &bit)) return static_cast<int32_t>(value);
    value = 2 * value + bit;
  }
  if (!next(kSignCtx, &bit)) return static_cast<int32_t>(value);
  return static_cast<int32_t>(bit ? 0u - value : value);
}

__device__ __forceinline__ int32_t get_symbol(RangeDecoder& dec, Row& row,
                                              const int32_t* fused,
                                              int& bad) {
  if constexpr (!kRev2Layout) return symbol_generic(dec, row, fused, bad);
  uint64_t& w = row.w[0];
  Substates m(w, fused);
  const int32_t value = symbol(dec, m, fused, bad);
  w = m.word();
  return value;
}

__device__ __forceinline__ int32_t quant(const int32_t* tab, int32_t d) {
  return tab[max(-128, min(127, d)) & 0xFF];
}

// Raster position of a symbol: row y, column x, channel ch.
struct Pos {
  int y = 0, x = 0, ch = 0;
  __device__ __forceinline__ void advance(int C, int W) {
    if (++ch == C) {
      ch = 0;
      if (++x == W) { x = 0; ++y; }
    }
  }
};

// The neighbours of one symbol as loaded, before the edge folds.
struct Nb {
  int32_t l = 0, L = 0, t = 0, tl = 0, tr = 0, T = 0;
};

template <int CT>
struct Decoder {
  static constexpr int U = CT > 0 ? CT : 2;   // ring slots
  const int32_t* __restrict__ q11;
  const int32_t* __restrict__ q5;
  int32_t* p;          // this lane's planes: sample s at p[s * S]
  size_t S;
  int C, W, stride;

  // Load what symbol q at `at` needs of rows y-1, y-2 (and, generic, of its
  // own last samples): only inside the folds' conditions.
  __device__ __forceinline__ void load(Nb& nb, size_t q, Pos at) const {
    const size_t up = static_cast<size_t>(stride), cs = C;
    if (at.y > 0) {
      nb.t = p[(q - up) * S];
      if (at.x > 0) nb.tl = p[(q - up - cs) * S];
      if (at.x < W - 1) nb.tr = p[(q - up + cs) * S];
      if (at.y > 1) nb.T = p[(q - 2 * up) * S];
    }
    if (CT == 0) {
      if (at.x > 0) nb.l = p[(q - cs) * S];
      if (at.x > 1) nb.L = p[(q - 2 * cs) * S];
    }
  }

  // Edge folds, context hash and prediction of the symbol at `at` whose own
  // last samples are l, L: -> folded hash, and (pred, neg) for its value.
  __device__ __forceinline__ int hash(const Nb& nb, int32_t l_raw,
                                      int32_t L_raw, Pos at, int32_t& pred,
                                      bool& neg) const {
    const int32_t up_x = at.y > 0 ? nb.t : 0;
    const int32_t l = at.x > 0 ? l_raw : (at.y > 0 ? up_x : 128);
    const int32_t t = at.y > 0 ? up_x : l;
    const int32_t L = at.x > 1 ? L_raw : l;
    const int32_t tl = (at.y > 0 && at.x > 0) ? nb.tl : t;
    const int32_t tr = (at.y > 0 && at.x < W - 1) ? nb.tr : t;
    const int32_t T = at.y > 1 ? nb.T : t;
    int32_t h = quant(q11, sub32(l, tl)) + quant(q11, sub32(tl, t)) * 11
                + quant(q11, sub32(t, tr)) * 121;
    if (kLargeModel)         // summed in rev 2's order
      h = h + quant(q5, sub32(L, l)) * 605 + quant(q5, sub32(T, t)) * 3025;
    const int32_t grad = sub32(add32(l, t), tl);
    pred = max(min(l, t), min(max(l, t), grad));
    neg = h < 0;
    return neg ? -h : h;
  }
};

template <int CT>
__global__ void __launch_bounds__(kMaxBlock)
decode_kernel(const uint8_t* __restrict__ data,     // [S, cap]
              const int32_t* __restrict__ lens,     // [S]
              const int32_t* __restrict__ fused,    // [128]
              const int32_t* __restrict__ q11,      // [256]
              const int32_t* __restrict__ q5,       // [256]
              const uint64_t* __restrict__ init,    // [121] or null
              uint64_t* __restrict__ model,         // [S, kRowWords]
              int32_t* __restrict__ planes,         // [n_sym, S]
              int32_t* __restrict__ err,            // [S]
              int S, int cap, int H, int W, int C_rt) {
  constexpr int U = Decoder<CT>::U;
  __shared__ int32_t s_fused[128];
  __shared__ int32_t s_q11[256];
  __shared__ int32_t s_q5[256];
  __shared__ uint64_t s_init[kBuckets];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    if (i < 128) s_fused[i] = fused[i];
    s_q11[i] = q11[i];
    s_q5[i] = q5[i];
  }
  for (int i = threadIdx.x; i < kBuckets; i += blockDim.x)
    s_init[i] = kTableStart && init ? init[i] : 0ull;
  __syncthreads();

  const int lane0 = blockIdx.x * blockDim.x;
  const int n_lanes = min(static_cast<int>(blockDim.x), S - lane0);
  fill_models(model, s_init, lane0, n_lanes, threadIdx.x, blockDim.x);
  __syncthreads();

  const int lane = lane0 + threadIdx.x;
  if (lane >= S) return;
  uint64_t* row = model + static_cast<size_t>(lane) * kRowWords;
  const int C = CT > 0 ? CT : C_rt;
  Decoder<CT> g{s_q11, s_q5, planes + lane, static_cast<size_t>(S), C, W,
                W * C};
  const size_t n_sym = static_cast<size_t>(H) * W * C;
  // rows y-1 and y-2 of a symbol two ring turns ahead are finished
  const bool early = g.stride >= 2 * U + C;

  RangeDecoder dec;
  dec.in.src = reinterpret_cast<const uint4*>(data + static_cast<size_t>(lane)
                                              * cap);
  dec.in.lim = min(lens[lane], cap);
  dec.in.start();
  const int32_t b0 = dec.in.byte();
  dec.low = (b0 << 8) | dec.in.byte();

  // slot k holds symbol s (s % U == k): its hash hs, prediction and sign
  // fold, the word wl loaded for it, a forwarded word fw (valid when fv),
  // and nb, what the slot's next symbol (s + U) needs of the planes; own
  // (C <= 4) is the last sample of the slot's channel
  int hs[U];
  int32_t pred[U], own[U];
  bool neg[U], fv[U];
  Row wl[U], fw[U];
  Nb nb[U];
  Pos q_at, r_at;                  // positions of symbols s + U, s + 2U
#pragma unroll
  for (int k = 0; k < U; ++k) {    // symbols 0 .. U-1: row 0 or (generic)
    Pos at = q_at;                 // column 0, all folded
    if (static_cast<size_t>(k) < n_sym) {
      g.load(nb[k], k, at);
      hs[k] = g.hash(nb[k], nb[k].l, nb[k].L, at, pred[k], neg[k]);
      wl[k] = load_row(row, hs[k]);
    }
    fv[k] = false;
    fw[k] = zero_row();
    own[k] = 0;
    q_at.advance(C, W);
  }
  r_at = q_at;
#pragma unroll
  for (int k = 0; k < U; ++k) r_at.advance(C, W);
#pragma unroll
  for (int k = 0; k < U; ++k) {    // what symbols U .. 2U-1 need
    nb[k] = Nb();
    Pos at = q_at;
    for (int j = 0; j < k; ++j) at.advance(C, W);
    if (early && static_cast<size_t>(U + k) < n_sym) g.load(nb[k], U + k, at);
  }

  int bad = 0;
  for (size_t s0 = 0; s0 < n_sym; s0 += U) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const size_t s = s0 + k;
      if (s >= n_sym) break;
      const int h = hs[k];
      Row w = fv[k] ? fw[k] : wl[k];
      const int32_t value = get_symbol(dec, w, s_fused, bad);
      store_row(row, h, w);
#pragma unroll
      for (int j = 0; j < U; ++j) {       // forward to pending symbols
        if (j != k && hs[j] == h) {
          fw[j] = w;
          fv[j] = true;
        }
      }
      const int32_t sample = add32(pred[k], neg[k] ? -value : value);
      g.p[s * g.S] = sample;

      // slot k takes symbol q = s + U: its l is this sample (C <= 4)
      const size_t q = s + U;
      if (q < n_sym) {
        if (!early) g.load(nb[k], q, q_at);
        const int32_t l_raw = CT > 0 ? sample : nb[k].l;
        const int32_t L_raw = CT > 0 ? own[k] : nb[k].L;
        hs[k] = g.hash(nb[k], l_raw, L_raw, q_at, pred[k], neg[k]);
        fv[k] = false;
        wl[k] = load_row(row, hs[k]);
        if (early && q + U < n_sym) g.load(nb[k], q + U, r_at);
      }
      own[k] = sample;
      q_at.advance(C, W);
      r_at.advance(C, W);
    }
  }
  err[lane] = bad;
}

// Lanes a block for S lanes on the card that holds `data`, into *lanes:
// the smallest power of two (up to kMaxBlock) that keeps at most
// kWarpsPerSm blocks a SM.
cudaError_t lanes_a_block(int S, const void* data, int* lanes) {
  cudaPointerAttributes at;
  int sms = 0;
  cudaError_t e = cudaPointerGetAttributes(&at, data);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               at.device);
  *lanes = 1;
  while (*lanes < kMaxBlock && (S + *lanes - 1) / *lanes > kWarpsPerSm * sms)
    *lanes *= 2;
  return e;
}

template <int CT>
void launch(int S, int block, cudaStream_t st, const void* data,
            const void* lens, const void* fused, const void* q11,
            const void* q5, const void* init, void* model, void* planes,
            void* err, int cap, int H, int W, int C) {
  decode_kernel<CT><<<(S + block - 1) / block, block, 0, st>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(fused), static_cast<const int32_t*>(q11),
      static_cast<const int32_t*>(q5), static_cast<const uint64_t*>(init),
      static_cast<uint64_t*>(model), static_cast<int32_t*>(planes),
      static_cast<int32_t*>(err), S, cap, H, W, C);
}

}  // namespace

// cap a multiple of 16 and the data 16-byte aligned.  C in 1..4 runs its
// own instantiation, any other C >= 5 the generic one.  Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int llct_decode(const void* data, const void* lens,
                           const void* fused, const void* q11, const void* q5,
                           const void* init, void* model, void* planes,
                           void* err, int S, int cap, int H, int W, int C,
                           void* stream) {
  if (cap % 16 != 0 || C < 1 || reinterpret_cast<uintptr_t>(data) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0) return 0;
  int block;
  if (const cudaError_t e = lanes_a_block(S, data, &block); e != cudaSuccess)
    return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
#define LLCT_LAUNCH(CT)                                                     \
  launch<CT>(S, block, st, data, lens, fused, q11, q5, init, model, planes, \
             err, cap, H, W, C)
  switch (C) {
    case 1: LLCT_LAUNCH(1); break;
    case 2: LLCT_LAUNCH(2); break;
    case 3: LLCT_LAUNCH(3); break;
    case 4: LLCT_LAUNCH(4); break;
    default: LLCT_LAUNCH(0); break;
  }
#undef LLCT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
