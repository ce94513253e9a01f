// Kernel 1 of llcomp_tpu_torch: the fused stream-order encoder, one thread
// per lane (one lane = one independent stream), built once a codec
// configuration (codec_cfg.cuh; rev 2 without defines).
//
// Replaces: llcomp_tpu/pallas/encode_fused.py::_make_fused_kernel (launched
// by _encode_fused_groups).  Computes, per lane and in stream order, what
// oracle.encode_planes (oracle.py:330-362) specifies: for each live symbol,
// up to 24 binary decisions (zero flag, unary exponent, stop, mantissa MSB
// first, sign) through the 128-state adaptive model and the carry-less range
// coder with lazy carries (llcomp.hpp:38-81), then the two forced shifts of
// finish() with the last pending byte dropped.
//
// What bounds it on the H100: latency, not bandwidth.  Each lane is a serial
// chain of dependent decisions (26-32 ns each), and a warp runs the union of
// its lanes' decisions.  Bytes moved are small: 4 B of input and ~0.45 B of
// output a symbol plus one 8-byte model word at a data-dependent hash; the
// model (63,408 B a lane) is past L2 at 1,024 lanes, so a load costs
// 0.4-0.65 us, 3-4x a symbol's decisions.
//
// What the design does about it: no global load sits on a lane's chain.
//  * Symbols ahead, in registers: the packed word of symbol i+2D is loaded
//    while symbol i codes (a per-thread register ring over the
//    symbol-major [n_sym, S] input).  A block-wide shared-memory tile would
//    need a barrier between lanes that code at different speeds, and at one
//    lane a block has no lanes to share; the register ring needs neither.
//  * Model words ahead, with forwarding: a ring of D slots holds the words
//    of symbols i..i+D-1, each loaded D symbols before its use from the
//    hash its packed word names.  When symbol i stores its updated word,
//    every pending slot of the same hash takes that word in place of what
//    it loaded, so each symbol codes with exactly the word a sequential
//    walk reads (in flat regions the hash repeats every symbol).  The loop
//    is unrolled by D, so each slot keeps its registers: a register that a
//    load is still filling is read only when its symbol codes.  Dead
//    symbols (live bit clear) hold hash -1, load and store nothing and
//    code no decision.  D = 2 (kDepth): at 1,024 lanes D = 4 and D = 8 ran
//    1.7x and 2.1x slower (72 and 108 registers against 54; chip_smoke.py
//    phase 5 times copies of this file built with each).
//  * A symbol's 8 state-table entries are looked up together when it starts
//    (Substates): a decision then waits on a shared-memory lookup only when
//    its context repeats (4 and 6), and the model chain leaves the coder's.
//  * Bytes out a word at a time: the coder collects bytes in a register and
//    stores 32 bits when the word is full (outcap is a multiple of 4, so
//    rows stay aligned); a byte past outcap is not written and the lane's
//    overflow flag (pos > outcap at the end) is set.
//  * One lane a block (kBlock): a warp runs the union of its lanes'
//    divergent decision paths, so each lane gets a warp of its own; at
//    1,024 lanes 2 and 32 lanes a block ran 1.2x and 3.3x slower than one,
//    and at 2,048 lanes 2 a block tied with one.
//  * The state table (prob | next0 << 8 | next1 << 16) sits in shared
//    memory; a block initialises its lanes' models with 16-byte stores:
//    zeros, or bucket tab[h % 121] (static prior or stored seed).
// Registers a thread (nvcc -Xptxas -v, sm_90a): 54; no spills.
// Left for later: the decisions themselves, ~60% of a symbol's time at
// 1,024 lanes (chip_smoke.py phase 5 times this kernel with each symbol's
// decisions cut out), e.g. by splitting the model walk and the range coder
// into two warps.
//
// Other codec configurations (codec_cfg.cuh): the model row is a Row of
// ceil(substates / 8) words, each loaded, forwarded and stored whole, and
// the small model's 666 hashes shrink it.  A cfg with rev 2's contexts
// (kRev2Layout) codes with the Substates path above.  Any other codes each
// decision on its context's state read afresh from the row in registers
// (code_generic): its contexts can repeat and alias (the mantissa and the
// sign share one at substates 4), so no state-table entry is looked up
// ahead.  Registers (sm_90a): 54 for the small model, 44 at e_lim 3 and at
// substates 4, 52 at substates 16; at 1,024 lanes of 8x512x3 those builds
// ran 8.76, 9.58, 9.30 and 12.49 ms against rev 2's 9.52 (chip_smoke.py
// phase 12).
#include <cstdint>
#include <cuda_runtime.h>

#include "codec_cfg.cuh"

namespace {

constexpr int kBlock = 1;          // lanes (threads) a block
constexpr int kDepth = 2;          // model words in flight a lane

struct Coder {
  uint32_t low = 0;
  uint32_t rng = 0xFF00;
  int32_t pend = -1;  // byte awaiting carry resolution, -1 before the first
  uint32_t run = 0;   // deferred bytes after it
  int32_t pos = 0;    // bytes emitted so far
  uint32_t acc = 0;   // bytes 4*(pos/4) .. pos-1, little-endian
  uint32_t* out;      // the lane's row, as words
  int32_t outcap;     // a multiple of 4

  __device__ __forceinline__ void store_word() {
    const int wi = (pos - 1) >> 2;
    if (4 * wi < outcap) out[wi] = acc;
    acc = 0;
  }

  __device__ __forceinline__ void put_byte(uint32_t b) {
    acc |= (b & 0xFF) << (8 * (pos & 3));
    ++pos;
    if ((pos & 3) == 0) store_word();
  }

  // llcomp.hpp:38-58 (oracle.RangeEncoder._shift)
  __device__ __forceinline__ void shift() {
    if (pend < 0) {
      pend = static_cast<int32_t>(low >> 8);
    } else if (low <= 0xFF00u) {           // no carry: pending + 0xFF run
      put_byte(pend);
      for (; run; --run) put_byte(0xFF);
      pend = static_cast<int32_t>(low >> 8);
    } else if (low >= 0x10000u) {          // carry: pending + 1, 0x00 run
      put_byte(pend + 1);
      for (; run; --run) put_byte(0x00);
      pend = static_cast<int32_t>((low >> 8) & 0xFF);
    } else {                               // top byte 0xFF: defer
      ++run;
    }
    low = (low & 0xFF) << 8;
    rng <<= 8;
  }

  __device__ __forceinline__ void put(uint32_t bit, uint32_t prob) {
    const uint32_t range1 = (rng * prob) >> 8;
    if (bit) {
      low += rng - range1;
      rng = range1;
    } else {
      rng -= range1;
    }
    if (rng < 0x100) shift();
  }

  // llcomp.hpp:75-81: low += 0xFF, two forced shifts, pending byte dropped;
  // then the last partial word
  __device__ __forceinline__ void finish() {
    low += 0xFF;
    shift();
    shift();
    if (pos & 3) store_word();
  }
};

// A symbol's 8 substates (s[c], one byte each) and their state-table
// entries (f[c] = fused[s[c]], prob | next0 << 8 | next1 << 16).  The 8
// entries are looked up together when the symbol starts, so a decision on a
// context not yet used in this symbol finds its entry ready; only contexts 4
// and 6, which repeat, look up the next entry after each decision.
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
  // Code `bit` on context C (a constant, so s and f stay in registers).
  template <int C>
  __device__ __forceinline__ void code(Coder& c, uint32_t bit,
                                       const int32_t* fused) {
    c.put(bit, f[C] & 0xFF);
    s[C] = (f[C] >> (bit ? 16 : 8)) & 0xFF;
    if (C == 4 || C == 6) f[C] = static_cast<uint32_t>(fused[s[C]]);
  }
};

// One decision of any cfg: `bit` on context ctx of row w.
__device__ __forceinline__ void code_generic(Coder& c, Row& w, int ctx,
                                             uint32_t bit,
                                             const int32_t* fused) {
  const uint32_t f = static_cast<uint32_t>(fused[row_state(w, ctx)]);
  c.put(bit, f & 0xFF);
  set_row_state(w, ctx, (f >> (bit ? 16 : 8)) & 0xFF);
}

// A live symbol's decisions (packed word x) on its model row `w`: zero
// flag (ctx 0); e exponent ones and a stop (ctx exp_ctx(k) for k =
// 1..e+1); e mantissa bits MSB first (ctx mant_ctx(j)); sign (kSignCtx).
// Rev 2's contexts: min(k, 4), then 5 and 6, and 7.
__device__ __forceinline__ void code_symbol(Coder& c, Row& row, int32_t x,
                                            const int32_t* fused) {
  const int d = (x & 0xFFF) - 1274;      // folded residual
  if constexpr (!kRev2Layout) {
    code_generic(c, row, 0, d == 0, fused);
    if (d != 0) {
      const uint32_t ad = static_cast<uint32_t>(d < 0 ? -d : d);
      const int e = 31 - __clz(ad);
      for (int k = 1; k <= e + 1; ++k)
        code_generic(c, row, exp_ctx(k), k <= e, fused);
      for (int j = 0; j < e; ++j)
        code_generic(c, row, mant_ctx(j), (ad >> (e - 1 - j)) & 1, fused);
      code_generic(c, row, kSignCtx, d < 0, fused);
    }
    return;
  }
  uint64_t& w = row.w[0];
  Substates m(w, fused);
  m.code<0>(c, d == 0, fused);
  if (d != 0) {
    const uint32_t ad = static_cast<uint32_t>(d < 0 ? -d : d);
    const int e = 31 - __clz(ad);        // floor(log2 |d|)
    m.code<1>(c, e >= 1, fused);
    if (e >= 1) m.code<2>(c, e >= 2, fused);
    if (e >= 2) m.code<3>(c, e >= 3, fused);
    for (int k = 4; k <= e + 1 && e >= 3; ++k) m.code<4>(c, k <= e, fused);
    if (e >= 1) m.code<5>(c, (ad >> (e - 1)) & 1, fused);
    for (int j = 1; j < e; ++j) m.code<6>(c, (ad >> (e - 1 - j)) & 1, fused);
    m.code<7>(c, d < 0, fused);
  }
  w = m.word();
}

// The folded hash of a packed word, -1 for a dead symbol.
__device__ __forceinline__ int hash_of(int32_t x) {
  return (x & (1 << 25)) ? (x >> 12) & 0x1FFF : -1;
}

__global__ void __launch_bounds__(kBlock)
encode_fused_kernel(const int32_t* __restrict__ xs,       // [n_sym, S]
                    const int32_t* __restrict__ fused,    // [128]
                    const uint64_t* __restrict__ init,    // [121] or null
                    uint64_t* __restrict__ model,         // [S, kRowWords]
                    uint8_t* __restrict__ out,            // [S, outcap]
                    int32_t* __restrict__ lens,           // [S]
                    int32_t* __restrict__ ovf,            // [S]
                    int n_sym, int S, int outcap) {
  __shared__ int32_t s_fused[128];
  __shared__ uint64_t s_init[kBuckets];
  for (int i = threadIdx.x; i < 128; i += kBlock) s_fused[i] = fused[i];
  for (int i = threadIdx.x; i < kBuckets; i += kBlock)
    s_init[i] = kTableStart && init ? init[i] : 0ull;
  __syncthreads();

  constexpr int D = kDepth;
  const int lane0 = blockIdx.x * kBlock;
  const int n_lanes = min(kBlock, S - lane0);
  fill_models(model, s_init, lane0, n_lanes, threadIdx.x, kBlock);
  __syncthreads();

  const int lane = lane0 + threadIdx.x;
  if (lane >= S) return;
  uint64_t* row = model + static_cast<size_t>(lane) * kRowWords;
  const int32_t* xl = xs + lane;          // symbol i at xl[i * S]
  auto load_x = [&](int i) -> int32_t {
    return i < n_sym ? xl[static_cast<size_t>(i) * S] : 0;
  };
  Coder c;
  c.out = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(lane) * outcap);
  c.outcap = outcap;

  // slot k holds symbol i (i % D == k): its packed word xv, hash hs, the
  // word wl loaded for it, a forwarded word fw (valid when fv); xa is the
  // packed word of symbol i + D, in flight
  int32_t xv[D], xa[D];
  int hs[D];
  Row wl[D], fw[D];
  bool fv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xv[k] = load_x(k);
    hs[k] = hash_of(xv[k]);
    wl[k] = hs[k] >= 0 ? load_row(row, hs[k]) : zero_row();
    fv[k] = false;
    fw[k] = zero_row();
    xa[k] = load_x(D + k);
  }

  for (int i0 = 0; i0 < n_sym; i0 += D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int h = hs[k];
      if (h >= 0) {
        Row w = fv[k] ? fw[k] : wl[k];
        code_symbol(c, w, xv[k], s_fused);
        store_row(row, h, w);
#pragma unroll
        for (int j = 0; j < D; ++j) {      // forward to pending symbols
          if (j != k && hs[j] == h) {
            fw[j] = w;
            fv[j] = true;
          }
        }
      }
      // slot k takes symbol i + D, whose word was loaded D symbols ago
      xv[k] = xa[k];
      hs[k] = hash_of(xv[k]);
      fv[k] = false;
      if (hs[k] >= 0) wl[k] = load_row(row, hs[k]);
      xa[k] = load_x(i0 + k + 2 * D);
    }
  }
  c.finish();
  lens[lane] = c.pos;
  ovf[lane] = c.pos > outcap;
}

}  // namespace

// outcap a multiple of 4.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an outcap the kernel does not take.
extern "C" int llct_encode_fused(const void* xs, const void* fused,
                                 const void* init, void* model, void* out,
                                 void* lens, void* ovf, int n_sym, int S,
                                 int outcap, void* stream) {
  if (outcap % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0) return 0;
  const int grid = (S + kBlock - 1) / kBlock;
  encode_fused_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(fused),
      static_cast<const uint64_t*>(init), static_cast<uint64_t*>(model),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(lens),
      static_cast<int32_t*>(ovf), n_sym, S, outcap);
  return static_cast<int>(cudaGetLastError());
}
