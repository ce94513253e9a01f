// Kernel 3 of llcomp_tpu_torch: the sort chain's symbol walk, each lane (one
// independent rev-2 stream) cut at its context runs into kChunks pieces
// walked at once.
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_make_symwalk_kernel
// (walk_symbols, encode_kernels.py:175).  Input: each lane's symbols sorted
// by (context hash, position) (encode.stage_sym_sort), one int32 each,
// bucket<<14 | live<<13 | seg<<12 | diff+1274.  A context's symbols arrive
// together, so the lane's whole model is one row of 8 substates x 8 bits
// (two 32-bit registers, substates 0-3 and 4-7) that resets where seg is
// set: to zeros, or to the bucket's prior or seed row.  Before a lane's
// first seg the row is zeros.  For each live symbol the kernel regenerates
// its decisions (zero flag, unary exponent with ctx min(k, 4), stop,
// mantissa MSB first with ctx 5..6, sign with ctx 7; at most K), moves the
// row along the state table, and writes each decision's coder record
// valid<<9 | bit<<8 | prob.  Records are pair-packed, 10 bits each: quad q
// of symbol j holds records 4q, 4q+1 in lo[j*K/4 + q] and 4q+2, 4q+3 in
// hi[j*K/4 + q].  Records past a symbol's last decision, and every record
// of a dead symbol, are 0.
//
// What bounds it on the H100: the walk moves 4 B in a symbol and 8 B out a
// quad (554 MB at 1,024 lanes x 12,288 symbols and K 20, 165 us at 3.35
// TB/s); its integer work, ~20 operations a decision on ~5 decisions a
// symbol, is below that.  Walked as one chain a lane, as the TPU kernel
// walks it (a lane group there is one vector register), it is bound by
// latency instead: a dependent shared-memory lookup and row update a
// decision, branches that a warp's lanes take different ways, and 1,024
// lanes on 32 of the 132 SMs with one warp each.  Cut as below it is bound
// by its longest thread walk (L plus the longest piece, 1,124 symbols on
// the bench batch) at ~1.0-1.3 us a symbol: a warp codes the largest
// decision count of its 32 lanes' symbols (~4-5 quads), and the quads'
// stores, the lookups and the rest of the step each take a share
// (tools/torch_walk_copies.py: at one chunk a lane, copies without the
// stores, with an integer stand-in for the lookup or with the inputs'
// misses taken out ran 10.3-10.5, 10.7-10.9 and 11.7-11.9 ms against
// 12.6-12.7).
//
// What the design does about it:
// - The chain is cut.  The row resets to a state known without walking
//   (the bucket's reset row) at every seg, so a lane falls apart at its seg
//   bits into independent pieces.  Lane s is cut into kChunks chunks of
//   L = ceil(n / kChunks) symbols; chunk c's thread skips from c*L to the
//   first seg at or after it (chunk 0 starts at symbol 0 with a zero row)
//   and walks from there up to the first seg at or after (c+1)*L, or to n.
//   Every symbol is walked and written by exactly one thread; no thread
//   waits for another.  A thread's chain is at most L plus the lane's
//   longest piece.
// - One warp is one chunk of 32 neighbouring lanes, so each symbol's load
//   and each quad's store is one 128-byte line; kWarps warps a block, and
//   the grid over (lane groups x chunks) puts 2,048 warps on the 132 SMs at
//   1,024 lanes.  Lanes past S and threads past their chunk are masked.
// - The step is branch-free: a decision's context, bit and validity, the
//   row update (byte permutes) and the quad's records are selects, so a
//   warp's lanes never part ways.  A quad that no lane of the warp has a
//   decision in is skipped as a whole (a warp vote, the same way for every
//   lane) and stored as zeros; coding every quad ran 1.2-1.3x slower.
// - The inputs do not depend on the row: each thread keeps its next kDepth
//   symbols in flight in a register ring (the loop is unrolled by the
//   depth, so each slot keeps its register), and a thread whose chunk is
//   done loads nothing more.  A symbol past n loads as a seg, which ends
//   every walk.
// - The state table (prob | next0 << 8 | next1 << 16) and the 128 reset
//   rows sit in shared memory: the lanes of a warp read different entries,
//   which constant memory would serialise.
// Measured at 1,024 lanes x 12,288 symbols, K 20 (one H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 6, which times copies of this file built with
// other kChunks and kDepth beside it, each output equal to this one's):
// 21.4 ms as one chain a lane with branches, 1.32-1.45 ms as shipped;
// 12.5, 2.21, 1.57 and 1.54 ms at 1, 8, 16 and 32 chunks; 1.33, 1.42 and
// 1.54 ms at depths 1, 8 and 16 (a symbol's work outlasts its load).  The
// row update as shifts, masks and selects ran no faster than the byte
// permutes, and a state table copied a lane (no bank conflicts) no faster
// than one table.
//
// Other codec configurations (codec_cfg.cuh, built once a cfg): the above
// is rev 2's row and contexts, kept for every cfg with rev 2's contexts
// (kRev2Layout).  Any other holds the row as a Row of kWords 64-bit words
// (substate c in byte c % 8 of word c / 8) and reads each decision's state
// afresh from it, with contexts exp_ctx(k), mant_ctx(j) and kSignCtx: a
// symbol's decisions run in order, so one that shares its context with
// the decision before it (at 4 substates the mantissa and the sign share
// context 3) reads the state that decision wrote.  A run resets to its
// bucket's row only at 8 substates (kTableStart; the reset rows hold 8),
// else to zeros.
#include <cstdint>
#include <cuda_runtime.h>

#include "codec_cfg.cuh"

namespace {

constexpr int kChunks = 64;   // pieces a lane is cut into (C)
constexpr int kWarps = 4;     // warps a block, one chunk of 32 lanes each
constexpr int kDepth = 4;     // symbols in flight ahead of each chain (D)
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 128;    // reset rows, indexed by the 7-bit bucket field
constexpr int32_t kSeg = 1 << 12, kLive = 1 << 13;

// One decision on the row (rlo: substates 0-3, rhi: 4-7; registers named,
// not indexed, so they stay registers), moved only where `valid`: its
// record, 0 where not valid.  The row's chain is byte permutes: one reads
// substate ctx out of the 8 bytes {rhi:rlo}, and one a word puts the state
// table's next state for the bit (byte 1 + bit of f) over byte ctx & 3 of
// the word ctx is in; the selectors hang on ctx, bit and valid alone, off
// the chain.
__device__ __forceinline__ uint32_t decide(uint32_t& rlo, uint32_t& rhi,
                                           int ctx, uint32_t bit, bool valid,
                                           const int32_t* fused) {
  const uint32_t c = ctx & 3;
  const uint32_t put = valid ? ((5 + bit) ^ c) << (4 * c) : 0u;
  const uint32_t f = static_cast<uint32_t>(
      fused[__byte_perm(rlo, rhi, ctx) & 0xFF]);
  rlo = __byte_perm(rlo, f, 0x3210u ^ (ctx < 4 ? put : 0u));
  rhi = __byte_perm(rhi, f, 0x3210u ^ (ctx < 4 ? 0u : put));
  return valid ? 0x200u | (bit << 8) | (f & 0xFF) : 0u;
}

// One decision of any cfg on a Row in registers (row_state picks the word
// by selects), moved only where `valid`: its record, 0 where not valid.  A
// context past kSub (an invalid decision's) reads a state and writes none.
__device__ __forceinline__ uint32_t decide_row(Row& row, int ctx,
                                               uint32_t bit, bool valid,
                                               const int32_t* fused) {
  const uint32_t st = row_state(row, ctx);
  const uint32_t f = static_cast<uint32_t>(fused[st]);
  set_row_state(row, ctx, valid ? (f >> (bit ? 16 : 8)) & 0xFF : st);
  return valid ? 0x200u | (bit << 8) | (f & 0xFF) : 0u;
}

// A live symbol's residual d, |d| and e = floor(log2 |d|) (0 for d = 0),
// and its decision count (0 for a dead symbol).
struct Symbol {
  int d, e, nb;
  uint32_t ad;
  __device__ __forceinline__ explicit Symbol(int32_t x) {
    d = (x & 0xFFF) - 1274;
    ad = static_cast<uint32_t>(d < 0 ? -d : d);
    e = 31 - __clz(ad | 1);
    nb = (x & kLive) ? (ad ? 2 * e + 3 : 1) : 0;
  }

  // Decision k's record (binarize's slot k, transform.decision): zero flag
  // (k 0), exponent (1..e), stop (e+1), mantissa (e+2..2e+1), sign (2e+2).
  __device__ __forceinline__ uint32_t code(uint32_t& rlo, uint32_t& rhi,
                                           int k, const int32_t* fused) const {
    const bool mant = k > e + 1;
    int ctx = mant ? min(k - e + 3, 6) : min(k, 4);
    ctx = k == 2 * e + 2 ? 7 : ctx;
    uint32_t bit = k <= e;
    bit = mant ? (ad >> max(2 * e + 1 - k, 0)) & 1 : bit;
    bit = k == 2 * e + 2 ? d < 0 : bit;
    bit = k == 0 ? ad == 0 : bit;
    return decide(rlo, rhi, ctx, bit, k < nb, fused);
  }

  // The same decision under any cfg, on a Row: contexts exp_ctx(k) (the
  // stop too), mant_ctx(k - e - 2), kSignCtx, 0 for the zero flag.
  __device__ __forceinline__ uint32_t code(Row& row, int k,
                                           const int32_t* fused) const {
    const bool mant = k > e + 1;
    int ctx = mant ? mant_ctx(k - e - 2) : exp_ctx(k);
    ctx = k == 2 * e + 2 ? kSignCtx : ctx;
    ctx = k == 0 ? 0 : ctx;
    uint32_t bit = k <= e;
    bit = mant ? (ad >> max(2 * e + 1 - k, 0)) & 1 : bit;
    bit = k == 2 * e + 2 ? d < 0 : bit;
    bit = k == 0 ? ad == 0 : bit;
    return decide_row(row, ctx, bit, k < nb, fused);
  }
};

__global__ void __launch_bounds__(kWarps * kWarp)
walk_symbols_kernel(const int32_t* __restrict__ xs,      // [n, S]
                    const int32_t* __restrict__ fused,   // [128]
                    const uint64_t* __restrict__ rows,   // [128]
                    int32_t* __restrict__ lo,            // [n*K/4, S]
                    int32_t* __restrict__ hi,            // [n*K/4, S]
                    int n, int S, int K, int groups) {
  __shared__ int32_t s_fused[128];
  __shared__ uint64_t s_rows[kRows];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) s_fused[i] = fused[i];
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) s_rows[i] = rows[i];
  __syncthreads();

  const int w = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w >= groups * kChunks) return;                 // a whole warp
  const int c = w / groups;
  const int lane = (w % groups) * kWarp + threadIdx.x % kWarp;
  const int L = (n + kChunks - 1) / kChunks;
  const int first = c * L;                           // chunk c: [c*L, end)
  const int end = min(first + L, n);
  const int nq = K / 4;
  const size_t s = static_cast<size_t>(S);
  const int32_t* xl = xs + lane;                     // symbol j at xl[j * s]
  bool done = lane >= S || first >= n;
  auto load_x = [&](int j) -> int32_t {
    return !done && j < n ? xl[j * s] : kSeg;
  };
  int32_t xv[kDepth];                                // slot k: symbol j0 + k
#pragma unroll
  for (int k = 0; k < kDepth; ++k) xv[k] = load_x(first + k);
  bool on = c == 0;                                  // walking, not skipping
  uint32_t rlo = 0, rhi = 0;                         // rev 2's row
  Row row = zero_row();                              // any other cfg's
  for (int j0 = first; __any_sync(kFull, !done); j0 += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int j = j0 + k;
      const int32_t x = xv[k];
      const bool seg = x & kSeg;
      done = done || (j >= end && seg);              // the next chunk's
      on = on || seg;
      xv[k] = load_x(j + kDepth);                    // walked kDepth on
      const bool walk = on && !done;
      const uint64_t r = s_rows[(x >> 14) & 0x7F];
      if constexpr (kRev2Layout) {
        rlo = seg ? static_cast<uint32_t>(r) : rlo;
        rhi = seg ? static_cast<uint32_t>(r >> 32) : rhi;
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i)
          row.w[i] = seg ? (i == 0 && kTableStart ? r : 0ull) : row.w[i];
      }
      const Symbol sym(x);
      const int nb = walk ? sym.nb : 0;
      const size_t q0 = static_cast<size_t>(j) * nq;
      for (int q = 0; q < nq; ++q) {
        uint32_t qlo = 0, qhi = 0;
        if (__any_sync(kFull, 4 * q < nb)) {         // the same in a warp
          if constexpr (kRev2Layout) {
            qlo = sym.code(rlo, rhi, 4 * q, s_fused);
            qlo |= sym.code(rlo, rhi, 4 * q + 1, s_fused) << 10;
            qhi = sym.code(rlo, rhi, 4 * q + 2, s_fused);
            qhi |= sym.code(rlo, rhi, 4 * q + 3, s_fused) << 10;
          } else {
            qlo = sym.code(row, 4 * q, s_fused);
            qlo |= sym.code(row, 4 * q + 1, s_fused) << 10;
            qhi = sym.code(row, 4 * q + 2, s_fused);
            qhi |= sym.code(row, 4 * q + 3, s_fused) << 10;
          }
        }
        if (walk) {
          lo[(q0 + q) * s + lane] = static_cast<int32_t>(qlo);
          hi[(q0 + q) * s + lane] = static_cast<int32_t>(qhi);
        }
      }
    }
  }
}

}  // namespace

extern "C" int llct_walk_symbols(const void* xs, const void* fused,
                                 const void* rows, void* lo, void* hi, int n,
                                 int S, int K, void* stream) {
  if (K < 4 || K % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || n <= 0) return 0;
  const int groups = (S + kWarp - 1) / kWarp;
  const int grid = (groups * kChunks + kWarps - 1) / kWarps;
  walk_symbols_kernel<<<grid, kWarps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(fused),
      static_cast<const uint64_t*>(rows), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), n, S, K, groups);
  return static_cast<int>(cudaGetLastError());
}
