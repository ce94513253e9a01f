// Kernels 4, 7 and 8 of llcomp_tpu_torch: the sort chain's range coders
// (one lane = one independent rev-2 stream).
//
// Replaces, in llcomp_tpu/pallas/encode_kernels.py:
//   kernel 4  _coder_kernel_off_q (coder_scan_off_q, encode_kernels.py:574),
//             the symbol variant's coder;
//   kernel 7  _coder_kernel_off (coder_scan_off, encode_kernels.py:475), the
//             decision variant's coder;
//   kernel 8  _coder_kernel (coder_scan, encode_kernels.py:416), the
//             slot-record coder.
// Input: each lane's coder records in stream order, 10 bits each
// (valid<<9 | bit<<8 | prob), lane-minor [T, S].  Kernel 4 reads them
// pair-packed (quad t holds records 4t, 4t+1 in qlo[t] and 4t+2, 4t+3 in
// qhi[t]; dead quads are 0, encode.stage_compact); kernels 7 and 8 one per
// word (dead records 0, encode.stage_back_sort).  For every record they run
// the carry-less range coder with lazy carries (llcomp.hpp:38-73) in int32.
//
// Kernels 4 and 7 write one offset-packed byte record per decision,
// off<<9 | carry<<8 | head, where a shift flushes the pending byte (off: its
// position in the lane's stream; the deferred bytes after it are 0x00 on a
// carry, 0xFF otherwise), and 0x7FFFFFFF elsewhere; at the end the final low,
// rng, pend, run and off (fin [5, S]), from which coder.finish_steps_off
// makes the two flush records and the stream length.  A byte offset of 2^22
// or more, where off<<9 would leave int32, sets the lane's error flag; the
// wrapper raises.  Kernel 8 writes every step's slot record instead,
// meta = emit | carry<<1 | head<<8 and the deferred run before the step
// (runs), emitting or not, and the final low, rng, pend and run (fin [4, S]);
// coder.finish_steps and coder.expand_slots turn them into bytes.
//
// What bounds them on the H100: each lane is one serial chain of multiply,
// compare and shift per record; bytes moved are 2 to 4 B in and 4 to 8 B
// out per record, coalesced (lane-minor arrays), and 1,024 lanes put only
// 32 blocks in flight, one an SM.  A warp alone on its SM hides nothing
// for another: it waits out its own loads, issues its own instructions,
// and a branch around a store cuts its unrolled body into blocks that do
// not overlap.  A ring of loads in registers hides the loads only in part.
//
// What the design does about it.  The coder state is a few registers, no
// memory is touched but the records in and out, and the three kernels share
// one branch-free step (coder_code, then coder_shift): a warp's lanes take
// a branch different ways.
// - Kernel 7, one warp a block: each lane holds a ring of kOffDepth records
//   in registers, loaded kOffDepth steps before they are coded (the loop is
//   unrolled by the depth, so each slot keeps its register); a record past
//   T loads as 0, which codes nothing.
// - Kernels 4 and 8, two warps a block of 32 lanes, the step split where it
//   forks: rng depends only on rng and the record, low on rng, and the rest
//   on low.  The rng warp copies its lanes' input into shared memory
//   (cp.async: no register held in flight, one wait a batch), kInStages
//   batches of kBatch records ahead, runs coder_code on rng alone (7
//   dependent instructions a record) and hands each record's word, what
//   low gains | shift << 16, to the other warp through a shared ring of
//   kStages batches under named barriers.  The other warp keeps the state
//   but rng (Low), adds the gain to low and runs low_shift and the record
//   out, each store one predicated instruction.
// Measured on one H100 80GB HBM3 at 700 W (tools/torch_coder_copies.py,
// copies of this file in turns, on the bench batch's records: 1,024 lanes x
// 21,695 quads for kernel 4, x 61,696 records for kernels 7 and 8): kernel
// 7 5.7-6.1 ms, as its parent; kernels 4 and 8 2.70-2.73 and 2.68-2.72 ms,
// from 11.6 and 15.5 loading each record on the chain; kernel 7's register
// ring on them took 6.0 and 4.4 ms at its best depths (8 quads, 16
// records).  The split's rng warp takes 23-28 instructions a record, the
// other warp 34-37; kernel 7's loop 54.  Neither cached inputs nor dropped
// stores move kernels 4 and 8 by more than 3%; with a branch around each
// store kernel 4's other warp took 5.2 ms, and with register rings in the
// rng warp kernel 8 took 5.5.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;                  // kernel 7: lanes per block
constexpr int kOffDepth = 8;                // kernel 7: records in flight
constexpr int kWarp = 32;                   // kernels 4 and 8: lanes a block
constexpr int kBatch = 32;                  // records a hand-over
constexpr int kStages = 4;                  // batches in the hand-over ring
constexpr int kInStages = 4;                // batches of input landing
constexpr int32_t kSilent = 0x7FFFFFFF;     // no byte flushed
constexpr int32_t kOffLimit = 1 << 22;      // keeps off<<9 in int32
constexpr int kFull = 1, kEmpty = 1 + kStages;  // named barrier ids
static_assert(kBatch % 4 == 0 && kInStages >= 2, "whole quads, a stage ahead");
static_assert(kEmpty + kStages <= 16, "16 named barriers a block");

// The coder's state but rng: all that the other warp of kernels 4 and 8
// keeps.
struct Low {
  int32_t low = 0;
  int32_t pend = -1;  // byte awaiting carry resolution, -1 before the first
  int32_t run = 0;    // deferred bytes after it
};

struct Coder : Low {
  int32_t rng = 0xFF00;
};

// Kernels 4 and 7: where the next byte record lands.
struct Off {
  int32_t off = 0;    // bytes flushed so far: the next head's offset
  int32_t bad = 0;    // sticky: an offset reached kOffLimit
};

// What a renormalising shift flushes if it emits: the pending byte plus
// carry (head) followed by run bytes of 0x00 (carry) or 0xFF.  Read before
// the shift; the slot records hold it on every step.
struct Flush {
  uint32_t carry;
  uint32_t head;
  int32_t run;
};

__device__ __forceinline__ Flush flush_of(const Low& c) {
  const uint32_t carry = c.low >= 0x10000;        // pending + 1, 0x00 run
  return {carry, (static_cast<uint32_t>(c.pend) + carry) & 0xFF, c.run};
}

// The put of one record valid<<9 | bit<<8 | prob (llcomp.hpp:60-73,
// encode_kernels.py:427-437): true where the renormalising shift follows.
// Selects, not branches, as in low_shift (the note above says why).
__device__ __forceinline__ bool coder_code(Coder& c, int32_t x) {
  const bool valid = x & 0x200, one = x & 0x100;
  const int32_t range1 = (c.rng * (x & 0xFF)) >> 8;
  c.low = valid && one ? c.low + c.rng - range1 : c.low;
  c.rng = valid ? (one ? range1 : c.rng - range1) : c.rng;
  return valid && c.rng < 0x100;
}

// The renormalising shift with lazy carries (llcomp.hpp:38-58,
// encode_kernels.py:439-457) on the state but rng, done where `shift` is
// true: true where it emits (flushes the pending byte and its run, as
// flush_of read them before the shift).  The first shift only sets the
// pending byte; a top byte of 0xFF defers.
__device__ __forceinline__ bool low_shift(Low& c, bool shift) {
  const bool first = c.pend < 0;
  const bool resolved = c.low <= 0xFF00 || c.low >= 0x10000;
  const bool emit = shift && !first && resolved;
  const bool defer = shift && !first && !resolved;
  c.pend = shift && !defer ? (c.low >> 8) & 0xFF : c.pend;
  c.run = emit ? 0 : c.run + defer;
  c.low = shift ? (c.low & 0xFF) << 8 : c.low;
  return emit;
}

// The whole shift: low_shift, and rng (< 0x100 where `shift`) up a byte.
__device__ __forceinline__ bool coder_shift(Coder& c, bool shift) {
  const bool emit = low_shift(c, shift);
  c.rng = shift ? c.rng << 8 : c.rng;
  return emit;
}

// The offset-packed byte record of a step of kernels 4 and 7
// (encode_kernels.py:512-518), from its flush and emit.
__device__ __forceinline__ int32_t off_record(Off& o, Flush f, bool emit) {
  o.bad |= emit && o.off >= kOffLimit;
  const int32_t rec = static_cast<int32_t>(
      (static_cast<uint32_t>(o.off) << 9) | (f.carry << 8) | f.head);
  o.off += emit ? 1 + f.run : 0;
  return emit ? rec : kSilent;
}

// The meta word of a step of kernel 8, from its flush and emit.
__device__ __forceinline__ int32_t slot_meta(Flush f, uint32_t emit) {
  return static_cast<int32_t>(emit | (f.carry << 1) | (f.head << 8));
}

// One step of kernel 7: its offset-packed byte record.
__device__ __forceinline__ int32_t coder_put(Coder& c, Off& o, int32_t x) {
  const bool shift = coder_code(c, x);
  const Flush f = flush_of(c);
  return off_record(o, f, coder_shift(c, shift));
}

// The split step.  The rng warp runs coder_code on rng alone (low from 0:
// it comes out as what low gains, < 2^16 as rng < 2^16) and the shift of
// rng, and hands over one word, gain | shift << 16; the other warp adds the
// gain to its low and runs low_shift.
__device__ __forceinline__ uint32_t rng_put(int32_t& rng, int32_t x) {
  Coder c;
  c.rng = rng;
  const bool shift = coder_code(c, x);
  rng = shift ? c.rng << 8 : c.rng;
  return static_cast<uint32_t>(c.low) | static_cast<uint32_t>(shift) << 16;
}

// The other warp's half: -> emit; f as flush_of read it before the shift.
__device__ __forceinline__ bool low_put(Low& c, uint32_t w, Flush& f) {
  c.low += static_cast<int32_t>(w & 0xFFFF);
  f = flush_of(c);
  return low_shift(c, w >> 16);
}

// Record j (0..3) of a pair-packed quad (qlo, qhi).
__device__ __forceinline__ int32_t quad_record(int32_t a, int32_t b, int j) {
  return ((j < 2 ? a : b) >> (j & 1 ? 10 : 0)) & 0x3FF;
}

// The final state but rng (low, pend, run) into fin [4 or 5, S].
__device__ __forceinline__ void store_fin(const Low& c, int32_t* fin,
                                          size_t s, int lane) {
  fin[lane] = c.low;
  fin[2 * s + lane] = c.pend;
  fin[3 * s + lane] = c.run;
}

__device__ __forceinline__ void store_fin_off(const Low& c, const Off& o,
                                              int32_t* fin, int32_t* bad,
                                              size_t s, int lane) {
  store_fin(c, fin, s, lane);
  fin[4 * s + lane] = o.off;
  bad[lane] = o.bad;
}

// The split's hand-over between a block's two warps: the rng warp fills a
// stage of the shared ring and arrives on its full barrier; the other warp
// waits there, reads the stage and arrives on its empty barrier, which the
// rng warp waits on before it fills the stage again.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * kWarp) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * kWarp) : "memory");
}

// The rng warp's input: each thread copies its lane's words of a batch's
// rows into shared memory (cp.async, no register held while in flight),
// kInStages batches ahead of the batch it codes; a word past the input
// lands as 0, which codes nothing.
__device__ __forceinline__ void copy_word(int32_t* dst, const int32_t* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The rng warp of a split kernel over n records in nb batches: issue(b)
// starts batch b's copies (nothing past nb), row(slot, r) reads row r of
// the landed batch in input slot `slot`, and its record j is rec(row, j),
// kPer records a row.  -> the final rng.
template <int kPer, typename Issue, typename Row, typename Rec>
__device__ __forceinline__ int32_t rng_warp(
    uint32_t (*ring)[kBatch][kWarp], int l, int nb, Issue issue, Row row,
    Rec rec) {
#pragma unroll
  for (int b = 0; b < kInStages - 1; ++b) {
    issue(b);
    copy_commit();
  }
  int32_t rng = 0xFF00;
  for (int b = 0; b < nb; ++b) {
    issue(b + kInStages - 1);
    copy_commit();
    copy_wait<kInStages - 1>();            // batch b has landed
    const int st = b % kStages;
    if (b >= kStages) bar_sync(kEmpty + st);
#pragma unroll
    for (int r = 0; r < kBatch / kPer; ++r) {
      const auto v = row(b % kInStages, r);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        ring[st][kPer * r + j][l] = rng_put(rng, rec(v, j));
    }
    bar_arrive(kFull + st);
  }
  return rng;
}

// A store where `ok`, as one predicated instruction: a branch around it
// would cut the unrolled body into a block a record.
__device__ __forceinline__ void store_if(int32_t* p, int32_t v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.b32 [%0], %1;\n}" ::"l"(p),
      "r"(v), "r"(static_cast<uint32_t>(ok)));
}

// The other warp of a split kernel over n records in nb batches: put(in,
// w) codes the next record's word, a record of the input where `in` (past
// n it codes nothing, and stores nothing).  put moves its output pointers
// on a row whatever `in` is and stores with store_if.
template <typename PutFn>
__device__ __forceinline__ void low_warp(uint32_t (*ring)[kBatch][kWarp],
                                         int l, int n, int nb, PutFn put) {
  for (int b = 0; b < nb; ++b) {
    const int st = b % kStages;
    const int left = n - b * kBatch;       // records of the input left
    bar_sync(kFull + st);
#pragma unroll 8
    for (int k = 0; k < kBatch; ++k) put(k < left, ring[st][k][l]);
    if (b + kStages < nb) bar_arrive(kEmpty + st);
  }
}

struct Quad {
  int32_t lo, hi;
};

__global__ void __launch_bounds__(2 * kWarp)
coder_scan_off_q_kernel(const int32_t* __restrict__ qlo,   // [Tq, S]
                        const int32_t* __restrict__ qhi,   // [Tq, S]
                        int32_t* __restrict__ kp,          // [4*Tq, S]
                        int32_t* __restrict__ fin,         // [5, S]
                        int32_t* __restrict__ bad,         // [S]
                        int Tq, int S) {
  constexpr int kRows = kBatch / 4;         // quads a batch
  __shared__ uint32_t ring[kStages][kBatch][kWarp];
  __shared__ int32_t in[kInStages][kRows][2][kWarp];
  const int l = threadIdx.x % kWarp;
  const int lane = blockIdx.x * kWarp + l;
  const bool live = lane < S;               // every thread meets the barriers
  const size_t s = static_cast<size_t>(S);
  const int n = 4 * Tq;
  const int nb = (n + kBatch - 1) / kBatch;
  if (threadIdx.x < kWarp) {
    const int32_t rng = rng_warp<4>(
        ring, l, nb,
        [&](int b) {
          if (b >= nb) return;
          const size_t at = static_cast<size_t>(b) * kRows * s + lane;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const bool ok = live && b * kRows + r < Tq;
            const size_t i = ok ? at + r * s : 0;
            copy_word(&in[b % kInStages][r][0][l], qlo + i, ok);
            copy_word(&in[b % kInStages][r][1][l], qhi + i, ok);
          }
        },
        [&](int slot, int r) {
          return Quad{in[slot][r][0][l], in[slot][r][1][l]};
        },
        [](Quad q, int j) { return quad_record(q.lo, q.hi, j); });
    if (live) fin[s + lane] = rng;
  } else {
    Low c;
    Off o;
    int32_t* kl = kp + lane;                // the next record's
    low_warp(ring, l, n, nb, [&](bool in, uint32_t w) {
      Flush f;
      const bool emit = low_put(c, w, f);
      store_if(kl, off_record(o, f, emit), live && in);
      kl += s;
    });
    if (live) store_fin_off(c, o, fin, bad, s, lane);
  }
}

__global__ void __launch_bounds__(kBlock)
coder_scan_off_kernel(const int32_t* __restrict__ xs,      // [T, S]
                      int32_t* __restrict__ kp,            // [T, S]
                      int32_t* __restrict__ fin,           // [5, S]
                      int32_t* __restrict__ bad,           // [S]
                      int T, int S) {
  constexpr int D = kOffDepth;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= S) return;
  const size_t s = static_cast<size_t>(S);
  const int32_t* xl = xs + lane;           // record t at xl[t * s]
  int32_t* kl = kp + lane;
  auto load_x = [&](int t) -> int32_t { return t < T ? xl[t * s] : 0; };
  int32_t xv[D];                           // slot k: record t0 + k
#pragma unroll
  for (int k = 0; k < D; ++k) xv[k] = load_x(k);
  Coder c;
  Off o;
  for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int t = t0 + k;
      const int32_t rec = coder_put(c, o, xv[k]);
      xv[k] = load_x(t + D);               // coded D steps from now
      if (t < T) kl[t * s] = rec;
    }
  }
  store_fin_off(c, o, fin, bad, s, lane);
  fin[s + lane] = c.rng;
}

__global__ void __launch_bounds__(2 * kWarp)
coder_scan_kernel(const int32_t* __restrict__ xs,          // [T, S]
                  int32_t* __restrict__ meta,              // [T, S]
                  int32_t* __restrict__ runs,              // [T, S]
                  int32_t* __restrict__ fin,               // [4, S]
                  int T, int S) {
  __shared__ uint32_t ring[kStages][kBatch][kWarp];
  __shared__ int32_t in[kInStages][kBatch][kWarp];
  const int l = threadIdx.x % kWarp;
  const int lane = blockIdx.x * kWarp + l;
  const bool live = lane < S;
  const size_t s = static_cast<size_t>(S);
  const int nb = (T + kBatch - 1) / kBatch;
  if (threadIdx.x < kWarp) {
    const int32_t rng = rng_warp<1>(
        ring, l, nb,
        [&](int b) {
          if (b >= nb) return;
          const size_t at = static_cast<size_t>(b) * kBatch * s + lane;
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            const bool ok = live && b * kBatch + r < T;
            copy_word(&in[b % kInStages][r][l], xs + (ok ? at + r * s : 0),
                      ok);
          }
        },
        [&](int slot, int r) { return in[slot][r][l]; },
        [](int32_t x, int) { return x; });
    if (live) fin[s + lane] = rng;
  } else {
    Low c;
    int32_t* ml = meta + lane;              // the next record's
    int32_t* rl = runs + lane;
    low_warp(ring, l, T, nb, [&](bool in, uint32_t w) {
      Flush f;
      const uint32_t emit = low_put(c, w, f);
      store_if(ml, slot_meta(f, emit), live && in);
      store_if(rl, f.run, live && in);
      ml += s;
      rl += s;
    });
    if (live) store_fin(c, fin, s, lane);
  }
}

inline int grid_of(int S, int lanes) { return (S + lanes - 1) / lanes; }

}  // namespace

extern "C" int llct_coder_scan_off_q(const void* qlo, const void* qhi,
                                     void* kp, void* fin, void* bad, int Tq,
                                     int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_off_q_kernel<<<grid_of(S, kWarp), 2 * kWarp, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qlo), static_cast<const int32_t*>(qhi),
      static_cast<int32_t*>(kp), static_cast<int32_t*>(fin),
      static_cast<int32_t*>(bad), Tq, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int llct_coder_scan_off(const void* xs, void* kp, void* fin,
                                   void* bad, int T, int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_off_kernel<<<grid_of(S, kBlock), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(kp),
      static_cast<int32_t*>(fin), static_cast<int32_t*>(bad), T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int llct_coder_scan(const void* xs, void* meta, void* runs,
                               void* fin, int T, int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_kernel<<<grid_of(S, kWarp), 2 * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(meta),
      static_cast<int32_t*>(runs), static_cast<int32_t*>(fin), T, S);
  return static_cast<int>(cudaGetLastError());
}
