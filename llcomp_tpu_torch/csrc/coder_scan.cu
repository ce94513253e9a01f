// Kernels 4, 7 and 8 of llcomp_tpu_torch: the sort chain's range coders, one
// thread per lane (one lane = one independent rev-2 stream).
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
// What bounds them on the H100: latency.  Each lane is one serial chain of
// multiply, compare and shift per decision; bytes moved are 2 to 4 B in and
// 4 to 8 B out per decision, coalesced (lane-minor arrays), and 1,024 lanes
// put only 32 warps in flight.  A record's load takes longer than the
// chain's own work on it, so a kernel whose loop loads each record when it
// codes it waits out one device-memory latency a step.
//
// What the design does about it: the coder state is a few registers, no
// memory is touched but the records in and out, and all three kernels share
// one step (coder_code, then coder_shift), so the state update exists once.
// The step is written with selects, not branches: with its loads off the
// chain the step itself is the chain, and its branches, which a warp's
// lanes take different ways, made it longer.  Kernel 7 keeps its records
// in flight ahead of the chain: no record depends on the coder state, so
// each lane holds a ring of kOffDepth records in registers, loaded kOffDepth
// steps before they are coded (the loop is unrolled by the depth, so each
// slot keeps its register); a record past T loads as 0, which codes
// nothing.  Kernels 4 and 8 still load each step's records on the chain.
// Measured at 1,024 lanes x 61,696 records (one H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 7, which times copies of this file built with other
// depths and lanes a block): kernel 7 took 31.1 ms loading each record on
// the chain, 12.1 ms with a ring 16 deep on the branching step, and 5.9 ms
// as shipped (depth 8, 32 lanes a block, 40 registers); the copies took
// 14.8, 8.7, 8.0 and 8.4 ms at depths 1, 4, 16 and 32 (74-80 registers at
// 16 and 32: a larger unrolled body for no more hidden latency), 6.4 and
// 5.9 ms at 1 and 4 lanes a block.  This step took kernels 4 and 8 from
// 18.5 and 30.6 ms to 11.8 and 15.6 ms.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;                  // lanes (threads) per block
constexpr int kOffDepth = 8;                // kernel 7: records in flight
constexpr int32_t kSilent = 0x7FFFFFFF;     // no byte flushed
constexpr int32_t kOffLimit = 1 << 22;      // keeps off<<9 in int32

struct Coder {
  int32_t low = 0;
  int32_t rng = 0xFF00;
  int32_t pend = -1;  // byte awaiting carry resolution, -1 before the first
  int32_t run = 0;    // deferred bytes after it
};

struct CoderOff : Coder {
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

__device__ __forceinline__ Flush flush_of(const Coder& c) {
  const uint32_t carry = c.low >= 0x10000;        // pending + 1, 0x00 run
  return {carry, (static_cast<uint32_t>(c.pend) + carry) & 0xFF, c.run};
}

// The put of one record valid<<9 | bit<<8 | prob (llcomp.hpp:60-73,
// encode_kernels.py:427-437): true where the renormalising shift follows.
// Selects, not branches, as in coder_shift (the note above says why).
__device__ __forceinline__ bool coder_code(Coder& c, int32_t x) {
  const bool valid = x & 0x200, one = x & 0x100;
  const int32_t range1 = (c.rng * (x & 0xFF)) >> 8;
  c.low = valid && one ? c.low + c.rng - range1 : c.low;
  c.rng = valid ? (one ? range1 : c.rng - range1) : c.rng;
  return valid && c.rng < 0x100;
}

// The renormalising shift with lazy carries (llcomp.hpp:38-58,
// encode_kernels.py:439-457), done where `shift` is true: true where it
// emits (flushes the pending byte and its run, as flush_of read them before
// the shift).  The first shift only sets the pending byte; a top byte of
// 0xFF defers.
__device__ __forceinline__ bool coder_shift(Coder& c, bool shift) {
  const bool first = c.pend < 0;
  const bool resolved = c.low <= 0xFF00 || c.low >= 0x10000;
  const bool emit = shift && !first && resolved;
  const bool defer = shift && !first && !resolved;
  c.pend = shift && !defer ? (c.low >> 8) & 0xFF : c.pend;
  c.run = emit ? 0 : c.run + defer;
  c.low = shift ? (c.low & 0xFF) << 8 : c.low;
  c.rng = shift ? c.rng << 8 : c.rng;
  return emit;
}

// One step of kernels 4 and 7: its offset-packed byte record
// (encode_kernels.py:512-518).
__device__ __forceinline__ int32_t coder_put(CoderOff& c, int32_t x) {
  const bool shift = coder_code(c, x);
  const Flush f = flush_of(c);
  const bool emit = coder_shift(c, shift);
  c.bad |= emit && c.off >= kOffLimit;
  const int32_t rec = static_cast<int32_t>(
      (static_cast<uint32_t>(c.off) << 9) | (f.carry << 8) | f.head);
  c.off += emit ? 1 + f.run : 0;
  return emit ? rec : kSilent;
}

__device__ __forceinline__ void store_fin(const Coder& c, int32_t* fin,
                                          size_t s, int lane) {
  fin[lane] = c.low;
  fin[s + lane] = c.rng;
  fin[2 * s + lane] = c.pend;
  fin[3 * s + lane] = c.run;
}

__device__ __forceinline__ void store_fin_off(const CoderOff& c, int32_t* fin,
                                              int32_t* bad, size_t s,
                                              int lane) {
  store_fin(c, fin, s, lane);
  fin[4 * s + lane] = c.off;
  bad[lane] = c.bad;
}

__global__ void __launch_bounds__(kBlock)
coder_scan_off_q_kernel(const int32_t* __restrict__ qlo,   // [Tq, S]
                        const int32_t* __restrict__ qhi,   // [Tq, S]
                        int32_t* __restrict__ kp,          // [4*Tq, S]
                        int32_t* __restrict__ fin,         // [5, S]
                        int32_t* __restrict__ bad,         // [S]
                        int Tq, int S) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t s = static_cast<size_t>(S);
  CoderOff c;
  for (int t = 0; t < Tq; ++t) {
    const int32_t a = qlo[t * s + lane];
    const int32_t b = qhi[t * s + lane];
    int32_t* out = kp + 4 * t * s + lane;
    out[0] = coder_put(c, a & 0x3FF);
    out[s] = coder_put(c, (a >> 10) & 0x3FF);
    out[2 * s] = coder_put(c, b & 0x3FF);
    out[3 * s] = coder_put(c, (b >> 10) & 0x3FF);
  }
  store_fin_off(c, fin, bad, s, lane);
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
  CoderOff c;
  for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int t = t0 + k;
      const int32_t rec = coder_put(c, xv[k]);
      xv[k] = load_x(t + D);               // coded D steps from now
      if (t < T) kl[t * s] = rec;
    }
  }
  store_fin_off(c, fin, bad, s, lane);
}

__global__ void __launch_bounds__(kBlock)
coder_scan_kernel(const int32_t* __restrict__ xs,          // [T, S]
                  int32_t* __restrict__ meta,              // [T, S]
                  int32_t* __restrict__ runs,              // [T, S]
                  int32_t* __restrict__ fin,               // [4, S]
                  int T, int S) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t s = static_cast<size_t>(S);
  Coder c;
  for (int t = 0; t < T; ++t) {
    const bool shift = coder_code(c, xs[t * s + lane]);
    const Flush f = flush_of(c);
    const uint32_t emit = coder_shift(c, shift);
    meta[t * s + lane] = static_cast<int32_t>(emit | (f.carry << 1)
                                              | (f.head << 8));
    runs[t * s + lane] = f.run;
  }
  store_fin(c, fin, s, lane);
}

inline int grid_of(int S) { return (S + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int llct_coder_scan_off_q(const void* qlo, const void* qhi,
                                     void* kp, void* fin, void* bad, int Tq,
                                     int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_off_q_kernel<<<grid_of(S), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qlo), static_cast<const int32_t*>(qhi),
      static_cast<int32_t*>(kp), static_cast<int32_t*>(fin),
      static_cast<int32_t*>(bad), Tq, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int llct_coder_scan_off(const void* xs, void* kp, void* fin,
                                   void* bad, int T, int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_off_kernel<<<grid_of(S), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(kp),
      static_cast<int32_t*>(fin), static_cast<int32_t*>(bad), T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int llct_coder_scan(const void* xs, void* meta, void* runs,
                               void* fin, int T, int S, void* stream) {
  if (S <= 0) return 0;
  coder_scan_kernel<<<grid_of(S), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xs), static_cast<int32_t*>(meta),
      static_cast<int32_t*>(runs), static_cast<int32_t*>(fin), T, S);
  return static_cast<int>(cudaGetLastError());
}
