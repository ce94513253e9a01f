// Kernel 4 of llcomp_tpu_torch: the sort chain's range coder, one thread per
// lane (one lane = one independent rev-2 stream).
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_coder_kernel_off_q
// (coder_scan_off_q, encode_kernels.py:574).  Input: each lane's coder
// records in stream order (encode.stage_compact), pair-packed 10 bits each
// (valid<<9 | bit<<8 | prob): quad t holds records 4t, 4t+1 in qlo[t] and
// 4t+2, 4t+3 in qhi[t]; dead quads are 0.  For every record the kernel runs
// the carry-less range coder with lazy carries (llcomp.hpp:38-73) in int32
// and writes one offset-packed byte record, off<<9 | carry<<8 | head, where a
// shift flushes the pending byte (off: its position in the lane's stream;
// the deferred bytes after it are 0x00 on a carry, 0xFF otherwise), and
// 0x7FFFFFFF elsewhere.  At the end it writes the final low, rng, pend, run
// and off (fin), from which coder.finish_steps_off makes the two flush
// records and the stream length.  A byte offset of 2^22 or more, where
// off<<9 would leave int32, sets the lane's error flag; the wrapper raises.
//
// What bounds it on the H100: latency.  Each lane is one serial chain of
// multiply, compare and shift per decision; bytes moved are 2 B in and 4 B
// out per decision, coalesced (lane-minor [T, S] arrays), and 1,024 lanes
// put only 32 warps in flight.
//
// What the design does about it: the coder state is five registers, no
// memory is touched but the streams in and out, and a quad's four records
// come from two loads.  The per-decision step is a __device__ function, so
// that the stream-granular coders (coder_scan_off, coder_scan) can share it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;                  // lanes (threads) per block
constexpr int32_t kSilent = 0x7FFFFFFF;     // no byte flushed
constexpr int32_t kOffLimit = 1 << 22;      // keeps off<<9 in int32

struct CoderOff {
  int32_t low = 0;
  int32_t rng = 0xFF00;
  int32_t pend = -1;  // byte awaiting carry resolution, -1 before the first
  int32_t run = 0;    // deferred bytes after it
  int32_t off = 0;    // bytes flushed so far: the next head's offset
  int32_t bad = 0;    // sticky: an offset reached kOffLimit
};

// Code one record valid<<9 | bit<<8 | prob; returns its offset-packed byte
// record (encode_kernels.py:592-621).
__device__ __forceinline__ int32_t coder_put(CoderOff& c, int32_t x) {
  if (!(x & 0x200)) return kSilent;
  const int32_t range1 = (c.rng * (x & 0xFF)) >> 8;
  if (x & 0x100) {
    c.low += c.rng - range1;
    c.rng = range1;
  } else {
    c.rng -= range1;
  }
  if (c.rng >= 0x100) return kSilent;
  int32_t rec = kSilent;
  if (c.pend < 0) {                               // the first shift
    c.pend = (c.low >> 8) & 0xFF;
  } else if (c.low <= 0xFF00 || c.low >= 0x10000) {
    const uint32_t carry = c.low >= 0x10000;      // pending + 1, 0x00 run
    if (c.off >= kOffLimit) c.bad = 1;
    rec = static_cast<int32_t>((static_cast<uint32_t>(c.off) << 9)
                               | (carry << 8)
                               | ((static_cast<uint32_t>(c.pend) + carry)
                                  & 0xFF));
    c.off += 1 + c.run;
    c.run = 0;
    c.pend = (c.low >> 8) & 0xFF;
  } else {                                        // top byte 0xFF: defer
    ++c.run;
  }
  c.low = (c.low & 0xFF) << 8;
  c.rng <<= 8;
  return rec;
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
  fin[lane] = c.low;
  fin[s + lane] = c.rng;
  fin[2 * s + lane] = c.pend;
  fin[3 * s + lane] = c.run;
  fin[4 * s + lane] = c.off;
  bad[lane] = c.bad;
}

}  // namespace

extern "C" int llct_coder_scan_off_q(const void* qlo, const void* qhi,
                                     void* kp, void* fin, void* bad, int Tq,
                                     int S, void* stream) {
  if (S <= 0) return 0;
  const int grid = (S + kBlock - 1) / kBlock;
  coder_scan_off_q_kernel<<<grid, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qlo), static_cast<const int32_t*>(qhi),
      static_cast<int32_t*>(kp), static_cast<int32_t*>(fin),
      static_cast<int32_t*>(bad), Tq, S);
  return static_cast<int>(cudaGetLastError());
}
