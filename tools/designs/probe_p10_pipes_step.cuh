// A form of p10's decision not shipped: the one that tested whether the
// SM's two integer pipes can take turns for a warp alone on its SM.
// chip_smoke.py (VARIANTS, copy "p10 pipes") includes it into a copy of
// probe_mosaic.cu, inside its namespace, and launches its kernel for p10.
// It takes imad and kSplitOnes from probe_p10_split_step.cuh.
//
// The hypothesis: LOP3, PRMT, SHF, IADD3, LEA, ISETP and SEL issue to the
// ALU pipe and IMAD to the FMA pipe, each a warp instruction every two
// clocks, so a step that splits its instructions evenly between them
// issues twice as fast as one that sends them all to one.  Here every
// value a multiply-add can give is an IMAD: besides decide_split's, the
// write selectors as 0x3210 + q * (4 - ctx) (bytes 0-3) and 0x3210 +
// hi(q * ((8 - ctx) << 16)) (bytes 4-7), q = 1 << 4ctx one SHF: the
// nibble of byte ctx & 3 becomes 4 (byte 0 of raw + 1) in the word ctx is
// in, and the other word's low 16 bits stay 0x3210 (prmt reads no more
// of a selector).  ptxas gave 7.1 ALU and 8.1 FMA instructions a decision
// (16.5 with its constant moves), against decide_perm's 10 and 4.25, and
// it ran slower than decide_perm: the hypothesis does not hold.
#include "probe_p10_split_step.cuh"

// Its constants come in through registers whose values ptxas cannot
// see (`one` is a kernel argument, 1), so that every product stays an
// IMAD: with literal constants ptxas turns some into LEA, SHF and IADD3.
struct PipesK {
  uint32_t one, four, five, m1, mhi;
  __device__ __forceinline__ explicit PipesK(uint32_t one_)
      : one(one_), four(one_ << 2), five(one_ * 5u), m1(0u - one_),
        mhi(0u - (one_ << 16)) {}
};

// The high word of the 64-bit a * b, plus c: IMAD.HI.
__device__ __forceinline__ uint32_t imad_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void decide_pipes(uint32_t& lo, uint32_t& hi,
                                             uint32_t& s, uint32_t& t,
                                             uint32_t k, const PipesK& c) {
  const uint32_t ctx = s & 7u;
  const uint32_t raw = prmt(lo, hi, ctx);
  const uint32_t ahead = imad(s, c.five, k);
  const uint32_t q = __funnelshift_l(1u, 1u, imad(s, c.four, 0u));
  const uint32_t sel_lo = imad(q, imad(ctx, c.m1, 4u), 0x3210u);
  const uint32_t sel_hi = imad_hi(q, imad(ctx, c.mhi, 0x80000u), 0x3210u);
  const uint32_t next = raw + 1u;
  lo = prmt(lo, next, sel_lo);
  hi = prmt(hi, next, sel_hi);
  s = imad(raw, c.one, ahead);
  t = imad(t, c.five, raw & 0xFFu);
}

// p10 (decisions_perm<true> of probe_mosaic.cu) on this step.
__global__ void __launch_bounds__(kLaneBlock)
decisions_pipes(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                int lanes, int T, uint32_t one) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const PipesK c(one);
  uint32_t lo = (static_cast<uint32_t>(idx[l]) & 0xFFu) * 0x01010101u;
  uint32_t hi = lo;
  uint32_t s = 0, t = 0;
#pragma unroll 1
  for (int st = 0; st < T; ++st) {
#pragma unroll
    for (int d = 0; d < 24; ++d) decide_pipes(lo, hi, s, t, 2u - 4u * d, c);
    t += kSplitOnes;
  }
  out[l] = static_cast<int32_t>(t & 0x7FFFu);
}
