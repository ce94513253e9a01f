// Probes p0-p11 of llcomp_tpu_torch.probes.mosaic: per-lane access to a
// model plane, and the cost split of one symbol step, on the H100.
//
// Replaces the twelve Pallas kernels of tools/probe_mosaic.py:
//   p0  p0_scalar_store       :65  (pallas_call :74)
//   p1  p1_scalar_load        :85  (:99)
//   p2  p2_row_load_blend     :110 (:124)
//   p3  p3_row_rmw            :135 (:150)
//   p4  p4_window_load        :162 (:176)
//   p5  p5_sublane_gather32   :187 (:193)
//   p6  p6_smem_staging       :204 (:221)
//   p7  p7_symbol_step_cost   :233 (:292)
//   p8  p8_stage_only_cost    :308 (:337)
//   p9  p9_decision_only_cost :352 (:377)
//   p10 p10_decision_unrolled :388 (:409)
//   p11 p11_stage_few         :420 (:440)
//
// What the TPU probes asked: whether Mosaic lowers a per-lane scalar store
// (p0), load (p1) or row read-modify-write (p2, p3, p4) of a model plane
// held in VMEM, and what one symbol step costs when 128 lanes stage their
// model rows in and out one lane at a time (p7), split into staging alone
// (p8), decisions alone (p9, p10 unrolled) and staging of 8 lanes (p11).
// On Hopper every one of these primitives is an ordinary load or store of
// one thread, so the question left is its cost: one thread owns one lane
// and reads its row straight from the plane in device memory, with no
// staging loop over lanes, no SMEM bridge and no lane blends.
//
// What bounds them on the H100: latency, not bytes or operations.  p0-p6
// move a few KB; one launch costs what a launch costs.  p7, p8 and the
// decision probes are serial chains a lane: one load of the lane's model
// row a step (the row depends on the step), then p7's 24 dependent
// decisions.  p11 only looks like one: it stores nothing and its rows
// depend on idx and the step alone, so its carry is the wrapped sum of its
// T words, masked once.  The plane is [rows, lanes] int32, 8.1 MB at 128 lanes
// (inside the 50 MB L2) and 65 MB at 1,024 (outside it), and a warp's 32
// lanes read 32 different rows, so each load is 32 sectors.
//
// What the designs of p7-p10 do about it.  A decision is decide_perm
// (probe_common.cuh): three dependent instructions carry ctx from one
// decision to the next (a byte permute reads the byte, an add and a mask
// make the next ctx), and the row's byte permutes and acc hang off that
// chain; acc is masked once, where it leaves.  p7's and p8's row at a step
// depends on idx and the step alone, so the rows of the next kRowDepth
// (p7) or kStageDepth (p8) steps are known ahead (StepRows): the row of
// step s + D is loaded while step s runs, into a register ring indexed
// statically (the loop unrolled by D), so a step no longer waits for a load
// issued after the previous step's store.  A load issued before a store of
// the same row would read the row as it was: after each step's store,
// every pending slot of that row takes the stored words from registers
// (into a forward slot of its own, so that no instruction waits on a load
// in flight before the step that consumes it; p8's stored word is 16 bits,
// so an all-ones forward marks a slot no store reached).  p8, with no
// decisions, is left with its carry (an add and a mask a step) and the
// instructions around its load and store: the row's floor modulo, the
// forwarding, the addresses; its depth is its own, past p7's, since one
// load latency over D must fall under that.  p10, 24 decisions unrolled
// with no row to load, is held by instruction issue alone: its step is
// decide_perm unrolled, 16.3 SASS instructions a decision and 3.5 on its
// chain.
//
// The H100's answer (one H100 80GB HBM3 at 700 W, chip_smoke.py phase 8):
// p0-p6 each run 0.8-1.8 us on the device a launch, over an empty launch's
// 0.85-0.88 us; p3's row store, its loads issued before its stores
// (probe_common.cuh), 1.15 us against scatter_'s 1.55 us in turns in one
// profiler session (1.8 us when it loaded after its store).  p11 sums each
// staged lane's words over a warp (one warp a block, so that each lane's
// scattered loads go through an SM of its own), each thread 16 loads
// issued before its adds, the rows' floor modulo a multiply-high and
// shifts (FloorMod), one warp redux: at T 512, 2.03 us of device time at
// 128 and 1,024 lanes in turns with an empty launch of 0.89 us, against
// the serial loop a lane it replaced (tools/designs/probe_p11_serial.cuh;
// 171-287 ns a step through one launch's CUDA events) 36.4 us, a register ring
// a lane (tools/designs/probe_p11_ring.cuh, 40.6 SASS instructions a step)
// 64.4 us, and 8 warps a block, 8 lanes on one SM, 3.53-3.57 us.  The
// parent design of p7, p8, p9 and p10 (tools/designs/
// probe_mosaic_serial_step.cu: each row loaded after the previous step's
// store, decide's shift-and-select step) paid the sum of its row's load
// and its decisions: p7 1,137-1,172 ns a step at 128 lanes and 1,461-1,569
// at 1,024, p8 393-461 and 658-726 (the plane past L2), p9 765-851.  This
// design, in turns with it: p7 673-695 and 729-791 (its loads hidden: ring
// depths 2, 4 and 8 alike), p9 570-674, and 351-437 unrolled; p8 at depth
// 16, medians of 10 rounds, 230.7 and 271.2 against the parent's 448.0 and
// 726.6 (depth 8 alike at 128 lanes and 11% slower at 1,024, depth 32
// slower at both), 74 SASS instructions a step, 32 of them the
// forwarding, at five to six clocks each (its rows stepped by additions,
// 70 a step, ran 6-12% faster, inside the rounds' spread at 1,024
// lanes).  What holds
// the step now is issue, not its chain: one warp a block, alone on its SM,
// issues about one instruction every two clocks (16-lane integer pipes),
// and p9's rolled loop compiles to 23 instructions a decision with 3.5 on
// its carried chain (the parent's 23 and 10), 16.3 unrolled.  That holds
// whichever integer pipe an instruction goes to: p10 on a step split about
// evenly between the ALU and FMA pipes (tools/designs/
// probe_p10_pipes_step.cuh, 16.5 a decision) ran slower than on
// decide_perm, and on one of 14.4 with a 3.0 chain (tools/designs/
// probe_p10_split_step.cuh) faster, at 128 lanes by less than the spread
// of its turns.  chip_smoke.py phase 8 times p7-p10 in turns with the
// parent and with copies at other ring depths and on other steps; PERF.md
// keeps the numbers.
#include "probe_common.cuh"

namespace {

using namespace probe;

__global__ void __launch_bounds__(kLaneBlock)
scalar_store(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
             int lanes) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int32_t r = fmod_floor(idx[l], 64);
  const size_t n = static_cast<size_t>(lanes);
  for (int i = 0; i < 64; ++i) out[i * n + l] = i == r ? r : 0;
}

// Steps of p7's rows in flight ahead of the step that decides (D).
constexpr int kRowDepth = 4;

// p7: T full symbol steps on two planes A (bytes 0-3 of a row) and B
// (bytes 4-7): stage the row in, 24 decisions (the loop kept, as the TPU
// probe's fori_loop), stage it out.  Slot k of the ring holds step s0 + k:
// its row, the words loaded for it (lo, hi) and the words forwarded to it
// by a later store (flo, fhi, taken where fw).
__global__ void __launch_bounds__(kLaneBlock)
symbol_steps(const int32_t* __restrict__ idx, int32_t* __restrict__ A,
             int32_t* __restrict__ B, int32_t* __restrict__ out, int lanes,
             int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t n = static_cast<size_t>(lanes);
  StepRows rows_of(idx[l], rows - 1);
  int32_t row[kRowDepth];
  uint32_t lo[kRowDepth], hi[kRowDepth], flo[kRowDepth], fhi[kRowDepth];
  bool fw[kRowDepth];
#pragma unroll
  for (int k = 0; k < kRowDepth; ++k) {
    row[k] = rows_of.next();
    lo[k] = hi[k] = flo[k] = fhi[k] = 0u;
    fw[k] = false;
    if (k < T) {
      lo[k] = static_cast<uint32_t>(A[row[k] * n + l]);
      hi[k] = static_cast<uint32_t>(B[row[k] * n + l]);
    }
  }
  uint32_t t = 0, ctx = 0;
  for (int s0 = 0; s0 < T; s0 += kRowDepth) {
#pragma unroll
    for (int k = 0; k < kRowDepth; ++k) {
      if (s0 + k >= T) break;
      const int32_t r = row[k];
      uint32_t wlo = fw[k] ? flo[k] : lo[k];
      uint32_t whi = fw[k] ? fhi[k] : hi[k];
      row[k] = rows_of.next();   // step s + D
      fw[k] = false;
      if (s0 + k + kRowDepth < T) {
        lo[k] = static_cast<uint32_t>(A[row[k] * n + l]);
        hi[k] = static_cast<uint32_t>(B[row[k] * n + l]);
      }
      decide24_perm<false>(wlo, whi, ctx, t);
      A[r * n + l] = static_cast<int32_t>(wlo);
      B[r * n + l] = static_cast<int32_t>(whi);
#pragma unroll
      for (int j = 0; j < kRowDepth; ++j) {
        const bool hit = row[j] == r;
        flo[j] = hit ? wlo : flo[j];
        fhi[j] = hit ? whi : fhi[j];
        fw[j] = fw[j] || hit;
      }
    }
  }
  out[l] = static_cast<int32_t>(t & 0x7FFFu);
}

// Steps of p8's rows in flight ahead of the step that stages (D).
constexpr int kStageDepth = 16;
// A slot's forward where no later store reached it: a stored word is 16
// bits, so no store gives this word.
constexpr int32_t kNoForward = -1;

// p8: T steps of staging alone: read the row, write (word + carry + 1) &
// 0xFFFF back, carry = (carry + word) & 0x7FFF; the rows from Rows
// (StepRows).  Slot k of the ring holds step s0 + k: its row, the word
// loaded for it (w) and the word forwarded to it by a later store (fwd,
// taken where not kNoForward).
template <class Rows>
__global__ void __launch_bounds__(kLaneBlock)
stage_only(const int32_t* __restrict__ idx, int32_t* __restrict__ A,
           int32_t* __restrict__ out, int lanes, int rows, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  int32_t* const col = A + l;
  const uint32_t pitch = 4u * static_cast<uint32_t>(lanes);
  Rows rows_of(idx[l], rows - 1);
  int32_t row[kStageDepth], w[kStageDepth], fwd[kStageDepth];
#pragma unroll
  for (int k = 0; k < kStageDepth; ++k) {
    row[k] = rows_of.next();
    w[k] = k < T ? *word_at(col, row[k], pitch) : 0;
    fwd[k] = kNoForward;
  }
  int32_t carry = 0;
  for (int s0 = 0; s0 < T; s0 += kStageDepth) {
#pragma unroll
    for (int k = 0; k < kStageDepth; ++k) {
      if (s0 + k >= T) break;
      const int32_t r = row[k];
      const int32_t word = fwd[k] != kNoForward ? fwd[k] : w[k];
      row[k] = rows_of.next();   // step s + D
      fwd[k] = kNoForward;
      if (s0 + k + kStageDepth < T) w[k] = *word_at(col, row[k], pitch);
      const int32_t stored = wadd(wadd(word, carry), 1) & 0xFFFF;
      *word_at(col, r, pitch) = stored;
      carry = wadd(carry, word) & 0x7FFF;
#pragma unroll
      for (int j = 0; j < kStageDepth; ++j)
        fwd[j] = row[j] == r ? stored : fwd[j];
    }
  }
  out[l] = carry;
}

// p9 (decisions_perm<false>) and p10 (decisions_perm<true>): T steps of
// 24 decisions alone, on a row that starts as idx[0, l] & 0xFF in all 8
// bytes; p9 takes decide_perm with its loop kept, p10 unrolled.
template <bool Unroll>
__global__ void __launch_bounds__(kLaneBlock)
decisions_perm(const int32_t* __restrict__ idx, int32_t* __restrict__ out,
               int lanes, int T) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  uint32_t lo = (static_cast<uint32_t>(idx[l]) & 0xFFu) * 0x01010101u;
  uint32_t hi = lo;
  uint32_t t = 0, ctx = 0;
#pragma unroll 1
  for (int s = 0; s < T; ++s) decide24_perm<Unroll>(lo, hi, ctx, t);
  out[l] = static_cast<int32_t>(t & 0x7FFFu);
}

// p11's staged lanes a block (a warp each: one, so that each staged lane's
// scattered loads go through an SM of its own; chip_smoke.py times a copy
// at 8), and the loads a thread issues before it adds them (a thread's
// steps at T 512).
constexpr int kFewWarps = 1;
constexpr int kFewBatch = 16;

// The floor modulo v mod m of every int32 v, 1 <= m < 2^31, with no
// division: u = v + 2^31 (mod 2^32) is divided by m with Granlund and
// Montgomery's round-up multiply (exact for every 32-bit u; mul, sh1 and
// sh2 from probes.floor_mod_magic on the host), and u mod m, less 2^31
// mod m, is brought into [0, m): mc = m - (2^31 mod m), so u mod m + mc
// lies in [1, 2m) and one unsigned minimum finishes it.
struct FloorMod {
  uint32_t mul, m, mc;
  int sh1, sh2;
  __device__ __forceinline__ int32_t of(uint32_t u) const {
    const uint32_t hi = __umulhi(u, mul);
    const uint32_t q = (hi + ((u - hi) >> sh1)) >> sh2;
    const uint32_t r = u - q * m + mc;
    return static_cast<int32_t>(min(r, r - m));
  }
};

// p11: T steps in which only the first `staged` lanes read their row:
// carry = (carry + word) & 0x7FFF, the plane left as it is.  No step stores
// and a row depends on x and s alone, so the carry is (the wrapped sum of
// the T words) & 0x7FFF (2^15 divides 2^32) and the steps need no order.
// Staged lane l takes warp l of the first warp_blocks blocks of Warps
// warps; its thread t takes steps t, t + 32, ..., kFewBatch loads issued
// before their adds, and one warp redux sums them.  The blocks past those
// write 0 into the other lanes, one word a thread.
template <int Warps>
__global__ void __launch_bounds__(Warps * kWarp)
stage_few(const int32_t* __restrict__ idx, const int32_t* __restrict__ A,
          int32_t* __restrict__ out, int lanes, int staged, int T,
          int warp_blocks, FloorMod row) {
  if (blockIdx.x >= warp_blocks) {
    const int l = staged + (blockIdx.x - warp_blocks) * Warps * kWarp +
                  threadIdx.x;
    if (l < lanes) out[l] = 0;
    return;
  }
  const int l = blockIdx.x * Warps + threadIdx.x / kWarp;
  if (l >= staged) return;             // the whole warp
  const int t = threadIdx.x % kWarp;
  const int32_t* const col = A + l;
  const uint32_t pitch = 4u * static_cast<uint32_t>(lanes);
  // x*(s+1) + s*40503 = x + s*(x + 40503), offset by 2^31 (FloorMod's u)
  const uint32_t x = static_cast<uint32_t>(idx[l]);
  const uint32_t dv = x + 40503u;
  const uint32_t du = kWarp * dv;
  uint32_t u = x + static_cast<uint32_t>(t) * dv + 0x80000000u;
  uint32_t sum = 0;
  for (int s0 = t; s0 < T; s0 += kWarp * kFewBatch) {
    int32_t w[kFewBatch];
#pragma unroll
    for (int j = 0; j < kFewBatch; ++j) {
      w[j] = s0 + j * kWarp < T ? *word_at(col, row.of(u), pitch) : 0;
      u += du;
    }
#pragma unroll
    for (int j = 0; j < kFewBatch; ++j) sum += static_cast<uint32_t>(w[j]);
  }
  sum = __reduce_add_sync(0xFFFFFFFFu, sum);
  if (t == 0) out[l] = static_cast<int32_t>(sum & 0x7FFFu);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Entry points: one a probe.  idx is [k, lanes] (row 0 read), planes
// [rows, lanes]; every pointer is int32.  Each returns cudaGetLastError().

extern "C" int llct_probe_p0(const void* idx, void* out, int lanes,
                             void* stream) {
  scalar_store<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(out), lanes);
  return done();
}

extern "C" int llct_probe_p1(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 0);
  return done();
}

extern "C" int llct_probe_p2(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 0);
  return done();
}

extern "C" int llct_probe_p3(const void* idx, const void* val, void* model,
                             void* out, int lanes, void* stream) {
  row_store<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(val), io(model), io(out), lanes);
  return done();
}

extern "C" int llct_probe_p4(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 8, 0);
  return done();
}

extern "C" int llct_probe_p5(const void* idx, const void* src, void* out,
                             int lanes, int rows, void* stream) {
  window_gather<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), in(src), io(out), lanes, rows, 1, 32);
  return done();
}

extern "C" int llct_probe_p6(const void* idx, void* out, int lanes,
                             void* stream) {
  affine<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(out), lanes, 1, 1);
  return done();
}

extern "C" int llct_probe_p7(const void* idx, void* A, void* B, void* out,
                             int lanes, int rows, int T, void* stream) {
  symbol_steps<<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
      in(idx), io(A), io(B), io(out), lanes, rows, T);
  return done();
}

extern "C" int llct_probe_p8(const void* idx, void* A, void* out, int lanes,
                             int rows, int T, void* stream) {
  stage_only<StepRows>
      <<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
          in(idx), io(A), io(out), lanes, rows, T);
  return done();
}

extern "C" int llct_probe_p9(const void* idx, void* out, int lanes, int T,
                             void* stream) {
  decisions_perm<false>
      <<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
          in(idx), io(out), lanes, T);
  return done();
}

extern "C" int llct_probe_p10(const void* idx, void* out, int lanes, int T,
                              void* stream) {
  decisions_perm<true>
      <<<lane_blocks(lanes), kLaneBlock, 0, as_stream(stream)>>>(
          in(idx), io(out), lanes, T);
  return done();
}

extern "C" int llct_probe_p11(const void* idx, const void* A, void* out,
                              int lanes, int rows, int T, int nstage, int mul,
                              int sh1, int sh2, int mc, void* stream) {
  // lanes 0 .. nstage - 1 staged (none where nstage <= 0); mul, sh1, sh2
  // and mc are probes.floor_mod_magic(rows - 1)
  const int staged = nstage > 0 ? min(nstage, lanes) : 0;
  constexpr int block = kFewWarps * kWarp;
  const int warp_blocks = (staged + kFewWarps - 1) / kFewWarps;
  const int blocks = warp_blocks + (lanes - staged + block - 1) / block;
  const FloorMod row{static_cast<uint32_t>(mul),
                     static_cast<uint32_t>(rows - 1),
                     static_cast<uint32_t>(mc), sh1, sh2};
  if (blocks > 0)
    stage_few<kFewWarps><<<blocks, block, 0, as_stream(stream)>>>(
        in(idx), in(A), io(out), lanes, staged, T, warp_blocks, row);
  return done();
}
