// The design that probe pH (llcomp_tpu_torch/csrc/probe_mosaic3.cu)
// replaced, kept whole as a copy that
// chip_smoke.py (VARIANTS) and tools/torch_stream_copies.py build and time
// beside the shipped kernel on the same inputs.  Its note follows as it
// stood.
//
// Probes pG and pH of llcomp_tpu_torch.probes.mosaic3: a reduction over a
// whole block as a branch predicate, and the stage cost split with and
// without a per-lane data window, on the H100.
//
// Replaces the two Pallas kernels of tools/probe_mosaic3.py:
//   pG  pG_scalar_gate :48 (pallas_call :62)
//   pH  pH_stage       :76 (:127), with and without the window
//
// What the TPU probes asked: whether jnp.max over a vector block can
// drive pl.when (pG), and what a symbol step's staging costs (two model
// words in and out a lane) with and without an 8-row data window a lane
// (pH), when a scalar that every lane feeds (the window's sum, mod 1009)
// picks the next step's rows.  On Hopper the block-wide reduction is a
// warp redux, one shared word a warp and two __syncthreads; pH's carry
// feeds the next step, so pH runs as one block of up to 1,024 threads (one
// a lane) and pays that reduction every step.
//
// What bounds them on the H100: latency.  pG moves 8 KB.  pH is one
// block's serial chain: a dependent load of two model words and eight
// data words a lane, then the block-wide sum, T times; one SM works.
//
// The H100's answer (one H100 80GB HBM3 at 700 W, chip_smoke.py phase 8,
// two runs): pG runs 1.3-1.4 us on the device.  pH takes 1,296-1,391 ns a
// step with the window and 831-929 ns without at 128 lanes (T 512),
// 8,166-8,372 and 4,131-4,234 ns at 1,024: a carry that every lane feeds
// costs about a whole symbol step of the independent lanes at 128 lanes
// (probe_mosaic.cu's p7) and five at 1,024.
#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int kMaxBlock = 1024;

// pG: out = x + 1 if max(x) > 100 else x - 1, over all n words of x.
__global__ void __launch_bounds__(kMaxBlock)
scalar_gate(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n) {
  __shared__ int32_t red[kWarp];
  int32_t m = INT_MIN;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max(m, x[i]);
  const int32_t d = block_max(m, red) > 100 ? 1 : -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = wadd(x[i], d);
}

// pH: T steps; at step s lane l stages the words (r, r+1) of its model
// column in and out (+1 each), r = ((idx[s mod idx_rows, l] + carry) mod
// (rows - 16)) rounded down to even, and with Window sums the data words
// b..b+7 of its column, b = r mod 992; carry = (carry + the block's sum)
// mod 1009.  out [8, lanes] = the last carry.
template <bool Window>
__global__ void __launch_bounds__(kMaxBlock)
stage_steps(const int32_t* __restrict__ idx, const int32_t* __restrict__ data,
            int32_t* __restrict__ M, int32_t* __restrict__ out, int lanes,
            int idx_rows, int rows, int T) {
  __shared__ int32_t red[kWarp];
  const int l = threadIdx.x;
  const bool live = l < lanes;
  const size_t n = static_cast<size_t>(lanes);
  int32_t carry = 0;
  for (int s = 0; s < T; ++s) {
    int32_t part = 0;
    if (live) {
      const int32_t r =
          fmod_floor(wadd(idx[(s % idx_rows) * n + l], carry), rows - 16) &
          ~1;
      const size_t at = r * n + l;
      const int32_t wa = M[at];
      const int32_t wb = M[at + n];
      if constexpr (Window) {
        const int32_t b = r % 992;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = wadd(part, data[(b + i) * n + l]);
      }
      M[at] = wadd(wa, 1);
      M[at + n] = wadd(wb, 1);
    }
    carry = fmod_floor(wadd(carry, block_sum(part, red)), 1009);
  }
  if (live) {
    for (int i = 0; i < 8; ++i) out[i * n + l] = carry;
  }
}

// A kernel that does nothing: its device time is the floor under every
// one-shot probe's, whatever the bytes and operations of its work.
__global__ void empty() {}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Entry points: one a probe; every pointer is int32.  Each returns
// cudaGetLastError().

extern "C" int llct_probe_pG(const void* x, void* out, int n, void* stream) {
  const int threads = n < kMaxBlock ? whole_warps(n) : kMaxBlock;
  scalar_gate<<<1, threads, 0, as_stream(stream)>>>(in(x), io(out), n);
  return done();
}

// lanes <= 1,024 (one thread a lane, one block); data has at least 1,000
// rows, so that every window b..b+7 lies inside it.
extern "C" int llct_probe_pH(const void* idx, const void* data, void* M,
                             void* out, int lanes, int idx_rows, int rows,
                             int T, int window, void* stream) {
  const int threads = whole_warps(lanes);
  if (window) {
    stage_steps<true><<<1, threads, 0, as_stream(stream)>>>(
        in(idx), in(data), io(M), io(out), lanes, idx_rows, rows, T);
  } else {
    stage_steps<false><<<1, threads, 0, as_stream(stream)>>>(
        in(idx), in(data), io(M), io(out), lanes, idx_rows, rows, T);
  }
  return done();
}

// The launch floor: one block of one warp running `empty`.
extern "C" int llct_probe_empty(void* stream) {
  empty<<<1, kWarp, 0, as_stream(stream)>>>();
  return done();
}
