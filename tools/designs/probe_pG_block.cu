// The design that probe pG (llcomp_tpu_torch/csrc/probe_mosaic3.cu,
// scalar_gate) replaced, kept whole as a copy that chip_smoke.py
// (VARIANTS, copy "pG block") builds and times beside the shipped kernel in
// one profiler session.  Its kernel and entry point follow as they stood.
//
// One block of up to 1,024 threads, one word a thread: each thread loads
// its words and takes their maximum, block_max (probe_common.cuh: a warp
// redux, one shared word a warp and two __syncthreads) gives the block's,
// and each thread reads its words of x again to store them: two trips to
// memory and two block barriers for 4 KB.  1.817 us of device time at the
// probe's (8, 128), 48.1% of it the launch floor (one H100 80GB HBM3 at
// 700 W, chip_smoke.py phase 8).
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

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* io(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

extern "C" int llct_probe_pG(const void* x, void* out, int n, void* stream) {
  const int threads = n < kMaxBlock ? whole_warps(n) : kMaxBlock;
  scalar_gate<<<1, threads, 0, as_stream(stream)>>>(in(x), io(out), n);
  return done();
}
