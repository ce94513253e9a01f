// The design that kernel 5 (llcomp_tpu_torch/csrc/build_stream.cu)
// replaced, kept whole as a copy that
// chip_smoke.py (VARIANTS) and tools/torch_stream_copies.py build and time
// beside the shipped kernel on the same inputs.  Its note follows as it
// stood.
//
// Kernel 5 of llcomp_tpu_torch: the decision variant's stream builder, one
// thread per decision slot.
//
// Replaces: llcomp_tpu/pallas/encode_kernels.py::_make_build_kernel
// (build_stream, encode_kernels.py:74).  Input: each lane's folded context
// hash and residual per symbol, lane-major [S, n_pad] int32; symbols at or
// past n_sym are padding.  Output: K slots per symbol, lane-major
// [S, n_pad*K] int32, as the forward sort reads them: slot k of a live
// symbol holds (hash*8 + ctx)*2 + bit of its decision k (zero flag, unary
// exponent with ctx min(k, 4), stop, mantissa MSB first with ctx 5..6, sign
// with ctx 7), and -1 past its last decision and on every padding symbol.
// The exponent e counts bits 1..11 of |d| (floor(log2 |d|) for |d| < 2^12,
// 11 above), and the mantissa shift is clipped to 0..30, as in the TPU
// kernel.
//
// What bounds it on the H100: bytes.  Each slot is a few integer ops and one
// 4-byte store; at 1,024 lanes x 12,288 symbols x K 24 it writes 1.2 GB.
//
// What the design does about it: the slots of a warp are consecutive, so the
// stores are coalesced, and the K threads of one symbol read its hash and
// residual from the same line.  Offsets are size_t: the output holds
// S * n_pad * K slots, more than 2^31 at large batches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGrid = 132 * 32;   // grid-stride: 32 blocks per SM

__device__ __forceinline__ int32_t slot(int32_t h, int32_t d, int k) {
  const int32_t ad = d < 0 ? -d : d;
  const int e = ad > 1 ? min(31 - __clz(ad), 11) : 0;
  const bool nz = ad != 0;
  const bool in_exp = k >= 1 && k <= e;
  const bool is_stop = k == e + 1;
  const bool in_mant = k >= e + 2 && k <= 2 * e + 1;
  const bool is_sign = k == 2 * e + 2;
  if (!(k == 0 || (nz && (in_exp || is_stop || in_mant || is_sign))))
    return -1;
  int ctx = 0, bit;
  if (k == 0) {
    bit = !nz;
  } else if (in_exp) {
    ctx = min(k, 4);
    bit = 1;
  } else if (is_stop) {
    ctx = min(e + 1, 4);
    bit = 0;
  } else if (in_mant) {
    ctx = min(k - e + 3, 6);
    bit = (ad >> min(max(2 * e + 1 - k, 0), 30)) & 1;
  } else {
    ctx = 7;
    bit = d < 0;
  }
  return (h * 8 + ctx) * 2 + bit;
}

__global__ void __launch_bounds__(kBlock)
build_stream_kernel(const int32_t* __restrict__ hash,   // [S, n_pad]
                    const int32_t* __restrict__ diff,   // [S, n_pad]
                    int32_t* __restrict__ out,          // [S, n_pad*K]
                    size_t total, int n_pad, int n_sym, int K) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const size_t sym = i / K;                     // lane * n_pad + symbol
    const int k = static_cast<int>(i - sym * K);
    const int j = static_cast<int>(sym % n_pad);
    out[i] = j < n_sym ? slot(hash[sym], diff[sym], k) : -1;
  }
}

}  // namespace

extern "C" int llct_build_stream(const void* hash, const void* diff,
                                 void* out, int S, int n_pad, int n_sym,
                                 int K, void* stream) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(S) * n_pad * K;
  if (total == 0) return 0;
  const size_t blocks = (total + kBlock - 1) / kBlock;
  const int grid = static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
  build_stream_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hash), static_cast<const int32_t*>(diff),
      static_cast<int32_t*>(out), total, n_pad, n_sym, K);
  return static_cast<int>(cudaGetLastError());
}
