// A device allocator for PyTorch (torch.cuda.memory.CUDAPluggableAllocator)
// that stands in for compute-sanitizer's memcheck and initcheck on global
// memory where the tool cannot run: chip_smoke.py's sanitizer children
// (``--sanitize-child guard``) load it before their first CUDA allocation.
//
// Every tensor gets its own cudaMalloc with kGuard bytes of guard right
// before its first byte and at least kGuard bytes right after its last (the
// tensor starts 256-byte aligned, so the guard after it starts at the
// exact end).  The guards hold one nonzero byte, the tensor's bytes another,
// both drawn afresh for each allocation:
//
// - a write past either end changes a guard: llct_guard_check() (every
//   live block) and the free of a block find it, report it on stderr and
//   write the guard again;
// - a read past either end, or of a byte nobody wrote, returns a byte of
//   the pattern, not what a correct kernel would have read, so the
//   caller's comparison with the kernel's plain version tells it.
//
// Reads are not seen directly, and shared memory and races not at all.
// Every call synchronises the device: this is a checking tool, not a fast
// allocator.  Build: nvcc -std=c++17 -O2 -shared -Xcompiler -fPIC.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kGuard = 4096;
constexpr size_t kAlign = 256;

struct Block {
  char* base;         // the cudaMalloc: guard, tensor, guard
  size_t size;        // the tensor's bytes
  size_t total;
  unsigned char guard;
};

std::mutex mu;
std::unordered_map<void*, Block> live;
uint64_t allocations = 0;
long long violations = 0;

// A nonzero byte from the allocation's number and a salt.
unsigned char pattern(uint64_t n, uint64_t salt) {
  uint64_t x = (n * 2 + salt + 1) * 0x9E3779B97F4A7C15ull;
  x ^= x >> 29;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 32;
  return static_cast<unsigned char>(x % 255 + 1);
}

// Bytes of the block's two guards that differ from its pattern, reported
// and written again; -1 if the device could not be read.
long long check_block(void* ptr, const Block& b, const char* when) {
  char* at[2] = {b.base, static_cast<char*>(ptr) + b.size};
  const size_t len[2] = {kGuard, b.total - kGuard - b.size};
  long long bad = 0;
  std::vector<unsigned char> host;
  for (int r = 0; r < 2; ++r) {
    host.resize(len[r]);
    if (cudaMemcpy(host.data(), at[r], len[r], cudaMemcpyDeviceToHost) !=
        cudaSuccess) {
      std::fprintf(stderr, "guard: cannot read the guards of a block of "
                   "%zu bytes (%s): %s\n", b.size, when,
                   cudaGetErrorString(cudaGetLastError()));
      return -1;
    }
    long long n = 0, first = -1, last = -1;
    for (size_t i = 0; i < len[r]; ++i) {
      if (host[i] == b.guard) continue;
      if (first < 0) first = static_cast<long long>(i);
      last = static_cast<long long>(i);
      ++n;
    }
    if (!n) continue;
    if (r == 0)
      std::fprintf(stderr, "guard: %lld bytes written before a block of %zu "
                   "bytes, from %lld to %lld bytes before it (%s)\n", n,
                   b.size, static_cast<long long>(kGuard) - first,
                   static_cast<long long>(kGuard) - last, when);
    else
      std::fprintf(stderr, "guard: %lld bytes written past a block of %zu "
                   "bytes, from byte %zu to %zu (%s)\n", n, b.size,
                   b.size + static_cast<size_t>(first),
                   b.size + static_cast<size_t>(last), when);
    cudaMemset(at[r], b.guard, len[r]);
    bad += n;
  }
  return bad;
}

}  // namespace

extern "C" {

void* llct_guard_malloc(size_t size, int device, cudaStream_t stream) {
  (void)device;
  (void)stream;
  const size_t total = kGuard + (size + kAlign - 1) / kAlign * kAlign + kGuard;
  char* base = nullptr;
  if (cudaMalloc(&base, total) != cudaSuccess) return nullptr;
  uint64_t n;
  {
    std::lock_guard<std::mutex> hold(mu);
    n = allocations++;
  }
  const unsigned char guard = pattern(n, 0);
  unsigned char fill = pattern(n, 1);
  if (fill == guard) fill = static_cast<unsigned char>(guard % 255 + 1);
  cudaMemset(base, guard, total);
  cudaMemset(base + kGuard, fill, size);
  cudaDeviceSynchronize();
  void* ptr = base + kGuard;
  std::lock_guard<std::mutex> hold(mu);
  live[ptr] = Block{base, size, total, guard};
  return ptr;
}

void llct_guard_free(void* ptr, size_t size, int device, cudaStream_t stream) {
  (void)size;
  (void)device;
  (void)stream;
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> hold(mu);
  auto it = live.find(ptr);
  if (it == live.end()) {
    std::fprintf(stderr, "guard: free of a pointer it did not allocate\n");
    ++violations;
    return;
  }
  const long long bad = check_block(ptr, it->second, "found at its free");
  violations += bad < 0 ? 1 : bad;
  cudaFree(it->second.base);
  live.erase(it);
}

// Synchronises, then checks the guards of every live block: the bytes
// written past a block since the last check (-1 if a guard could not be
// read).  `what` names the work since then in the report.
long long llct_guard_check(const char* what) {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> hold(mu);
  long long bad = 0;
  for (const auto& [ptr, b] : live) {
    const long long n = check_block(ptr, b, what);
    if (n < 0) return -1;
    bad += n;
  }
  violations += bad;
  return bad;
}

// Bytes written past a block over the process so far, and blocks made.
long long llct_guard_violations() {
  std::lock_guard<std::mutex> hold(mu);
  return violations;
}

long long llct_guard_allocations() {
  std::lock_guard<std::mutex> hold(mu);
  return static_cast<long long>(allocations);
}

}  // extern "C"
