// Runs llcomp_tpu_torch's native runtime (native/llcomp_host.cpp) from a
// plain process, so that tests/test_torch_sanitizer.py can build the two
// together under ASan + UBSan or TSan without loading a sanitized library
// into Python.
//
// Jobs come on stdin, one after another: a header line of integers, then
// the job's bytes.  Every buffer handed to the runtime is a heap block of
// exactly the length the job names, so that a sanitizer sees any access
// past it.  Replies go to stdout, little-endian.
//
//   E W H C P      + image (H*W*C) [+ prior table (121*8) if P]
//     -> u64 first length (into llct_out_cap bytes), u64 final length,
//        final stream: a stream past the buffer is encoded again into a
//        buffer of the length it returned, as host.encode_stream does
//   D W H C L P    + stream (L) [+ prior]
//     -> i32 rc, image (H*W*C; zeros past the row of a corrupt stream)
//   BE S W H C CAP T P  + S images [+ prior]
//     -> S x u64 length, then each stream cut at min(length, CAP)
//   BD S W H C T P      + S x (u64 length + stream) [+ prior]
//     -> i32 failures, S images
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
size_t llct_out_cap(int width, int height, int channels);
size_t llct_encode_stream(const uint8_t* img, int width, int height,
                          int channels, uint8_t* out, size_t out_cap,
                          const uint8_t* prior);
int llct_decode_stream(const uint8_t* data, size_t len, int width, int height,
                       int channels, uint8_t* out, const uint8_t* prior);
int llct_decode_batch(const uint8_t* const* datas, const size_t* lens, int n,
                      int width, int height, int channels,
                      uint8_t* const* outs, int n_threads,
                      const uint8_t* prior);
void llct_encode_batch(const uint8_t* const* imgs, int n, int width,
                       int height, int channels, uint8_t* const* outs,
                       size_t cap, size_t* out_lens, int n_threads,
                       const uint8_t* prior);
}

namespace {

constexpr size_t kPrior = 121 * 8;

void fail(const char* what) {
  std::fprintf(stderr, "runner: %s\n", what);
  std::exit(2);
}

// A heap block of exactly n bytes read from stdin (nullptr for n == 0).
uint8_t* read_block(size_t n) {
  if (n == 0) return nullptr;
  uint8_t* p = new uint8_t[n];
  if (std::fread(p, 1, n, stdin) != n) fail("short input");
  return p;
}

void put(const void* p, size_t n) {
  if (n && std::fwrite(p, 1, n, stdout) != n) fail("short output");
}

void put_u64(uint64_t v) { put(&v, 8); }

uint8_t* read_prior(long flag) { return flag ? read_block(kPrior) : nullptr; }

void encode_one(long W, long H, long C, long P) {
  const size_t raw = size_t(W) * H * C;
  uint8_t* img = read_block(raw);
  uint8_t* prior = read_prior(P);
  size_t cap = llct_out_cap(W, H, C);
  uint8_t* out = new uint8_t[cap];
  const size_t first = llct_encode_stream(img, W, H, C, out, cap, prior);
  size_t n = first;
  if (first > cap) {  // past the buffer: again at the length it returned
    delete[] out;
    cap = first;
    out = new uint8_t[cap];
    n = llct_encode_stream(img, W, H, C, out, cap, prior);
  }
  put_u64(first);
  put_u64(n);
  put(out, n <= cap ? n : cap);
  delete[] out;
  delete[] prior;
  delete[] img;
}

void decode_one(long W, long H, long C, long L, long P) {
  uint8_t* data = read_block(size_t(L));
  uint8_t* prior = read_prior(P);
  std::vector<uint8_t> out(size_t(W) * H * C);
  const int32_t rc = llct_decode_stream(data, size_t(L), W, H, C, out.data(),
                                        prior);
  put(&rc, 4);
  put(out.data(), out.size());
  delete[] prior;
  delete[] data;
}

void encode_batch(long S, long W, long H, long C, long cap, long T, long P) {
  const size_t raw = size_t(W) * H * C;
  std::vector<uint8_t*> imgs(S), outs(S);
  for (auto& p : imgs) p = read_block(raw);
  uint8_t* prior = read_prior(P);
  for (auto& p : outs) p = new uint8_t[cap];
  std::vector<size_t> lens(S);
  llct_encode_batch(imgs.data(), S, W, H, C, outs.data(), size_t(cap),
                    lens.data(), T, prior);
  for (size_t n : lens) put_u64(n);
  for (long s = 0; s < S; ++s)
    put(outs[s], lens[s] <= size_t(cap) ? lens[s] : size_t(cap));
  for (auto p : outs) delete[] p;
  for (auto p : imgs) delete[] p;
  delete[] prior;
}

void decode_batch(long S, long W, long H, long C, long T, long P) {
  std::vector<uint8_t*> datas(S);
  std::vector<size_t> lens(S);
  for (long s = 0; s < S; ++s) {
    uint64_t n;
    if (std::fread(&n, 8, 1, stdin) != 1) fail("short input");
    lens[s] = n;
    datas[s] = read_block(n);
  }
  uint8_t* prior = read_prior(P);
  const size_t raw = size_t(W) * H * C;
  std::vector<uint8_t> out(size_t(S) * raw);
  std::vector<uint8_t*> outs(S);
  for (long s = 0; s < S; ++s) outs[s] = out.data() + s * raw;
  const int32_t failures = llct_decode_batch(
      datas.data(), lens.data(), S, W, H, C, outs.data(), T, prior);
  put(&failures, 4);
  put(out.data(), out.size());
  for (auto p : datas) delete[] p;
  delete[] prior;
}

}  // namespace

int main() {
  char line[256];
  while (std::fgets(line, sizeof line, stdin)) {
    char op[4];
    long a[7] = {};
    const int got = std::sscanf(line, "%3s %ld %ld %ld %ld %ld %ld %ld", op,
                                &a[0], &a[1], &a[2], &a[3], &a[4], &a[5],
                                &a[6]);
    if (!std::strcmp(op, "E") && got == 5)
      encode_one(a[0], a[1], a[2], a[3]);
    else if (!std::strcmp(op, "D") && got == 6)
      decode_one(a[0], a[1], a[2], a[3], a[4]);
    else if (!std::strcmp(op, "BE") && got == 8)
      encode_batch(a[0], a[1], a[2], a[3], a[4], a[5], a[6]);
    else if (!std::strcmp(op, "BD") && got == 7)
      decode_batch(a[0], a[1], a[2], a[3], a[4], a[5]);
    else
      fail("bad job header");
  }
  return 0;
}
