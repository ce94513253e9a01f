// Host-side native runtime for tpu-llcomp.
//
// A from-scratch scalar implementation of the llcomp rev-2 bitstream (see
// SURVEY.md for the format spec; semantics defined by the reference's
// llcomp.hpp:33-547), built as a small C library:
//
//   * the fast host path for images too small to amortize device dispatch,
//   * the `backend="native"` codec behind the CLI,
//   * a second, independent conformance implementation next to the NumPy
//     oracle and the JAX pipeline.
//
// Differences from the reference by design: bounds-checked output (the
// reference overflows on incompressible input; here a stream that passes
// its buffer is counted to its end, and its length returned, so that the
// caller can encode it again into a buffer that size), grayscale decode
// guarded on
// channels >= 3 (the reference applies the inverse color transform
// unconditionally and corrupts), and >0xFFFF dimensions rejected rather than
// silently truncated.  None of these change emitted bytes for inputs the
// reference handles.
//
// Build: cc -O2 -shared -fPIC (see build.py); pure C++17, no dependencies.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- tables --
// Format data (must match the rev-2 bitstream definition exactly).

// Adaptive-state probability of coding a 1, scaled by 256.  Values pair up
// as p[2k] + p[2k+1] == 254; even states predict 0, odd predict 1.
const uint8_t kProb[128] = {
    123, 131, 117, 137, 111, 143, 106, 148, 101, 153, 96,  158, 91,  163, 87,
    167, 83,  171, 79,  175, 75,  179, 72,  182, 68,  186, 66,  188, 63,  191,
    60,  194, 57,  197, 54,  200, 52,  202, 49,  205, 48,  206, 45,  209, 43,
    211, 41,  213, 40,  214, 38,  216, 36,  218, 35,  219, 33,  221, 32,  222,
    30,  224, 30,  224, 28,  226, 27,  227, 26,  228, 25,  229, 24,  230, 23,
    231, 22,  232, 21,  233, 21,  233, 20,  234, 19,  235, 18,  236, 18,  236,
    17,  237, 17,  237, 16,  238, 16,  238, 15,  239, 15,  239, 14,  240, 14,
    240, 13,  241, 13,  241, 13,  241, 12,  242, 12,  242, 12,  242, 11,  243,
    11,  243, 11,  243, 11,  243, 7,   247};

// Fallback transitions toward the 50/50 start states on a surprise bit.
const uint8_t kLps[128] = {
    1,  0,  0,  1,  2,  3,  4,  5,  4,  5,  8,  9,  8,  9,  10, 11, 12, 13,
    14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25, 26, 27, 26, 27,
    30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37, 38, 39, 38, 39, 42, 43,
    42, 43, 44, 45, 44, 45, 46, 47, 48, 49, 48, 49, 50, 51, 52, 53, 52, 53,
    54, 55, 54, 55, 56, 57, 58, 59, 58, 59, 60, 61, 60, 61, 60, 61, 62, 63,
    64, 65, 64, 65, 66, 67, 66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71,
    70, 71, 72, 73, 72, 73, 72, 73, 74, 75, 76, 77, 76, 77, 76, 77, 76, 77,
    78, 79};

// Generated tables (initialized once): MPS ladder and the two banded
// residual quantizers indexed by two's-complement byte.
uint8_t g_mps[128];
int8_t g_q5[256];
int8_t g_q11[256];

struct TableInit {
  TableInit() {
    for (int i = 0; i < 128; ++i) {
      int cap = (i & 1) ? 127 : 126;  // climb by 2, saturate per parity
      g_mps[i] = static_cast<uint8_t>(i + 2 > cap ? cap : i + 2);
    }
    auto band = [](int mag, const int* th, int n) {
      int b = 0;
      while (b < n && mag >= th[b]) ++b;
      return b;
    };
    static const int t5[] = {1, 4};
    static const int t11[] = {1, 2, 5, 12, 35};
    for (int k = 0; k < 256; ++k) {
      int d = k < 128 ? k : k - 256;
      int mag = d < 0 ? -d : d;
      int sgn = d < 0 ? -1 : (d > 0 ? 1 : 0);
      g_q5[k] = static_cast<int8_t>(sgn * band(mag, t5, 2));
      g_q11[k] = static_cast<int8_t>(sgn * band(mag, t11, 5));
    }
  }
} g_table_init;

inline int quant5(int d) { return g_q5[(d < -128 ? -128 : d > 127 ? 127 : d) & 0xFF]; }
inline int quant11(int d) { return g_q11[(d < -128 ? -128 : d > 127 ? 127 : d) & 0xFF]; }

// Truncate-toward-zero division by 4 (C semantics; the transform depends on it).
inline int tdiv4(int x) { return x / 4; }

inline int median3(int a, int b, int c) {
  // median(a, b, c) == clamp b into [min(a,c), max(a,c)]
  int lo = a < c ? a : c;
  int hi = a < c ? c : a;
  return b < lo ? lo : (b > hi ? hi : b);
}

// ------------------------------------------------------------ range coder --

constexpr int kModelHashes = 7926;   // reachable folded hashes 0..7925
constexpr int kSub = 8;              // sub-states per hash
constexpr int kModelSize = kModelHashes * kSub;
constexpr int kPriorBuckets = 121;   // hash-bucketed prior rows (format data)

// Sliced-container "primed" mode (container flag bit 0): context row h
// starts at prior[(h % 121) * 8 + k] instead of 0.  The 121x8 row table is
// supplied by the caller (tables.PRIOR_TAB) so the format constants live in
// exactly one place; prior == nullptr keeps reference zero-start semantics.
inline void init_model(uint8_t* model, const uint8_t* prior) {
  if (!prior) {
    std::memset(model, 0, kModelSize);
    return;
  }
  for (int h = 0; h < kModelHashes; ++h)
    std::memcpy(model + size_t(h) * kSub,
                prior + size_t(h % kPriorBuckets) * kSub, kSub);
}

// Bytes past `cap` are counted and not written: `pos` is the stream's
// length whatever the buffer.
struct Sink {
  uint8_t* buf;
  size_t cap;
  size_t pos = 0;
  inline void push(uint8_t b) {
    if (pos < cap) buf[pos] = b;
    ++pos;
  }
};

struct Enc {
  uint32_t low = 0;
  uint32_t range = 0xFF00;
  int pending = -1;     // byte awaiting carry resolution
  uint32_t run = 0;     // deferred 0xFF-top-byte count
  Sink* out;

  inline void shift() {
    if (pending < 0) {
      pending = static_cast<int>(low >> 8);
    } else if (low <= 0xFF00u) {
      out->push(static_cast<uint8_t>(pending));
      for (; run; --run) out->push(0xFF);
      pending = static_cast<int>(low >> 8);
    } else if (low >= 0x10000u) {
      out->push(static_cast<uint8_t>(pending + 1));
      for (; run; --run) out->push(0x00);
      pending = static_cast<int>((low >> 8) & 0xFF);
    } else {
      ++run;
    }
    low = (low & 0xFF) << 8;
    range <<= 8;
  }

  inline void put(int bit, uint32_t prob) {
    uint32_t r1 = (range * prob) >> 8;
    if (bit) {
      low += range - r1;
      range = r1;
    } else {
      range -= r1;
    }
    if (range < 0x100) shift();
  }

  inline void flush() {
    range = 0xFF;
    low += 0xFF;
    shift();
    range = 0xFF;
    shift();
    // the still-pending byte is dropped: decoders read zeros past the end
  }
};

struct Dec {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  uint32_t low = 0;
  uint32_t range = 0xFF00;

  inline uint8_t byte() { return pos < len ? buf[pos++] : 0; }
  void init() { low = (uint32_t(byte()) << 8) | byte(); }

  inline int get(uint32_t prob) {
    uint32_t r1 = (range * prob) >> 8;
    range -= r1;
    int bit;
    if (low < range) {
      bit = 0;
    } else {
      low -= range;
      range = r1;
      bit = 1;
    }
    if (range < 0x100) {
      range <<= 8;
      low = (low << 8) | byte();
    }
    return bit;
  }
};

// -------------------------------------------------- symbol (de)binarization --

inline void put_symbol(Enc& e, uint8_t* ctx, int v) {
  if (v == 0) {
    uint8_t s = ctx[0];
    e.put(1, kProb[s]);
    ctx[0] = (s & 1) ? g_mps[s] : kLps[s];  // coded 1: MPS iff state is odd
    return;
  }
  uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v);
  int ebits = 31 - __builtin_clz(mag);

  // zero flag (0), unary exponent (1 x ebits, then 0), mantissa, sign
  int nb = 2 * ebits + 3;
  // decision list: context slot + bit, contexts saturate at 4 (exp) / 6 (mant)
  for (int k = 0; k < nb; ++k) {
    int slot, bit;
    if (k == 0) {
      slot = 0; bit = 0;
    } else if (k <= ebits) {
      slot = k < 4 ? k : 4; bit = 1;
    } else if (k == ebits + 1) {
      slot = k < 4 ? k : 4; bit = 0;
    } else if (k < nb - 1) {
      int j = k - ebits - 2;          // mantissa bit index, MSB first
      slot = j == 0 ? 5 : 6;
      bit = (mag >> (ebits - 1 - j)) & 1;
    } else {
      slot = 7; bit = v < 0;
    }
    uint8_t s = ctx[slot];
    e.put(bit, kProb[s]);
    ctx[slot] = (bit == (s & 1)) ? g_mps[s] : kLps[s];
  }
}

inline int get_symbol(Dec& d, uint8_t* ctx, bool* err) {
  auto rac = [&](int slot) {
    uint8_t s = ctx[slot];
    int bit = d.get(kProb[s]);
    ctx[slot] = (bit == (s & 1)) ? g_mps[s] : kLps[s];
    return bit;
  };
  if (rac(0)) return 0;
  int ebits = 0;
  while (rac(ebits + 1 < 4 ? ebits + 1 : 4)) {
    if (++ebits > 31) { *err = true; return 0; }
  }
  int v = 1;
  for (int j = 0; j < ebits; ++j) v = (v << 1) | rac(j == 0 ? 5 : 6);
  return rac(7) ? -v : v;
}

// ----------------------------------------------------------------- codecs --

struct Ctx {
  int16_t* rows[3];        // planar ring buffer of transformed rows
  uint8_t* model;
};

inline int fold_hash_predict(const int16_t* cur, const int16_t* up,
                             const int16_t* upup, int x, int i, int C, int W,
                             int w, int h, int* predict, bool* negated) {
  int l = w > 0 ? cur[x - C + i] : (h > 0 ? up[x + i] : 128);
  int t = h > 0 ? up[x + i] : l;
  int L = w > 1 ? cur[x - 2 * C + i] : l;
  int tl = (h > 0 && w > 0) ? up[x - C + i] : t;
  int tr = (h > 0 && w < W - 1) ? up[x + C + i] : t;
  int T = h > 1 ? upup[x + i] : t;

  int hash = quant11(l - tl) + 11 * quant11(tl - t) + 121 * quant11(t - tr) +
             605 * quant5(L - l) + 3025 * quant5(T - t);
  *predict = median3(l, l + t - tl, t);
  *negated = hash < 0;
  return hash < 0 ? -hash : hash;
}

}  // namespace

extern "C" {

// The output buffer of the common path: raw + raw/2 + 64 bytes.  Not a
// bound: a stream of noise can pass it.  A stream takes at most
// 24 * raw + 1 bytes (a decision renormalises at most once, each shift
// hands the coder one byte, and a symbol codes at most 23 decisions; the
// port's encode.max_stream_bytes), which is not worth allocating for
// every image.
size_t llct_out_cap(int width, int height, int channels) {
  size_t raw = size_t(width) * height * channels;
  return raw + raw / 2 + 64;
}

// Encode one headerless stream.  Returns the stream's length, or 0 on bad
// arguments; a length above `out_cap` means that only the first `out_cap`
// bytes were written (encode again into a buffer of that length).  `img`
// is uint8 [height, width, channels], C-contiguous.
size_t llct_encode_stream(const uint8_t* img, int width, int height,
                          int channels, uint8_t* out, size_t out_cap,
                          const uint8_t* prior) {
  if (width <= 0 || height <= 0 || channels <= 0) return 0;
  const int C = channels, W = width;
  const size_t stride = size_t(W) * C;

  int16_t* rowbuf = new int16_t[3 * stride]();
  uint8_t* model = new uint8_t[kModelSize];
  init_model(model, prior);
  Sink sink{out, out_cap};
  Enc enc;
  enc.out = &sink;

  const uint8_t* src = img;
  for (int h = 0; h < height; ++h) {
    int16_t* cur = rowbuf + (h % 3) * stride;
    const int16_t* up = rowbuf + ((h + 2) % 3) * stride;
    const int16_t* upup = rowbuf + ((h + 1) % 3) * stride;

    // forward color transform for the whole row first (planar-friendly)
    for (int w = 0; w < W; ++w) {
      const uint8_t* px = src + size_t(w) * C;
      int16_t* dst = cur + size_t(w) * C;
      if (C >= 3) {
        int r = px[0] - px[1];
        int b = px[2] - px[1];
        dst[0] = static_cast<int16_t>(r);
        dst[1] = static_cast<int16_t>(px[1] + tdiv4(b + r));
        dst[2] = static_cast<int16_t>(b);
        for (int i = 3; i < C; ++i) dst[i] = px[i];
      } else {
        for (int i = 0; i < C; ++i) dst[i] = px[i];
      }
    }

    for (int w = 0; w < W; ++w) {
      const int x = w * C;
      for (int i = 0; i < C; ++i) {
        int predict;
        bool negated;
        int hash = fold_hash_predict(cur, up, upup, x, i, C, W, w, h,
                                     &predict, &negated);
        int diff = cur[x + i] - predict;
        put_symbol(enc, model + hash * kSub, negated ? -diff : diff);
      }
    }
    src += stride;
  }
  enc.flush();

  size_t n = sink.pos;
  delete[] rowbuf;
  delete[] model;
  return n;
}

// Decode one headerless stream into uint8 [height, width, channels].
// Returns 0 on success, 1 on corrupt stream.
int llct_decode_stream(const uint8_t* data, size_t len, int width, int height,
                       int channels, uint8_t* out, const uint8_t* prior) {
  if (width <= 0 || height <= 0 || channels <= 0) return 1;
  const int C = channels, W = width;
  const size_t stride = size_t(W) * C;

  int16_t* rowbuf = new int16_t[3 * stride]();
  uint8_t* model = new uint8_t[kModelSize];
  init_model(model, prior);
  Dec dec{data, len};
  dec.init();
  bool err = false;

  uint8_t* dst = out;
  for (int h = 0; h < height && !err; ++h) {
    int16_t* cur = rowbuf + (h % 3) * stride;
    const int16_t* up = rowbuf + ((h + 2) % 3) * stride;
    const int16_t* upup = rowbuf + ((h + 1) % 3) * stride;

    for (int w = 0; w < W; ++w) {
      const int x = w * C;
      for (int i = 0; i < C; ++i) {
        int predict;
        bool negated;
        int hash = fold_hash_predict(cur, up, upup, x, i, C, W, w, h,
                                     &predict, &negated);
        int diff = get_symbol(dec, model + hash * kSub, &err);
        cur[x + i] = static_cast<int16_t>(predict + (negated ? -diff : diff));
      }
      // inverse color transform, guarded on C >= 3 (reference bug fixed)
      uint8_t* px = dst + size_t(w) * C;
      if (C >= 3) {
        int r = cur[x], g = cur[x + 1], b = cur[x + 2];
        g -= tdiv4(r + b);
        r += g;
        b += g;
        px[0] = static_cast<uint8_t>(r < 0 ? 0 : r > 255 ? 255 : r);
        px[1] = static_cast<uint8_t>(g < 0 ? 0 : g > 255 ? 255 : g);
        px[2] = static_cast<uint8_t>(b < 0 ? 0 : b > 255 ? 255 : b);
        for (int i = 3; i < C; ++i) px[i] = static_cast<uint8_t>(cur[x + i]);
      } else {
        for (int i = 0; i < C; ++i) {
          int v = cur[x + i];
          px[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
        }
      }
    }
    dst += stride;
  }

  delete[] rowbuf;
  delete[] model;
  return err ? 1 : 0;
}

// Batch decode: n streams -> n images of identical geometry, spread over
// worker threads (each stream is independent; this is the host-side analog
// of the device's lane parallelism, used for production CPU decode).
struct BatchJob {
  const uint8_t* const* datas;
  const size_t* lens;
  uint8_t* const* outs;
  int width, height, channels, n;
  const uint8_t* prior;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
};

int llct_decode_batch(const uint8_t* const* datas, const size_t* lens, int n,
                      int width, int height, int channels,
                      uint8_t* const* outs, int n_threads,
                      const uint8_t* prior) {
  if (n_threads < 1) n_threads = 1;
  BatchJob job{datas, lens, outs, width, height, channels, n, prior};
  auto worker = [&job]() {
    for (;;) {
      int i = job.next.fetch_add(1);
      if (i >= job.n) break;
      if (llct_decode_stream(job.datas[i], job.lens[i], job.width, job.height,
                             job.channels, job.outs[i], job.prior) != 0)
        job.failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return job.failures.load();
}

// Batch encode twin: n images -> n streams (written into caller buffers of
// `cap` bytes each; out_lens receives each stream's length, 0 on bad
// arguments, above `cap` where the stream did not fit its buffer).
struct EncJob {
  const uint8_t* const* imgs;
  uint8_t* const* outs;
  size_t* out_lens;
  size_t cap;
  int width, height, channels, n;
  const uint8_t* prior;
  std::atomic<int> next{0};
};

void llct_encode_batch(const uint8_t* const* imgs, int n, int width,
                       int height, int channels, uint8_t* const* outs,
                       size_t cap, size_t* out_lens, int n_threads,
                       const uint8_t* prior) {
  if (n_threads < 1) n_threads = 1;
  EncJob job{imgs, outs, out_lens, cap, width, height, channels, n, prior};
  auto worker = [&job]() {
    for (;;) {
      int i = job.next.fetch_add(1);
      if (i >= job.n) break;
      job.out_lens[i] = llct_encode_stream(
          job.imgs[i], job.width, job.height, job.channels, job.outs[i],
          job.cap, job.prior);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Expand encoder slot records (meta = emit | carry<<1 | head<<8, plus run
// lengths) into the byte stream; the device scan's host-side tail.
size_t llct_expand_slots(const int32_t* meta, const int32_t* runs, size_t n,
                         uint8_t* out, size_t cap) {
  size_t p = 0;
  for (size_t k = 0; k < n; ++k) {
    int32_t m = meta[k];
    if (!(m & 1)) continue;
    uint8_t fill = (m & 2) ? 0x00 : 0xFF;
    size_t need = 1 + static_cast<size_t>(runs[k]);
    if (p + need > cap) return 0;
    out[p++] = static_cast<uint8_t>((m >> 8) & 0xFF);
    for (int32_t r = 0; r < runs[k]; ++r) out[p++] = fill;
  }
  return p;
}

}  // extern "C"
