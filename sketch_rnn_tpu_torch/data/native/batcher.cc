// Native batch assembler: the host loop of the input pipeline.
//
// The port's own copy of the JAX package's C++ batcher (ABI 4): the same
// arithmetic, random stream and rounding, so the same inputs and seed
// give the same bits. Train-time augmentation (per-axis scale jitter and
// point dropout), stroke-3 -> padded stroke-5 conversion and batch
// packing run as one (optionally multi-threaded) loop per batch instead
// of a Python loop of small numpy ops. A ctypes call into the library
// runs without the GIL, so the prefetch thread's assembly does not hold
// up the training loop's thread.
//
// C ABI (used from Python via ctypes, see ../native_batcher.py):
//
//   assemble_batch(seq_data, seq_lens, n, max_len, out)
//       the eval-path entry: no augmentation. Bit for bit
//       native_batcher.pad_batch_numpy (the numpy layout).
//
//   assemble_batch_aug(seq_data, seq_lens, n, max_len, scale_factor,
//                      drop_prob, seed, n_threads, out, out_lens)
//       the train-path entry: per-sequence augmentation THEN packing.
//       - scale_factor > 0: each sequence's dx (dy) is multiplied by an
//         independent uniform draw from [1-f, 1+f] (strokes.random_scale
//         semantics).
//       - drop_prob > 0: pen-down points whose two predecessors are also
//         pen-down are merged into the previous point with probability
//         drop_prob (strokes.augment_strokes semantics: offsets summed,
//         so the drawing is unchanged; pen-lift structure preserved).
//       - seed: batch-level RNG seed. Each sequence uses an independent
//         splitmix64 stream seeded by (seed, index), so results are
//         deterministic in (seed, index) and INDEPENDENT of n_threads.
//         Distributionally equivalent to the numpy path, different bits.
//       - n_threads: sequences are chunked across std::threads (<=1 or
//         n small: serial). Output rows are disjoint per sequence.
//       - out_lens: int32[n], the post-augmentation lengths.
//
//   assemble_batch_aug_i16(..., n_threads, quant, out, out_lens)
//       the same, offsets quantized to int16 data units (below).
//
//   seq_data    flattened float32 stroke-3 rows (dx, dy, pen) of all n
//               sequences, concatenated in order
//   seq_lens    int32[n] row counts per sequence
//   n           batch size
//   max_len     padded sequence length (excluding the start token)
//   out         [n, max_len + 1, 5], written fully
//
// Output layout per sequence (start token at t=0):
//   row 0:                  (0, 0, 1, 0, 0)   start token
//   rows 1..len:            (dx, dy, 1-p, p, 0)
//   rows len+1..max_len:    (0, 0, 0, 0, 1)   end-of-sketch padding
//
// Build: g++ -O3 -shared -fPIC -pthread (../native_batcher.py, at first
// use, into build/native/ at the repository root).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality counter-based PRNG — each (seed, index)
// pair is an independent stream, which is what makes the augmentation
// deterministic under any thread count.
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t s) : state(s) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// Output writers: float passthrough, or int16 quantization back to data
// units (offset * quant, round-half-even like numpy rint so the numpy path
// is bit-identical; pen/pad values are exact small integers).
template <typename OutT>
inline OutT quantize(float v, float quant);
template <>
inline float quantize<float>(float v, float) { return v; }
template <>
inline int16_t quantize<int16_t>(float v, float quant) {
  float r = nearbyintf(v * quant);
  if (r > 32767.f) r = 32767.f;
  if (r < -32767.f) r = -32767.f;
  return static_cast<int16_t>(r);
}

// Pen columns: float keeps the source arithmetic bit-identical to the
// numpy path; int16 writes exact 0/1.
template <typename OutT>
inline OutT pen_down(float pen);
template <>
inline float pen_down<float>(float pen) { return 1.f - pen; }
template <>
inline int16_t pen_down<int16_t>(float pen) { return pen >= 0.5f ? 0 : 1; }
template <typename OutT>
inline OutT pen_up(float pen);
template <>
inline float pen_up<float>(float pen) { return pen; }
template <>
inline int16_t pen_up<int16_t>(float pen) { return pen >= 0.5f ? 1 : 0; }

// One sequence: augment (optional) then pack into its output rows.
// Returns the post-augmentation length. ``quant`` is only read by the
// int16 instantiation (offsets leave as integer data units).
template <typename OutT>
int32_t process_one(const float* src, int32_t len, int32_t max_len,
                    float scale_factor, float drop_prob, uint64_t seed,
                    int64_t index, OutT* dst, float* scratch,
                    float quant) {
  const int32_t row = 5;
  SplitMix64 rng(seed * 0x2545f4914f6cdd1dull + 0x9e3779b97f4a7c15ull
                 + static_cast<uint64_t>(index));

  float sx = 1.f, sy = 1.f;
  if (scale_factor > 0.f) {
    sx = static_cast<float>(rng.uniform() * 2.0 - 1.0) * scale_factor + 1.f;
    sy = static_cast<float>(rng.uniform() * 2.0 - 1.0) * scale_factor + 1.f;
  }

  // point-dropout into scratch (stroke-3), merging dropped offsets into
  // the previous kept point; mirrors strokes.augment_strokes exactly
  // (candidates need >2 consecutive pen-down predecessors and a kept
  // previous point).
  const float* s3 = src;
  int32_t out_len = len;
  if (drop_prob > 0.f) {
    int32_t kept = 0;
    float prev_pen = 0.f;
    int32_t count = 0;
    bool have_prev = false;
    for (int32_t i = 0; i < len; ++i) {
      const float dx = src[3 * i], dy = src[3 * i + 1], pen = src[3 * i + 2];
      if (pen >= 0.5f || prev_pen >= 0.5f) {
        count = 0;
      } else {
        ++count;
      }
      const bool check = pen < 0.5f && prev_pen < 0.5f && count > 2;
      if (check && have_prev && rng.uniform() < drop_prob) {
        scratch[3 * (kept - 1)] += dx;
        scratch[3 * (kept - 1) + 1] += dy;
      } else {
        scratch[3 * kept] = dx;
        scratch[3 * kept + 1] = dy;
        scratch[3 * kept + 2] = pen;
        ++kept;
        prev_pen = pen;
        have_prev = true;
      }
    }
    s3 = scratch;
    out_len = kept;
  }

  // pack: start token, stroke-5 rows (with the scale jitter applied on
  // the fly), end-of-sketch padding
  dst[0] = OutT(0); dst[1] = OutT(0); dst[2] = OutT(1);
  dst[3] = OutT(0); dst[4] = OutT(0);
  OutT* p = dst + row;
  for (int32_t t = 0; t < out_len; ++t, p += row) {
    const float pen = s3[3 * t + 2];
    p[0] = quantize<OutT>(s3[3 * t] * sx, quant);
    p[1] = quantize<OutT>(s3[3 * t + 1] * sy, quant);
    p[2] = pen_down<OutT>(pen);
    p[3] = pen_up<OutT>(pen);
    p[4] = OutT(0);
  }
  for (int32_t t = out_len; t < max_len; ++t, p += row) {
    p[0] = OutT(0); p[1] = OutT(0); p[2] = OutT(0);
    p[3] = OutT(0); p[4] = OutT(1);
  }
  return out_len;
}

// Shared augment+pack driver (float and int16 instantiations).
template <typename OutT>
int assemble_aug_impl(const float* seq_data, const int32_t* seq_lens,
                      int32_t n, int32_t max_len, float scale_factor,
                      float drop_prob, uint64_t seed, int32_t n_threads,
                      OutT* out, int32_t* out_lens, float quant) {
  const int32_t row = 5;
  const int64_t per_seq = static_cast<int64_t>(max_len + 1) * row;

  // per-sequence source offsets (prefix sum; sequences vary in length)
  std::vector<int64_t> offsets(n + 1, 0);
  for (int32_t i = 0; i < n; ++i) {
    const int32_t len = seq_lens[i];
    if (len < 0 || len > max_len) return -1;
    offsets[i + 1] = offsets[i] + 3 * static_cast<int64_t>(len);
  }

  auto work = [&](int32_t lo, int32_t hi) {
    std::vector<float> scratch(3 * static_cast<size_t>(max_len));
    for (int32_t i = lo; i < hi; ++i) {
      out_lens[i] = process_one<OutT>(
          seq_data + offsets[i], seq_lens[i], max_len, scale_factor,
          drop_prob, seed, i, out + i * per_seq, scratch.data(), quant);
    }
  };

  int32_t threads = n_threads;
  const int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (threads <= 0) threads = hw > 0 ? hw : 1;
  if (threads > n) threads = n;
  // cap by total work so thread create/join (~tens of us each) never
  // rivals the packing itself on many-core hosts: one thread per ~64k
  // source points (~a millisecond of work each)
  const int64_t total_points = offsets[n] / 3;
  const int32_t by_work = static_cast<int32_t>(total_points / 65536) + 1;
  if (threads > by_work) threads = by_work;
  if (threads <= 1 || n < 64) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  const int32_t chunk = (n + threads - 1) / threads;
  for (int32_t t = 0; t < threads; ++t) {
    const int32_t lo = t * chunk;
    const int32_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // namespace

extern "C" {

int assemble_batch(const float* seq_data,
                   const int32_t* seq_lens,
                   int32_t n,
                   int32_t max_len,
                   float* out) {
  const int32_t row = 5;
  const int64_t per_seq = static_cast<int64_t>(max_len + 1) * row;
  const float* src = seq_data;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t len = seq_lens[i];
    if (len < 0 || len > max_len) return -1;  // caller filtered; guard anyway
    float* dst = out + i * per_seq;
    // start token
    dst[0] = 0.f; dst[1] = 0.f; dst[2] = 1.f; dst[3] = 0.f; dst[4] = 0.f;
    float* p = dst + row;
    for (int32_t t = 0; t < len; ++t, p += row, src += 3) {
      const float pen = src[2];
      p[0] = src[0];
      p[1] = src[1];
      p[2] = 1.f - pen;
      p[3] = pen;
      p[4] = 0.f;
    }
    for (int32_t t = len; t < max_len; ++t, p += row) {
      p[0] = 0.f; p[1] = 0.f; p[2] = 0.f; p[3] = 0.f; p[4] = 1.f;
    }
  }
  return 0;
}

int assemble_batch_aug(const float* seq_data,
                       const int32_t* seq_lens,
                       int32_t n,
                       int32_t max_len,
                       float scale_factor,
                       float drop_prob,
                       uint64_t seed,
                       int32_t n_threads,
                       float* out,
                       int32_t* out_lens) {
  return assemble_aug_impl<float>(seq_data, seq_lens, n, max_len,
                                  scale_factor, drop_prob, seed, n_threads,
                                  out, out_lens, 0.f);
}

// int16 variant (the exact-transfer feed path): same augmentation and
// packing, offsets quantized back to integer data units by ``quant``
// (the corpus normalization scale) in the same native pass — the host
// never touches the batch again, so int16 transfer adds no Python-side
// work. scale_factor=0 / drop_prob=0 gives the no-augmentation path.
int assemble_batch_aug_i16(const float* seq_data,
                           const int32_t* seq_lens,
                           int32_t n,
                           int32_t max_len,
                           float scale_factor,
                           float drop_prob,
                           uint64_t seed,
                           int32_t n_threads,
                           float quant,
                           int16_t* out,
                           int32_t* out_lens) {
  if (!(quant > 0.f)) return -1;
  return assemble_aug_impl<int16_t>(seq_data, seq_lens, n, max_len,
                                    scale_factor, drop_prob, seed,
                                    n_threads, out, out_lens, quant);
}

// Version tag so the Python side can detect a stale shared object.
int batcher_abi_version() { return 4; }

}  // extern "C"
