// The fixed-order weight-gradient pass shared by the training kernels of
// the PyTorch port (fused_rnn.cu, lstm_seq.cu, probe_ln.cu). It replaces
// the weight-gradient sums the Pallas kernels take in their own bodies
// (sketch_rnn_tpu/ops/pallas_fused.py:327, :332, :684, :689, :957, :961;
// pallas_lstm.py:139; scripts/probe_dec_bwd_split.py:230, :234):
//
//   [dwx; dwh; db] (R = D + H + ones rows, G = 4H columns)
//     = sum over k = t*B + b of A[k, r] * dpre[k, n],
//   A[k] = [xs[t, b]; h_{t-1}[b] (h0 rounded to RT at t = 0); 1],
//
// the x and h entries rounded to W; dpre rounded to W for the dwx/dwh rows
// and taken unrounded by the row of ones (db). No atomics: every result is
// the same bit for bit on every run, on any card.
//
// The operands in general (WgArgs): the left operand's rows are the extra
// rows x [K, D] (none when D = 0), then the main rows, a list of two row
// sources read in place (WgSrc: a float stream, or a stored residual
// shifted by one step whose first rows come from the initial carry), then
// an optional row of ones; the right operand is the first N columns of any
// float stream of row stride ldb. The LSTM backwards' pass is the case
// [x; h_{t-1}; 1] x d_pre (wg_lstm_args); the HyperLSTM backward's eleven
// matrix gradients (fused_hyper.cu) are other cases. The rounding is the
// launch's: launch_weight_grad_pass<bf16> rounds both operands to bf16 on
// the tensor cores, <float> keeps them (the HyperLSTM's float x float zd
// products at either dtype). The partials of a product are [slices, D +
// M + ones, ldp] floats, ldp = N rounded up to a multiple of 4.
//
// Design (launch_weight_grad_pass). Split-K on a fixed plan: K is cut into
// `slices` slices of `kslice` rows (the last one shorter), chosen by the
// caller from the shape alone (cuda_fused.weight_grad_plan), never from the
// card. Block (row tile, column tile, slice) computes one 128 x 128 tile of
// its slice's partial sums into part[slice, R, G]; a second launch adds the
// slices in slice order 0 ... slices-1 into dwx, dwh and db. The row tiles
// are the h rows (H / 128 of them), then the extra rows in tiles of their
// own; the warps of a tile whose rows run out skip their products. The A
// operand is K-major and contiguous (h0, then hs shifted down by B rows),
// so its tiles are 16-byte copies.
//  - bf16 (W = bf16): the tensor cores, mma.sync m16n8k16 with float sums;
//    a product of two bf16 values is exact in float, so only the order of
//    the float sums differs from the plain version. 8 warps of 64 x 32
//    outputs, k in chunks of 32, two buffers. hs arrives by cp.async; the
//    float d_pre chunk is loaded into registers while the chunk before is
//    multiplied and rounded to bf16 once, as it is stored for ldmatrix (a
//    cp.async of floats would need a second pass through shared memory to
//    round them). The x rows are an extra row tile that runs the same loop,
//    so it reads each d_pre chunk from L2 at the h tiles' pace; db is a
//    float column sum of the unrounded d_pre its threads hold, in a fixed
//    order.
//  - float (W = float): a register-tiled SIMT product (no TF32: it would
//    round operands the float contract keeps), 256 threads of 8 x 8
//    outputs, float4 reads of shared memory, k in chunks of 16 arriving by
//    cp.async into two buffers. The extra rows [x; 1] (6 at the decoders'
//    shapes) ride with row tile 0, from the d_pre chunk it already holds:
//    as a row tile of their own they held a block, its only warp at work,
//    one chunk in flight, for most of an h tile's time (PERF.md).
// Bound on the H100 at the decoder's shape (B=100, T=250, H=512, D=5):
// 52.9 GFLOP; bf16 0.054 ms at 989 TFLOP/s, below the 0.070 ms its bytes
// take (the 204.8 MB float d_pre read once at 3.35 TB/s): bound by bytes;
// float 0.79 ms at 67 TFLOP/s: bound by operations. Each row tile re-reads
// d_pre (5 at H=512 for bf16, 4 for float), mostly from L2. PERF.md keeps
// the measured times.
// The old pass (weight_grad_tiled_kernel: one 64 x 64 tile per block over
// all of K, SIMT at both dtypes) stays for the A/B entry srt_weight_grad
// only.

#pragma once

#include <type_traits>

#include "mma.cuh"
#include "rnn_common.cuh"

namespace {

// The split-K plan: slice s covers [s * kslice, min((s + 1) * kslice, K));
// part holds the slices' partial sums, [slices, R, 4H] floats.
struct WgPlan {
  int slices, kslice;
  float* part;
};

// One row source of the left operand, A[k, r] for r < rows: a float
// stream f[k * ld + r] (rs null), or a stored residual shifted by `shift`
// rows, rnd_RT(first[k * ld + r]) for k < shift and rs[(k - shift) * ld +
// r] after (h_{t-1} gathered from h0 and hs in place).
template <typename RT>
struct WgSrc {
  const float* f;
  const RT* rs;
  const float* first;
  int ld, shift, rows;
};

template <typename RT>
struct WgArgs {
  const float* xs;    // [K, D] extra rows (unused when D = 0)
  WgSrc<RT> src[2];   // the main rows: src[0].rows, then src[1].rows
  const float* dpre;  // the right operand, [K, ldb], its first N columns
  int K, D, ones, ldb, N;
  WgPlan plan;
  float* dwx;     // [D, N] or null when D = 0
  float* dwh[2];  // [src[i].rows, N] (null where src[i].rows = 0)
  float* db;      // [N] or null when ones = 0
};

// The LSTM backwards' pass: [dwx; dwh; db] = [x; h_{t-1}; 1]^T d_pre
template <typename RT>
WgArgs<RT> wg_lstm_args(const float* xs, const float* h0, const RT* hs,
                        const float* dpre, int T, int B, int D, int H,
                        int ones, WgPlan plan, float* dwx, float* dwh,
                        float* db) {
  WgArgs<RT> a;
  a.xs = xs;
  a.src[0] = {nullptr, hs, h0, H, B, H};
  a.src[1] = {nullptr, nullptr, nullptr, 0, 0, 0};
  a.dpre = dpre;
  a.K = T * B;
  a.D = D;
  a.ones = ones;
  a.ldb = 4 * H;
  a.N = 4 * H;
  a.plan = plan;
  a.dwx = dwx;
  a.dwh[0] = dwh;
  a.dwh[1] = nullptr;
  a.db = db;
  return a;
}

// the main rows of a pass
template <typename RT>
__host__ __device__ __forceinline__ int wg_main(const WgArgs<RT>& a) {
  return a.src[0].rows + a.src[1].rows;
}

// the partials' row stride
__host__ __device__ __forceinline__ int wg_ldp(int N) { return (N + 3) / 4 * 4; }

constexpr int kWgTile = 128, kWgThreads = 256;
constexpr int kWgChunkBf = 32, kWgChunkF = 16;  // k rows per step
// At float, at most this many extra rows (x, and the row of ones) ride
// with row tile 0; more take row tiles of their own, as at bf16.
constexpr int kWgFold = 8;

// Row tiles: the h rows, then the extra rows' own (x; at float the ones)
__host__ __device__ __forceinline__ int wg_h_tiles(int H) {
  return (H + kWgTile - 1) / kWgTile;
}

// bf16 adds db's column sums in the first extra tile (a tile of its own
// when D = 0); float folds up to kWgFold extra rows into row tile 0 (a
// tile of their own where there are no main rows)
template <typename W>
__host__ __device__ __forceinline__ int wg_row_tiles(int D, int H,
                                                     int ones) {
  const int extra = sizeof(W) == 2 ? (D > ones ? D : ones)
                    : (D + ones <= kWgFold && H > 0 ? 0 : D + ones);
  return wg_h_tiles(H) + (extra + kWgTile - 1) / kWgTile;
}

template <typename RT>
__device__ __forceinline__ float wg_src(const WgSrc<RT>& s, int k, int r) {
  if (s.rs == nullptr) return s.f[(size_t)k * s.ld + r];
  return k < s.shift ? rnd<RT>(s.first[(size_t)k * s.ld + r])
                     : to_f(s.rs[(size_t)(k - s.shift) * s.ld + r]);
}

// A[k, j] of the main rows (j < wg_main); the LSTM form (kGen false) has
// one residual source
template <bool kGen, typename RT>
__device__ __forceinline__ float wg_h(const WgArgs<RT>& a, int k, int j) {
  if constexpr (!kGen) {
    const int B = a.src[0].shift, H = a.src[0].ld;
    return k < B ? rnd<RT>(a.src[0].first[(size_t)k * H + j])
                 : to_f(a.src[0].rs[(size_t)(k - B) * H + j]);
  } else {
    return j < a.src[0].rows ? wg_src(a.src[0], k, j)
                             : wg_src(a.src[1], k, j - a.src[0].rows);
  }
}

// Whether a source's rows take 16-byte copies: a stored residual (or, kF,
// a float stream) whose rows are 16-byte aligned. Checked once a kernel,
// by value: taking a kernel argument's address would move it to local
// memory.
template <bool kF, typename RT>
__device__ __forceinline__ bool wg_vec_ok(const WgSrc<RT> s) {
  constexpr int kE = kF ? 4 : 16 / (int)sizeof(RT);
  const void* p = kF ? (const void*)s.f : (const void*)s.rs;
  const bool typed = kF ? s.rs == nullptr && s.f != nullptr : s.rs != nullptr;
  return typed && s.ld % kE == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename RT>
__device__ __forceinline__ bool wg_aligned16(const RT* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// bf16: 8 warps as 2 (rows) x 4 (columns) of 64 x 32 outputs. kGen: the
// general operands; else the LSTM form, compiled as it was before them.
template <typename RT, bool kGen>
__global__ void __launch_bounds__(kWgThreads, 2)
weight_grad_mma_kernel(WgArgs<RT> a) {
  constexpr int BK = kWgChunkBf, P = kWgTile + 8;
  __shared__ __align__(16) bf16 sA[2][BK][P];  // [k][row]
  __shared__ __align__(16) bf16 sB[2][BK][P];  // [k][column]
  const int H = kGen ? wg_main(a) : a.src[0].rows, D = a.D, K = a.K;
  const int G = kGen ? a.N : 4 * H, ldp = kGen ? wg_ldp(G) : G;
  const int ldb = kGen ? a.ldb : G;
  const int nh = wg_h_tiles(H), mt = blockIdx.x;
  const bool xtile = mt >= nh;
  const int r0 = (xtile ? mt - nh : mt) * kWgTile;
  const int mrows = min(kWgTile, (xtile ? D : H) - r0);  // <= 0: db only
  const bool sums = a.ones && mt == nh;  // the first x tile adds db
  const int n0 = blockIdx.y * kWgTile, s = blockIdx.z;
  const int kbeg = s * a.plan.kslice, kend = min(K, kbeg + a.plan.kslice);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  // 16-byte copies of bf16 residual rows, per main source
  const bool vec0 =
      !xtile && sizeof(RT) == 2 &&
      (kGen ? wg_vec_ok<false>(a.src[0])
            : H % 8 == 0 && wg_aligned16(a.src[0].rs));
  const bool vec1 =
      kGen && !xtile && sizeof(RT) == 2 && wg_vec_ok<false>(a.src[1]);
  const int M0 = a.src[0].rows;
  // A: 8 rows of one k per piece, two pieces per thread
  auto load_a = [&](int k0, int buf) {
    if (mrows <= 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kWgThreads;
      const int kk = c >> 4, mm = (c & 15) * 8;
      const int k = k0 + kk, r = r0 + mm;
      bf16* dst = &sA[buf][kk][mm];
      // bf16 residuals are bf16 already: copied as they are
      if (vec0 && k >= a.src[0].shift && k < kend && r + 8 <= M0) {
        cp_async16(dst, a.src[0].rs + (size_t)(k - a.src[0].shift) *
                                          a.src[0].ld + r);
        continue;
      }
      if (vec1 && k >= a.src[1].shift && k < kend && r >= M0 &&
          r + 8 <= H) {
        cp_async16(dst, a.src[1].rs + (size_t)(k - a.src[1].shift) *
                                          a.src[1].ld + r - M0);
        continue;
      }
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f = 0.0f;
        if (k < kend && r + e < (xtile ? D : H))
          f = xtile ? a.xs[(size_t)k * D + r + e] : wg_h<kGen>(a, k, r + e);
        v[e] = __float2bfloat16_rn(f);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  };
  // d_pre: 4 columns of one k per piece, four pieces per thread; thread
  // tid always holds columns (tid % 32) * 4 + 0..3 of rows tid / 32 + 8 i
  float4 rb[4];
  float dbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int bn = (tid & 31) * 4;
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + (tid >> 5) + 8 * i, n = n0 + bn;
      rb[i] = (k < kend && n < G)
                  ? __ldg(reinterpret_cast<const float4*>(
                        a.dpre + (size_t)k * ldb + n))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store_b = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = rb[i];
      if (sums) {  // unrounded, in k order
        dbs[0] += v.x;
        dbs[1] += v.y;
        dbs[2] += v.z;
        dbs[3] += v.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(&sB[buf][(tid >> 5) + 8 * i][bn]) = packed;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (kbeg < kend) {
    load_a(kbeg, 0);
    load_b(kbeg);
    cp_async_commit();
    store_b(0);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
      const bool more = k0 + BK < kend;
      if (more) {
        load_a(k0 + BK, buf ^ 1);
        load_b(k0 + BK);
      }
      cp_async_commit();
      if (wm < mrows) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t bfr[4][2];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                r, &sB[buf][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                      [wn + jp * 16 + (lane >> 4) * 8]);
            bfr[2 * jp][0] = r[0];
            bfr[2 * jp][1] = r[1];
            bfr[2 * jp + 1][0] = r[2];
            bfr[2 * jp + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (wm + i * 16 >= mrows) continue;
            // A (16 rows x 16 k) from the k-major tile, transposed
            uint32_t af[4];
            ldmatrix_x4_trans(
                af, &sA[buf][kk + (lane & 7) + (lane >> 4) * 8]
                       [wm + i * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
          }
        }
      }
      if (more) store_b(buf ^ 1);
      cp_async_wait_all();
      __syncthreads();
      buf ^= 1;
    }
  }

  // accumulator (i, j): rows wm + 16 i + lane / 4 (+ 8), columns
  // wn + 8 j + 2 (lane % 4) (+ 1); rows of part in [x; h; 1] order
  float* part = a.plan.part + (size_t)s * (D + H + a.ones) * ldp;
  const int rbase = xtile ? r0 : D + r0;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = wm + i * 16 + gr + hh * 8;
      if (row >= mrows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + gc;
        if (n < G)
          *reinterpret_cast<float2*>(part + (size_t)(rbase + row) * ldp + n) =
              make_float2(acc[i][j][hh * 2], acc[i][j][hh * 2 + 1]);
      }
    }
  if (sums) {  // the 8 warps' column sums, added in warp order
    float* red = reinterpret_cast<float*>(&sA[0][0][0]);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) red[warp * kWgTile + bn + q] = dbs[q];
    __syncthreads();
    if (tid < kWgTile && n0 + tid < G) {
      float v = 0.0f;
      for (int w = 0; w < kWgThreads / 32; ++w) v += red[w * kWgTile + tid];
      part[(size_t)(D + H) * ldp + n0 + tid] = v;
    }
  }
}

// float: 256 threads of 8 x 8 outputs, rows ty * 4 + 0..3 and 64 + ty * 4
// + 0..3, columns tx * 4 + 0..3 and 64 + tx * 4 + 0..3; warp w holds rows
// 8 w .. 8 w + 7 and 64 + 8 w .. 64 + 8 w + 7. Row tile 0 also sums the
// extra rows [x; 1] when they fold: warp w the row w, each thread 4
// columns, from the d_pre tile already in shared memory. kGen as above.
template <typename RT, bool kGen>
__global__ void __launch_bounds__(kWgThreads, 2)
weight_grad_simt_kernel(WgArgs<RT> a) {
  constexpr int BK = kWgChunkF;
  __shared__ __align__(16) float sA[2][BK][kWgTile];  // [k][row]
  __shared__ __align__(16) float sB[2][BK][kWgTile];  // [k][column]
  __shared__ __align__(16) float sX[2][BK][kWgFold];  // [k][folded row]
  const int H = kGen ? wg_main(a) : a.src[0].rows, D = a.D, K = a.K;
  const int G = kGen ? a.N : 4 * H, ldp = kGen ? wg_ldp(G) : G;
  const int nh = wg_h_tiles(H), mt = blockIdx.x;
  const bool xtile = mt >= nh;  // only when the extra rows do not fold
  const bool xfold =
      nh > 0 && D + a.ones <= kWgFold && mt == 0 && D + a.ones > 0;
  const int r0 = (xtile ? mt - nh : mt) * kWgTile;
  const int mrows = min(kWgTile, (xtile ? D + a.ones : H) - r0);
  const int n0 = blockIdx.y * kWgTile, s = blockIdx.z;
  const int kbeg = s * a.plan.kslice, kend = min(K, kbeg + a.plan.kslice);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5;
  const bool lo = 8 * warp < mrows, hi = 64 + 8 * warp < mrows;
  const bool vec_b = !kGen || (a.ldb % 4 == 0 && wg_aligned16(a.dpre));
  // 16-byte copies of float rows, per main source: stored residuals (when
  // RT is float) past their shift, (kGen) float streams
  const bool res0 =
      !xtile && sizeof(RT) == 4 &&
      (kGen ? wg_vec_ok<false>(a.src[0])
            : H % 4 == 0 && wg_aligned16(a.src[0].rs));
  const bool res1 =
      kGen && !xtile && sizeof(RT) == 4 && wg_vec_ok<false>(a.src[1]);
  const bool str0 = kGen && !xtile && wg_vec_ok<true>(a.src[0]);
  const bool str1 = kGen && !xtile && wg_vec_ok<true>(a.src[1]);
  const int M0 = a.src[0].rows;
  // the value of extra row e (x, then the row of ones) at row-step k
  auto extra = [&](int k, int e) {
    return e < D ? a.xs[(size_t)k * D + e] : (e == D && a.ones ? 1.0f : 0.0f);
  };
  // 4 rows (columns) of one k per piece, two pieces per thread and tile;
  // the folded rows, one piece each for threads 0-31
  auto load = [&](int k0, int buf) {
    if (xfold && tid < 2 * BK) {
      const int k = k0 + (tid >> 1), e0 = (tid & 1) * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = k < kend ? extra(k, e0 + e) : 0.0f;
      *reinterpret_cast<float4*>(&sX[buf][tid >> 1][e0]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kWgThreads;
      const int kk = c >> 5, mm = (c & 31) * 4;
      const int k = k0 + kk, r = r0 + mm, n = n0 + mm;
      float* dst = &sB[buf][kk][mm];
      if (!kGen) {
        if (k < kend && n < G)
          cp_async16(dst, a.dpre + (size_t)k * G + n);
        else
          *reinterpret_cast<float4*>(dst) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if (vec_b && k < kend && n + 4 <= G) {
        cp_async16(dst, a.dpre + (size_t)k * a.ldb + n);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (k < kend && n + e < G) ? a.dpre[(size_t)k * a.ldb + n + e]
                                         : 0.0f;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
      dst = &sA[buf][kk][mm];
      if (!kGen) {
        if (res0 && k >= a.src[0].shift && k < kend && r + 4 <= H) {
          cp_async16(dst, a.src[0].rs + (size_t)(k - a.src[0].shift) * H + r);
          continue;
        }
      } else if (k < kend && r + 4 <= M0) {
        if (res0 && k >= a.src[0].shift) {
          cp_async16(dst, a.src[0].rs + (size_t)(k - a.src[0].shift) *
                                            a.src[0].ld + r);
          continue;
        }
        if (str0) {
          cp_async16(dst, a.src[0].f + (size_t)k * a.src[0].ld + r);
          continue;
        }
      } else if (k < kend && r >= M0 && r + 4 <= H) {
        if (res1 && k >= a.src[1].shift) {
          cp_async16(dst, a.src[1].rs + (size_t)(k - a.src[1].shift) *
                                            a.src[1].ld + r - M0);
          continue;
        }
        if (str1) {
          cp_async16(dst, a.src[1].f + (size_t)k * a.src[1].ld + r - M0);
          continue;
        }
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.0f;
        if (k >= kend) continue;
        if (xtile)
          v[e] = extra(k, r + e);
        else if (r + e < H)
          v[e] = wg_h<kGen>(a, k, r + e);
      }
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
    cp_async_commit();
  };

  float acc[8][8], xacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int xn = (tid & 31) * 4;  // the folded row's columns
  // one chunk's products; HI: the warp's upper rows hold outputs too
  auto chunk = [&](int buf, auto hi_rows) {
    constexpr bool HI = decltype(hi_rows)::value;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sB[buf][kk][64 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float al[4] = {a0.x, a0.y, a0.z, a0.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(al[i], bv[j], acc[i][j]);
      if (HI) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sA[buf][kk][64 + ty * 4]);
        const float ah[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[4 + i][j] = fmaf(ah[i], bv[j], acc[4 + i][j]);
      }
    }
  };

  if (kbeg < kend) {
    load(kbeg, 0);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
      if (k0 + BK < kend) load(k0 + BK, buf ^ 1);
      if (hi)
        chunk(buf, std::true_type{});
      else if (lo)
        chunk(buf, std::false_type{});
      if (xfold) {
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const float xv = sX[buf][kk][warp];
          const float4 b =
              *reinterpret_cast<const float4*>(&sB[buf][kk][xn]);
          xacc[0] = fmaf(xv, b.x, xacc[0]);
          xacc[1] = fmaf(xv, b.y, xacc[1]);
          xacc[2] = fmaf(xv, b.z, xacc[2]);
          xacc[3] = fmaf(xv, b.w, xacc[3]);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      buf ^= 1;
    }
  }

  // rows of part in [x; h; 1] order: the extra tile's row D is the ones
  float* part = a.plan.part + (size_t)s * (D + H + a.ones) * ldp;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
    if (row >= mrows) continue;
    const int e = r0 + row;
    const size_t pr = xtile ? (e < D ? e : (size_t)D + H) : (size_t)D + e;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int n = n0 + h2 * 64 + tx * 4;
      if (n < G)
        *reinterpret_cast<float4*>(part + pr * ldp + n) =
            make_float4(acc[i][h2 * 4], acc[i][h2 * 4 + 1],
                        acc[i][h2 * 4 + 2], acc[i][h2 * 4 + 3]);
    }
  }
  if (xfold && warp < D + a.ones && n0 + xn < G) {
    const size_t pr = warp < D ? warp : (size_t)D + H;
    *reinterpret_cast<float4*>(part + pr * ldp + n0 + xn) =
        make_float4(xacc[0], xacc[1], xacc[2], xacc[3]);
  }
}

// [dwx; dwh; db] = the slices' partials added in slice order (rows of the
// partials in [x; main; 1] order, ldp floats each; N columns of them kept)
template <typename RT, bool kGen>
__global__ void weight_grad_sum_kernel(WgArgs<RT> a) {
  const int D = a.D, M0 = a.src[0].rows, M = kGen ? wg_main(a) : M0;
  const int G = kGen ? a.N : 4 * M0, ldp = kGen ? wg_ldp(G) : G;
  const float4* part = reinterpret_cast<const float4*>(a.plan.part);
  const size_t n4 = (size_t)(D + M + a.ones) * ldp / 4;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += (size_t)gridDim.x * blockDim.x) {
    float4 v = part[q];
    for (int sl = 1; sl < a.plan.slices; ++sl) {
      const float4 w = part[(size_t)sl * n4 + q];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const size_t e = q * 4;
    const size_t r = e / ldp, n = e % ldp;
    float* dst = r < (size_t)D ? a.dwx + r * G
                 : r < (size_t)(D + M0) ? a.dwh[0] + (r - D) * G
                 : r < (size_t)(D + M) ? a.dwh[1] + (r - D - M0) * G
                                       : a.db;
    if (!kGen || G % 4 == 0) {
      *reinterpret_cast<float4*>(dst + n) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < (size_t)G) dst[n + i] = vs[i];
    }
  }
}

// a pass with no rows at all
inline bool wg_empty(int D, int M, int ones) { return D + M + ones < 1; }

inline bool wg_misaligned(const void* p) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// The split-K plan of a product over K row-steps with D extra rows, M main
// rows, N columns and a row of ones or not, on the kernel of the launch's
// W (bf16: the tensor cores; float: SIMT): cuda_fused.weight_grad_plan's
// rule (about kWgBlocks blocks, at most kWgMaxSlices slices, partials at
// most a kWgShare-th of K * (D + M + ones)), from the shape alone.
constexpr int kWgBlocks = 1024, kWgMaxSlices = 64, kWgShare = 4;

template <typename W>
WgPlan wg_plan(int K, int D, int M, int N, int ones, float* part) {
  const int chunk = sizeof(W) == 2 ? kWgChunkBf : kWgChunkF;
  const int tiles = wg_row_tiles<W>(D, M, ones) * ((N + kWgTile - 1) / kWgTile);
  const int rows = D + M + ones;
  int s = (kWgBlocks + tiles - 1) / tiles;
  if (s > kWgMaxSlices) s = kWgMaxSlices;
  if (s > K / (kWgShare * rows)) s = K / (kWgShare * rows);
  if (s < 1) s = 1;
  int kslice = ((K + s - 1) / s + chunk - 1) / chunk * chunk;
  if (kslice < chunk) kslice = chunk;
  WgPlan p;
  p.kslice = kslice;
  p.slices = K > 0 ? (K + kslice - 1) / kslice : 1;
  p.part = part;
  return p;
}

// floats of a plan's partials
template <typename RT>
size_t wg_part_floats(const WgArgs<RT>& a) {
  return (size_t)a.plan.slices * (a.D + wg_main(a) + a.ones) * wg_ldp(a.N);
}

// The pass: the tiles' partials, then their sum. A plan that does not cover
// [0, K) in whole chunks, or a missing scratch, is cudaErrorInvalidValue,
// before anything is launched: never another pass. W bf16 rounds both
// operands to bf16 (N a multiple of 4 there), float keeps them. kGen false
// (the LSTM backwards, wg_lstm_args) compiles the LSTM form alone.
template <typename W, bool kGen = false, typename RT>
cudaError_t launch_weight_grad_pass(const WgArgs<RT>& a, cudaStream_t stream) {
  const int chunk = sizeof(W) == 2 ? kWgChunkBf : kWgChunkF;
  const WgPlan& p = a.plan;
  const long long K = a.K;
  const int M = wg_main(a);
  if (M < 0 || a.src[0].rows < 0 || a.src[1].rows < 0 || a.D < 0 ||
      a.K < 0 || a.N < 1 || a.ldb < a.N || (sizeof(W) == 2 && a.N % 4) ||
      wg_empty(a.D, M, a.ones) || p.part == nullptr ||
      p.slices < 1 || p.slices > 65535 || p.kslice < chunk ||
      p.kslice % chunk != 0 ||
      (long long)(p.slices - 1) * p.kslice >= (K > 0 ? K : 1) ||
      (long long)p.slices * p.kslice < K ||
      (a.D > 0 && (a.dwx == nullptr || a.xs == nullptr)) ||
      (a.src[0].rows > 0 && a.dwh[0] == nullptr) ||
      (a.src[1].rows > 0 && a.dwh[1] == nullptr) ||
      (a.ones && a.db == nullptr) || wg_misaligned(p.part) ||
      (sizeof(W) == 2 && (wg_misaligned(a.dpre) || a.ldb % 4)) ||
      (a.N % 4 == 0 && (wg_misaligned(a.dwx) || wg_misaligned(a.dwh[0]) ||
                        wg_misaligned(a.dwh[1]) || wg_misaligned(a.db))))
    return cudaErrorInvalidValue;
  const int G = a.N;
  const dim3 grid(wg_row_tiles<W>(a.D, M, a.ones),
                  (G + kWgTile - 1) / kWgTile, p.slices);
  if constexpr (sizeof(W) == 2)
    weight_grad_mma_kernel<RT, kGen><<<grid, kWgThreads, 0, stream>>>(a);
  else
    weight_grad_simt_kernel<RT, kGen><<<grid, kWgThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)(a.D + M + a.ones) * wg_ldp(G) / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  weight_grad_sum_kernel<RT, kGen><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pass before the redesign, kept for the A/B entry srt_weight_grad:
// one 64 x 64 output tile per block over all of K, 256 threads of 4 x 4
// (strided) outputs, K in chunks of 16 in a fixed order, SIMT products at
// both dtypes (the operands rounded to W as they are read).
constexpr int kTM = 64, kTN = 64, kTK = 16, kGemmThreads = 256;

template <typename W, typename RT>
__global__ void __launch_bounds__(kGemmThreads)
weight_grad_tiled_kernel(const float* __restrict__ xs,
                         const float* __restrict__ h0,
                         const RT* __restrict__ hs,
                         const float* __restrict__ dpre, int T, int B, int D,
                         int H, int ones, float* __restrict__ dwx,
                         float* __restrict__ dwh, float* __restrict__ db) {
  __shared__ float sA[kTK][kTM];
  __shared__ float sB[kTK][kTN];
  const int G = 4 * H, R = D + H + ones, K = T * B;
  const int r0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  float acc[4][4];
  bool one[4];  // this output row is the row of ones (db)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    one[i] = ones && r0 + tr + 16 * i == D + H;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTK * kTM; e += kGemmThreads) {
      const int kk = e / kTM, rr = e % kTM;
      const int k = k0 + kk, r = r0 + rr;
      float v = 0.0f;
      if (k < K && r < R) {
        if (r < D) {
          v = rnd<W>(xs[(size_t)k * D + r]);
        } else if (r < D + H) {
          v = rnd<W>(k < B ? rnd<RT>(h0[(size_t)k * H + (r - D)])
                           : to_f(hs[(size_t)(k - B) * H + (r - D)]));
        } else {
          v = 1.0f;
        }
      }
      sA[kk][rr] = v;
    }
    for (int e = tid; e < kTK * kTN; e += kGemmThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int k = k0 + kk, n = n0 + nn;
      sB[kk][nn] = (k < K && n < G) ? dpre[(size_t)k * G + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float av[4], bv[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sA[kk][tr + 16 * i];
        bv[i] = sB[kk][tc + 16 * i];
        bw[i] = rnd<W>(bv[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][q] = fmaf(av[i], one[i] ? bv[q] : bw[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + 16 * i;
    if (r >= R) continue;
    float* dst = r < D ? dwx + (size_t)r * G
                       : (r < D + H ? dwh + (size_t)(r - D) * G : db);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tc + 16 * q;
      if (n < G) dst[n] = acc[i][q];
    }
  }
}

// the old pass over the LSTM backwards' operands (wg_lstm_args)
template <typename W, typename RT>
cudaError_t launch_weight_grad_tiled(const WgArgs<RT>& a,
                                     cudaStream_t stream) {
  const WgSrc<RT>& h = a.src[0];
  const int H = h.rows, B = h.shift;
  const dim3 grid((4 * H + kTN - 1) / kTN, (a.D + H + a.ones + kTM - 1) / kTM);
  weight_grad_tiled_kernel<W, RT><<<grid, kGemmThreads, 0, stream>>>(
      a.xs, h.first, h.rs, a.dpre, B > 0 ? a.K / B : 0, B, a.D, H, a.ones,
      a.dwx, a.dwh[0], a.db);
  return cudaGetLastError();
}

}  // namespace
