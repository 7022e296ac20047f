// Training kernels of the PyTorch port, hand-written CUDA C++ for Hopper
// (sm_90a). Built by ops/_build.py with nvcc into a shared library with a
// plain C interface (no PyTorch headers) and bound with ctypes by
// ops/cuda_fused.py, whose plain PyTorch versions they are held against.
//
// Which TPU kernels they replace (sketch_rnn_tpu/ops/pallas_fused.py):
//   srt_lstm_seq_fwd  <- fused_lstm_seq forward, _lstm_seq_fwd_kernel
//                        (pallas_call at :731)
//   srt_lstm_seq_bwd  <- fused_lstm_seq backward, _lstm_seq_bwd_kernel
//                        (pallas_call at :771)
//   srt_ln_lstm_fwd   <- fused_ln_lstm forward, _lnlstm_fwd_kernel
//                        (pallas_call at :1016)
//   srt_ln_lstm_bwd   <- fused_ln_lstm backward, _lnlstm_bwd_kernel
//                        (pallas_call at :1066)
//
// What they compute. The forward runs T steps of the LSTM (seq: gates
// (i, g, f, o), pre = (x @ wx + b) + h @ wh) or of the LayerNorm-LSTM
// (pre = (x @ wx + h @ wh) + x_bias, a two-pass layer norm per gate, the
// forget bias after the norm, a layer norm of the new cell state), with
// recurrent dropout on the candidate g. It writes hs and the PRE-step cell
// states cs and nothing else: no [T, B, 4H] gate buffer, no mask buffer.
// The backward walks time backwards, recomputes each step's gates from
// (x_t, h_{t-1}, c_{t-1}) -- h_{t-1} read as hs[t-1], or h0 at t = 0 --
// and back-propagates through the gate block into the pre-activation
// gradient d_pre, the carries' gradients and (LN) the LN parameters'.
//
// Dropout. A mask is streamed ([T, B, H]) or drawn here from a seed by the
// counter of pallas_fused._prng_mask: seed * 2654435761 + (t * B + row) * H
// + col (mod 2^32), hashed by _hash32, u = (bits >> 8) * 2^-24, mask =
// (u < keep) * f32(1 / keep). The counter depends on no tiling, so the
// masks here are bitwise those of the JAX package; the backward uses the
// forward's t. uint32 arithmetic, no fast-math.
//
// Design. The recurrence of a batch row never reads another row, so each
// recurrence kernel is one block per row (grid = B) with the T loop inside
// the block, one thread per hidden unit j (blockDim = H rounded up to a
// warp, H <= 512): the carry (and, backwards, dh/dc) of the row lives in
// shared memory and registers for the whole sequence. Thread j computes
// column j of the four gates, reading row k of wh coalesced across the
// block; layer-norm statistics are block reductions. The backward's
// transposed product dh_{t-1} = d_pre @ wh^T (and dx = d_pre @ wx^T) gives
// each warp whole rows of wh, read coalesced, reduced by shuffles.
//
// Weight gradients cross every row, and blocks run in no fixed order, so
// they are NOT accumulated across blocks with atomics (whose order, and so
// whose rounding, would change from run to run). The recurrence writes
// d_pre [T, B, 4H] to a scratch the wrapper allocates, and a second kernel
// (weight_grad_kernel) reduces
//   [dwx; dwh; db] = sum over (t, b) of [x_t; h_{t-1}; 1]^T d_pre_t
// (K = T*B terms) as a tiled product in a fixed order, gathering its left
// operand from xs, hs and h0 in place. Per-row quantities need no cross-
// block reduction: dxb (LN) sums d_pre over time in registers; the LN
// parameters' gradients are summed over time per row into a [B, 10H]
// partials scratch that a third kernel (sum_rows_kernel) adds up in row
// order. Every result is therefore the same, bit for bit, on every run.
//
// Bound on the H100 at the training shapes (B=100, T=250, f32; the seq
// kernel at H=256, the LN kernel at H=512): the recurrences are f32
// multiply-adds outside the tensor cores (67 TFLOP/s): seq fwd 13.4
// GFLOP, seq bwd ~39.8, LN fwd 52.9, LN bwd ~158.7 GFLOP (including the
// weight-gradient products), i.e. 0.20 / 0.59 / 0.79 / 2.37 ms, above the
// time their bytes need at 3.35 TB/s -- bound by operations. This first
// design does not approach that: only B=100 of the 132 SMs hold a row,
// each row's block re-reads wh from L2 on every step (1 MiB encoder, 4 MiB
// decoder; twice a step backwards), and the step-to-step dependency leaves
// a block's memory latency exposed. Sharing weight tiles across rows,
// tensor cores (TF32/bf16 wgmma) and TMA are later work; PERF.md keeps the
// measured times beside these bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRedMax = 8;  // most values one block_sum reduces

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// pallas_fused._hash32: murmur3-style avalanche over uint32
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  const float* masks;  // [T, B, H] streamed masks, or null
  const int* seed;     // device int32 scalar for in-kernel masks, or null
  float keep;          // f32(keep_prob)
  float inv_keep;      // f32(1 / keep_prob)
};

// The mask of (t, row, col); 1 when there is no dropout (g * 1 == g).
__device__ __forceinline__ float dropout_mask(const Dropout& d,
                                              uint32_t seed, int t, int B,
                                              int row, int H, int col) {
  if (d.masks != nullptr) return d.masks[((size_t)t * B + row) * H + col];
  if (d.seed == nullptr) return 1.0f;
  const uint32_t ctr = seed * 2654435761u +
                       ((uint32_t)t * (uint32_t)B + (uint32_t)row) *
                           (uint32_t)H +
                       (uint32_t)col;
  const uint32_t bits = hash32(ctr);
  const float u = (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
  return u < d.keep ? d.inv_keep : 0.0f;
}

// Sum N values per thread across the block; every thread gets the sums.
// s_red holds 33 * kRedMax floats. All threads of the block must call it.
template <int N>
__device__ void block_sum(float (&v)[N], float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int g = 0; g < N; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[g] += __shfl_down_sync(0xffffffffu, v[g], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < N; ++g) s_red[warp * N + g] = v[g];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += s_red[w * N + threadIdx.x];
    s_red[32 * kRedMax + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < N; ++g) v[g] = s_red[32 * kRedMax + g];
  __syncthreads();
}

struct Cell {
  const float* wx;         // [D, 4H]
  const float* wh;         // [H, 4H]
  const float* b;          // [4H] (lstm) or null
  const float* xb;         // [B, 4H] per-row gate bias (LN) or null
  const float* ln_gamma;   // [4, H] (LN)
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
  int D, H;
  float forget_bias;
};

// Column j of the four pre-activations of one row:
//   ((x @ wx [+ b]) + h @ wh) [+ xb]
// s_x holds the D inputs, s_h the H previous hidden values.
__device__ __forceinline__ void gate_pre(const Cell& p, const float* s_x,
                                         const float* s_h, int row, int j,
                                         float (&pre)[4]) {
  const int H = p.H, G = 4 * H;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * H + j;
    float xp = 0.0f;
    for (int q = 0; q < p.D; ++q) xp = fmaf(s_x[q], p.wx[q * G + col], xp);
    if (p.b != nullptr) xp = xp + p.b[col];
    pre[g] = xp;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* w = p.wh + j;
#pragma unroll 4
  for (int k = 0; k < H; ++k, w += G) {
    const float hk = s_h[k];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] = fmaf(hk, w[g * H], acc[g]);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    pre[g] = pre[g] + acc[g];
    if (p.xb != nullptr) pre[g] = pre[g] + p.xb[(size_t)row * G + g * H + j];
  }
}

// Per-gate layer-norm statistics of pre over the H columns (two-pass:
// mean, then the biased variance): mean[g] and rs[g] = rsqrt(var + eps).
// Threads past H (own == false) contribute nothing.
__device__ __forceinline__ void gate_stats(const float (&pre)[4], bool own,
                                           int H, float* s_red,
                                           float (&mean)[4], float (&rs)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) mean[g] = own ? pre[g] : 0.0f;
  block_sum<4>(mean, s_red);
#pragma unroll
  for (int g = 0; g < 4; ++g) mean[g] = mean[g] / (float)H;
  float var[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float d = pre[g] - mean[g];
    var[g] = own ? d * d : 0.0f;
  }
  block_sum<4>(var, s_red);
#pragma unroll
  for (int g = 0; g < 4; ++g) rs[g] = rsqrtf(var[g] / (float)H + 1e-6f);
}

// Layer-norm statistics of one value per column.
__device__ __forceinline__ void row_stats(float v, bool own, int H,
                                          float* s_red, float& mean,
                                          float& rs) {
  float s[1] = {own ? v : 0.0f};
  block_sum<1>(s, s_red);
  mean = s[0] / (float)H;
  const float d = v - mean;
  float q[1] = {own ? d * d : 0.0f};
  block_sum<1>(q, s_red);
  rs = rsqrtf(q[0] / (float)H + 1e-6f);
}

struct Fwd {
  Cell p;
  const float* xs;  // [T, B, D]
  const float* c0;  // [B, H]
  const float* h0;  // [B, H]
  Dropout drop;
  float* hs;  // [T, B, H]
  float* cs;  // [T, B, H] pre-step cell states
  float* cT;  // [B, H] or null
  float* hT;  // [B, H] or null
  int T, B;
};

template <bool LN>
__global__ void __launch_bounds__(kMaxThreads) rnn_fwd_kernel(Fwd a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const Cell& p = a.p;
  const int H = p.H, D = p.D, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  float* s_h = smem;       // H
  float* s_x = s_h + H;    // D
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float c = 0.0f, h = 0.0f;
  if (own) {
    c = a.c0[(size_t)row * H + j];
    h = a.h0[(size_t)row * H + j];
    s_h[j] = h;
  }
  for (int t = 0; t < a.T; ++t) {
    for (int q = threadIdx.x; q < D; q += blockDim.x)
      s_x[q] = a.xs[((size_t)t * B + row) * D + q];
    __syncthreads();  // s_x and s_h ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_h, row, j, pre);
    const float m = own ? dropout_mask(a.drop, seed, t, B, row, H, j) : 1.0f;
    float nc, nh;
    if (LN) {
      float mean[4], rs[4];
      gate_stats(pre, own, H, s_red, mean, rs);
      float y[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        y[g] = own ? (pre[g] - mean[g]) * rs[g] * p.ln_gamma[g * H + j] +
                         p.ln_beta[g * H + j]
                   : 0.0f;
      const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
      const float f = sigmoidf_(y[2] + p.forget_bias), o = sigmoidf_(y[3]);
      nc = c * f + i * (gu * m);
      float cmean, crs;
      row_stats(nc, own, H, s_red, cmean, crs);
      const float yc =
          own ? (nc - cmean) * crs * p.lnc_gamma[j] + p.lnc_beta[j] : 0.0f;
      nh = tanhf(yc) * o;
    } else {
      const float i = sigmoidf_(pre[0]), gu = tanhf(pre[1]);
      const float f = sigmoidf_(pre[2] + p.forget_bias), o = sigmoidf_(pre[3]);
      nc = c * f + i * (gu * m);
      nh = tanhf(nc) * o;
    }
    __syncthreads();  // every read of s_h and s_x of this step is done
    if (own) {
      const size_t at = ((size_t)t * B + row) * H + j;
      a.cs[at] = c;
      a.hs[at] = nh;
      s_h[j] = nh;
      c = nc;
      h = nh;
    }
  }
  if (own && a.cT != nullptr) {
    a.cT[(size_t)row * H + j] = c;
    a.hT[(size_t)row * H + j] = h;
  }
}

struct Bwd {
  Cell p;
  const float* xs;   // [T, B, D]
  const float* h0;   // [B, H]
  const float* hs;   // [T, B, H]
  const float* cs;   // [T, B, H]
  const float* dhs;  // [T, B, H]
  const float* dcT;  // [B, H] or null (zero)
  const float* dhT;  // [B, H] or null (zero)
  Dropout drop;
  float* dpre;  // [T, B, 4H] scratch: every step's pre-activation gradient
  float* dxs;   // [T, B, D] or null
  float* dxb;   // [B, 4H] or null
  float* dc0;   // [B, H] or null
  float* dh0;   // [B, H] or null
  float* part;  // [B, 10H] LN partials (dgam 4H | dbet 4H | dgc H | dbc H)
  int T, B;
};

template <bool LN>
__global__ void __launch_bounds__(kMaxThreads) rnn_bwd_kernel(Bwd a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const Cell& p = a.p;
  const int H = p.H, D = p.D, G = 4 * H, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* s_hp = smem;         // H: h_{t-1}
  float* s_dhn = s_hp + H;    // H: dh_{t-1}
  float* s_dp = s_dhn + H;    // 4H: d_pre of this step
  float* s_x = s_dp + G;      // D
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float dh = 0.0f, dc = 0.0f;
  float xb_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dgam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dbet[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dgc = 0.0f, dbc = 0.0f;
  if (own) {
    if (a.dhT != nullptr) dh = a.dhT[(size_t)row * H + j];
    if (a.dcT != nullptr) dc = a.dcT[(size_t)row * H + j];
  }
  // the transposed product covers the wx rows too when dxs is wanted
  const int r_first = a.dxs != nullptr ? 0 : D;

  for (int s = a.T - 1; s >= 0; --s) {
    for (int q = threadIdx.x; q < D; q += blockDim.x)
      s_x[q] = a.xs[((size_t)s * B + row) * D + q];
    float c_prev = 0.0f, dh_tot = 0.0f;
    if (own) {
      const size_t at = ((size_t)s * B + row) * H + j;
      s_hp[j] = s > 0 ? a.hs[at - (size_t)B * H] : a.h0[(size_t)row * H + j];
      c_prev = a.cs[at];
      dh_tot = dh + a.dhs[at];
    }
    __syncthreads();  // s_x, s_hp ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_hp, row, j, pre);
    const float m = own ? dropout_mask(a.drop, seed, s, B, row, H, j) : 1.0f;
    float dp[4], dc_next;
    if (LN) {
      float mean[4], rs[4], xhat[4], y[4];
      gate_stats(pre, own, H, s_red, mean, rs);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        xhat[g] = (pre[g] - mean[g]) * rs[g];
        y[g] = own ? xhat[g] * p.ln_gamma[g * H + j] + p.ln_beta[g * H + j]
                   : 0.0f;
      }
      const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
      const float f = sigmoidf_(y[2] + p.forget_bias), o = sigmoidf_(y[3]);
      const float nc = c_prev * f + i * (gu * m);
      float cmean, crs;
      row_stats(nc, own, H, s_red, cmean, crs);
      const float xhat_c = (nc - cmean) * crs;
      const float gc = own ? p.lnc_gamma[j] : 0.0f;
      const float yc = own ? xhat_c * gc + p.lnc_beta[j] : 0.0f;
      const float tanh_yc = tanhf(yc);
      const float do_ = dh_tot * tanh_yc;
      const float dyc = dh_tot * o * (1.0f - tanh_yc * tanh_yc);
      dgc += dyc * xhat_c;
      dbc += dyc;
      // layer-norm backward of the cell norm: r * (dxhat - mean(dxhat)
      //   - xhat * mean(dxhat * xhat))
      const float dxh_c = dyc * gc;
      float q2[2] = {own ? dxh_c : 0.0f, own ? dxh_c * xhat_c : 0.0f};
      block_sum<2>(q2, s_red);
      const float dcv =
          dc + crs * (dxh_c - q2[0] / (float)H - xhat_c * (q2[1] / (float)H));
      const float df = dcv * c_prev;
      const float di = dcv * (gu * m);
      const float dgu = dcv * i * m;
      const float dy[4] = {di * i * (1.0f - i), dgu * (1.0f - gu * gu),
                           df * f * (1.0f - f), do_ * o * (1.0f - o)};
      float q8[8], dxh[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dgam[g] += dy[g] * xhat[g];
        dbet[g] += dy[g];
        dxh[g] = own ? dy[g] * p.ln_gamma[g * H + j] : 0.0f;
        q8[g] = dxh[g];
        q8[4 + g] = own ? dxh[g] * xhat[g] : 0.0f;
      }
      block_sum<8>(q8, s_red);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dp[g] = rs[g] * (dxh[g] - q8[g] / (float)H -
                         xhat[g] * (q8[4 + g] / (float)H));
      dc_next = dcv * f;
    } else {
      const float i = sigmoidf_(pre[0]), gu = tanhf(pre[1]);
      const float f = sigmoidf_(pre[2] + p.forget_bias), o = sigmoidf_(pre[3]);
      const float nc = c_prev * f + i * (gu * m);
      const float tanh_c = tanhf(nc);
      const float dcv = dc + dh_tot * o * (1.0f - tanh_c * tanh_c);
      const float do_ = dh_tot * tanh_c;
      const float df = dcv * c_prev;
      const float di = dcv * (gu * m);
      const float dgu = dcv * i * m;
      dp[0] = di * i * (1.0f - i);
      dp[1] = dgu * (1.0f - gu * gu);
      dp[2] = df * f * (1.0f - f);
      dp[3] = do_ * o * (1.0f - o);
      dc_next = dcv * f;
    }
    if (own) {
      float* out = a.dpre + ((size_t)s * B + row) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[g * H + j] = dp[g];
        s_dp[g * H + j] = dp[g];
        xb_acc[g] += dp[g];
      }
    }
    __syncthreads();  // s_dp complete
    // dh_{t-1}[k] = sum_c d_pre[c] wh[k, c]; dx[q] = sum_c d_pre[c] wx[q, c]
    for (int r = r_first + warp; r < D + H; r += nw) {
      const float* wr = r < D ? p.wx + (size_t)r * G : p.wh + (size_t)(r - D) * G;
      float acc = 0.0f;
      for (int col = lane; col < G; col += 32) acc = fmaf(s_dp[col], wr[col], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        if (r < D)
          a.dxs[((size_t)s * B + row) * D + r] = acc;
        else
          s_dhn[r - D] = acc;
      }
    }
    __syncthreads();  // s_dhn complete; s_x, s_hp, s_dp free again
    if (own) dh = s_dhn[j];
    dc = dc_next;
  }
  if (!own) return;
  if (a.dc0 != nullptr) {
    a.dc0[(size_t)row * H + j] = dc;
    a.dh0[(size_t)row * H + j] = dh;
  }
  if (a.dxb != nullptr) {
#pragma unroll
    for (int g = 0; g < 4; ++g) a.dxb[(size_t)row * G + g * H + j] = xb_acc[g];
  }
  if (LN) {
    float* pr = a.part + (size_t)row * 10 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      pr[g * H + j] = dgam[g];
      pr[4 * H + g * H + j] = dbet[g];
    }
    pr[8 * H + j] = dgc;
    pr[9 * H + j] = dbc;
  }
}

// [dwx; dwh; db] (R = D + H + ones rows, N = 4H columns)
//   = sum over k = t*B + b of A[k, r] * dpre[k, n],
// A[k] = [xs[t, b]; h_{t-1}[b] (h0 at t = 0); 1]. One 64 x 64 output tile
// per block, 256 threads of 4 x 4 (strided) outputs, K in chunks of 16 in
// a fixed order: deterministic.
constexpr int kTM = 64, kTN = 64, kTK = 16, kGemmThreads = 256;

__global__ void __launch_bounds__(kGemmThreads)
weight_grad_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                   const float* __restrict__ hs,
                   const float* __restrict__ dpre, int T, int B, int D,
                   int H, int ones, float* __restrict__ dwx,
                   float* __restrict__ dwh, float* __restrict__ db) {
  __shared__ float sA[kTK][kTM];
  __shared__ float sB[kTK][kTN];
  const int G = 4 * H, R = D + H + ones, K = T * B;
  const int r0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTK * kTM; e += kGemmThreads) {
      const int kk = e / kTM, rr = e % kTM;
      const int k = k0 + kk, r = r0 + rr;
      float v = 0.0f;
      if (k < K && r < R) {
        if (r < D) {
          v = xs[(size_t)k * D + r];
        } else if (r < D + H) {
          v = k < B ? h0[(size_t)k * H + (r - D)]
                    : hs[(size_t)(k - B) * H + (r - D)];
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
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sA[kk][tr + 16 * i];
        bv[i] = sB[kk][tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
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

// out[c] = sum over r of part[r, c], r in order.
__global__ void sum_rows_kernel(const float* __restrict__ part, int rows,
                                int cols, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + c];
  out[c] = s;
}

int threads_for(int H) { return (H + 31) / 32 * 32; }

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Cell make_cell(const float* wx, const float* wh, const float* b,
               const float* xb, const float* ln_gamma, const float* ln_beta,
               const float* lnc_gamma, const float* lnc_beta, int D, int H,
               float forget_bias) {
  Cell p;
  p.wx = wx;
  p.wh = wh;
  p.b = b;
  p.xb = xb;
  p.ln_gamma = ln_gamma;
  p.ln_beta = ln_beta;
  p.lnc_gamma = lnc_gamma;
  p.lnc_beta = lnc_beta;
  p.D = D;
  p.H = H;
  p.forget_bias = forget_bias;
  return p;
}

Dropout make_dropout(const float* masks, const int* seed, float keep,
                     float inv_keep) {
  Dropout d;
  d.masks = masks;
  d.seed = seed;
  d.keep = keep;
  d.inv_keep = inv_keep;
  return d;
}

template <bool LN>
cudaError_t launch_fwd(const Fwd& a, cudaStream_t stream) {
  if (a.p.H < 1 || a.p.H > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.p.H + a.p.D) * sizeof(float);
  cudaError_t err = set_smem((const void*)rnn_fwd_kernel<LN>, smem);
  if (err != cudaSuccess) return err;
  rnn_fwd_kernel<LN><<<a.B, threads_for(a.p.H), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t launch_bwd(const Bwd& a, cudaStream_t stream) {
  const int H = a.p.H;
  if (H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * H + a.p.D) * sizeof(float);
  cudaError_t err = set_smem((const void*)rnn_bwd_kernel<LN>, smem);
  if (err != cudaSuccess) return err;
  rnn_bwd_kernel<LN><<<a.B, threads_for(H), smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_weight_grad(const float* xs, const float* h0,
                               const float* hs, const float* dpre, int T,
                               int B, int D, int H, int ones, float* dwx,
                               float* dwh, float* db, cudaStream_t stream) {
  const dim3 grid((4 * H + kTN - 1) / kTN, (D + H + ones + kTM - 1) / kTM);
  weight_grad_kernel<<<grid, kGemmThreads, 0, stream>>>(
      xs, h0, hs, dpre, T, B, D, H, ones, dwx, dwh, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers of contiguous float32 tensors unless
// named int32; masks / seed / x_bias may be null (no streamed masks, no
// in-kernel dropout, no per-row bias). Each returns the cudaError_t of its
// launches (0 when all were accepted).

int srt_lstm_seq_fwd(const float* xs, const float* wx, const float* b,
                     const float* wh, const float* c0, const float* h0,
                     const float* masks, const int* seed, int T, int B, int D,
                     int H, float keep, float inv_keep, float forget_bias,
                     float* hs, float* cs, void* stream) {
  Fwd a;
  a.p = make_cell(wx, wh, b, nullptr, nullptr, nullptr, nullptr, nullptr, D,
                  H, forget_bias);
  a.xs = xs;
  a.c0 = c0;
  a.h0 = h0;
  a.drop = make_dropout(masks, seed, keep, inv_keep);
  a.hs = hs;
  a.cs = cs;
  a.cT = nullptr;
  a.hT = nullptr;
  a.T = T;
  a.B = B;
  return (int)launch_fwd<false>(a, (cudaStream_t)stream);
}

int srt_lstm_seq_bwd(const float* xs, const float* wx, const float* b,
                     const float* wh, const float* h0, const float* hs,
                     const float* cs, const float* dhs, const float* masks,
                     const int* seed, int T, int B, int D, int H, float keep,
                     float inv_keep, float forget_bias, float* dpre,
                     float* dwx, float* db, float* dwh, void* stream) {
  Bwd a;
  a.p = make_cell(wx, wh, b, nullptr, nullptr, nullptr, nullptr, nullptr, D,
                  H, forget_bias);
  a.xs = xs;
  a.h0 = h0;
  a.hs = hs;
  a.cs = cs;
  a.dhs = dhs;
  a.dcT = nullptr;
  a.dhT = nullptr;
  a.drop = make_dropout(masks, seed, keep, inv_keep);
  a.dpre = dpre;
  a.dxs = nullptr;
  a.dxb = nullptr;
  a.dc0 = nullptr;
  a.dh0 = nullptr;
  a.part = nullptr;
  a.T = T;
  a.B = B;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bwd<false>(a, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_weight_grad(xs, h0, hs, dpre, T, B, D, H, 1, dwx, dwh,
                                 db, st);
}

int srt_ln_lstm_fwd(const float* xs, const float* xb, const float* wx,
                    const float* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* c0, const float* h0,
                    const float* masks, const int* seed, int T, int B, int D,
                    int H, float keep, float inv_keep, float forget_bias,
                    float* hs, float* cs, float* cT, float* hT,
                    void* stream) {
  Fwd a;
  a.p = make_cell(wx, wh, nullptr, xb, ln_gamma, ln_beta, lnc_gamma,
                  lnc_beta, D, H, forget_bias);
  a.xs = xs;
  a.c0 = c0;
  a.h0 = h0;
  a.drop = make_dropout(masks, seed, keep, inv_keep);
  a.hs = hs;
  a.cs = cs;
  a.cT = cT;
  a.hT = hT;
  a.T = T;
  a.B = B;
  return (int)launch_fwd<true>(a, (cudaStream_t)stream);
}

int srt_ln_lstm_bwd(const float* xs, const float* xb, const float* wx,
                    const float* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* h0, const float* hs,
                    const float* cs, const float* dhs, const float* dcT,
                    const float* dhT, const float* masks, const int* seed,
                    int T, int B, int D, int H, float keep, float inv_keep,
                    float forget_bias, float* dpre, float* part, float* dxs,
                    float* dxb, float* dwx, float* dwh, float* dln,
                    float* dc0, float* dh0, void* stream) {
  Bwd a;
  a.p = make_cell(wx, wh, nullptr, xb, ln_gamma, ln_beta, lnc_gamma,
                  lnc_beta, D, H, forget_bias);
  a.xs = xs;
  a.h0 = h0;
  a.hs = hs;
  a.cs = cs;
  a.dhs = dhs;
  a.dcT = dcT;
  a.dhT = dhT;
  a.drop = make_dropout(masks, seed, keep, inv_keep);
  a.dpre = dpre;
  a.dxs = dxs;
  a.dxb = dxb;
  a.dc0 = dc0;
  a.dh0 = dh0;
  a.part = part;
  a.T = T;
  a.B = B;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_bwd<true>(a, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_weight_grad(xs, h0, hs, dpre, T, B, D, H, 0, dwx, dwh,
                           nullptr, st);
  if (err != cudaSuccess) return (int)err;
  const int cols = 10 * H;
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, st>>>(part, B, cols, dln);
  return (int)cudaGetLastError();
}

}  // extern "C"
