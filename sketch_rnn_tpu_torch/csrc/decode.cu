// Serving kernels of the PyTorch port, hand-written CUDA C++ for Hopper
// (sm_90a). Built by ops/_build.py with nvcc into a shared library with a
// plain C interface (no PyTorch headers) and bound with ctypes by
// ops/cuda_decode.py, whose plain PyTorch versions they are held against.
//
// srt_decode_chunk replaces the TPU kernel
//   sketch_rnn_tpu/ops/pallas_decode.py::decode_chunk (pallas_call at :327)
// srt_replay_chunk replaces
//   sketch_rnn_tpu/ops/pallas_decode.py::replay_chunk (pallas_call at :413)
//
// What they compute. decode_chunk runs a whole K-step serving chunk: for
// each step the LSTM / LayerNorm-LSTM cell, the h @ out_w + out_b MDN
// projection, the mixture head, the inverse-CDF categorical draws of the
// mixture component and pen state, the Box-Muller offset draw, and the
// engine's done/cap masking with END_TOKEN emission. replay_chunk runs
// the teacher-forced replay of a stroke prefix through the same cell step
// with the per-row `t < seq_len` liveness mask and returns the final
// carry. The uniforms are drawn outside (make_uniforms) with the engine's
// per-request fold_in(key, t) discipline. Both keep the association of
// pallas_decode._cell_step:
//   pre = ((x @ wx + extra_xp) [+ b]) + h @ wh        (gates i, g, f, o)
//
// Design (serve_loop_kernel<W, LN, DEC>; DEC: decode, else replay). One
// persistent kernel launched cooperatively: blocks are slices of 16 hidden
// units x batch tiles, as many tiles as fill the SMs once (at B = 64, H =
// 512: 32 slices x 4 tiles of 16 rows, 128 blocks of 256 threads, one an
// SM). Resident in shared memory for the whole launch: the block's 64
// columns of wh and of wx's five stroke rows in the weight type W, laid out
// [k][gate][unit] as in global memory (a launch stages them with cp.async,
// 4 units a copy; bf16 rows padded for ldmatrix), its units' rows of out_w
// (as float), its tile's rows of extra_xp, its units' b, and the float
// carry of its (row, unit) pairs. h_{t-1} crosses blocks through a
// ping-pong exchange hx[2, B, H] of type W, read with cp.async.cg in four
// groups over k so that the product over the first part runs while the
// later parts land. A step's phases, each arrow a grid barrier:
//  (a) h @ wh for 16 rows a pass. Float weights (and bf16 ones where H is
//      not a multiple of 64): SIMT, a thread 4 columns (one gate, 4 units)
//      of 2 rows, each output one in-order fmaf chain over k from 0.0f (a
//      thread's loads from shared memory bound this product: 2 rows took
//      17.2K cycles a step against 1 row's 22.7K and 4 rows' more, on an
//      H100). bf16 weights: mma.sync m16n8k16 (exact products, float sums
//      in the tensor cores' order), a warp 8 columns of the 16 rows: 5.5K
//      cycles against 19.3K. Then the x part and the sums in _cell_step's
//      order. The pairs (a thread a (row, unit) pair, a half warp a row's
//      16 units) then take LN: each gate's slice mean and M2 (two passes)
//      to [B, slices, 8] -> LSTM: the gate block, the new carry, h.
//  (b) LN: the gate norms from the slices' partials in slice order by
//      Chan's rule, the gate block, the cell's slice moments to [B, slices,
//      2] ->
//  (c) LN: the cell norm the same way, h. Both cells: the freeze (a row
//      done at the step's start keeps its carry), hx[t & 1] = rnd_W(h).
//      DEC: the slice's partial of raw = h_t @ out_w over its units, a
//      thread a column (its weights in registers) and 8 rows, one in-order
//      fmaf chain per output, to [B, slices, 6M + 3 padded] ->
//  (d) DEC: each row sampled on its owner block (local row r of a tile on
//      slice r % slices): its raw row, a thread a column summing the
//      slices' partials in slice order (all loads in flight at once) plus
//      out_b; then one warp: log_softmax and the component's weights with
//      warp-shuffle maxima and sums, a lane a component; on lane 0 the CDF
//      a running sum in index order, the pen draw and Box-Muller (exact
//      expf, logf, cosf, sinf: the row-block design's formulas); the masked
//      stroke to strokes[s, row] and to a stroke exchange [B, 8] (x and
//      liveness) that step s + 1 reads; t and done kept by the owner ->
// So a decode step takes 4 barriers (LN) or 2 (LSTM), a replay step 3 or
// 1, the last step of a launch one fewer. Every exchange has a fixed order
// and there are no atomics, so every run gives the same bits. The sums of
// the layer norms, the projection and the sampler are taken in other orders
// than the row-block design's, so the two agree within tolerance; for the
// LSTM cell at float weights a step's carry is bit for bit the row-block
// design's (the same expressions), at bf16 not (the tensor cores' sums).
// Asking for the next step's h rows before the sampler (the h part of the
// product overlapping (d)) was slower: the copies delayed the owners'
// partial loads (PERF.md).
// Sizing at B = 64, H = 512, M = 20 (ops/cuda_decode.py::decode_plan, the
// same sums as serve_smem and serve_scratch_bytes here): shared memory
// 186,736 bytes a block at float weights (wh and wx columns 132,352, out_w
// rows 7,872, a pass's h rows 33,024), 112,448 at bf16; replay 176,640 and
// 102,352; the scratch (hx, the exchanges, the partials) 1,361,920 bytes at
// float, 1,230,848 at bf16. A batch whose tiles do not fit runs in windows
// of rows (persist.cuh); a grid that cannot co-reside is
// cudaErrorCooperativeLaunchTooLarge, a plan that does not hold the shape
// cudaErrorInvalidValue: errors, never a fallback.
//
// The row-block design (srt_decode_chunk_rowblock, srt_replay_chunk_
// rowblock: the first port's kernels, kept for the A/B and the card tests;
// nothing on the main path calls them). One block of 512 threads per slot
// row; the K (or E) steps a loop inside the block with c, h, the previous
// stroke, t and done in shared memory. Each thread owns hidden index j (and
// j + blockDim, ...) and computes that column of all four gates, reading
// row k of wh from L2 on every step. Block reductions give the layer-norm
// statistics (two-pass), the 6M+3 projection splits H into four quarters,
// and one thread runs the mixture head and the sampler in index order.
//
// Bound on the H100 at the slice's shapes (B=64, K=8, H=512, M=20, f32):
// the chunk does 2*B*K*(H*4H + 5*4H + H*(6M+3)) ~= 1.14 GFLOP of f32
// multiply-add that is not tensor-core work (67 TFLOP/s: ~17 us), and must
// move its weights once (wh 4 MiB + out_w 0.25 MiB + the rest, ~4.5 MB:
// ~1.3 us at 3.35 TB/s) -- compute-bound. At bf16 the products are
// tensor-core work and the bytes bound it. PERF.md keeps each design's time
// beside the bound.
//
// Numerics: float sums throughout, no fast-math intrinsics (the sampler's
// log(max(u, 1e-12)) and cos(2 pi u) feed the strokes directly), rsqrtf
// for the layer norm as ops/linear.py uses rsqrt. At compute_dtype
// bfloat16 the three weight matrices (wx, wh, out_w) arrive as bf16 (W)
// and every product rounds its activation operand (the stroke, h, the new
// h) to bf16 and accumulates in float -- ops/linear.py::matmul's contract,
// as pallas_decode._cell_step and its out_w product apply it -- so each
// product is exact and only the order of the float sums differs from the
// plain version. The carry, the layer norms and the sampler stay float.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "persist.cuh"

namespace {

// ---------------------------------------------------------------------------
// The row-block design (srt_decode_chunk_rowblock, srt_replay_chunk_rowblock)

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQuarters = 4;  // H split of the MDN projection
constexpr float kTwoPi = 6.28318530717958647692f;

template <typename W>
struct CellParams {
  const W* wx;             // [XD, 4H] (the stroke rows of the input weight)
  const W* wh;             // [H, 4H]
  const float* b;          // [4H] (lstm) or nullptr (layer_norm)
  const float* ln_gamma;   // [4, H] (layer_norm only)
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
  int H;
  int layer_norm;
  float forget_bias;
};

// Sum N values per thread across the block; every thread gets the sums.
// s_red must hold kWarps * N + N floats.
template <int N>
__device__ void row_block_sum(float (&v)[N], float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    for (int w = 0; w < kWarps; ++w) s += s_red[w * N + threadIdx.x];
    s_red[kWarps * N + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < N; ++g) v[g] = s_red[kWarps * N + g];
  __syncthreads();
}

// One cell step for this block's row. Reads s_x (the XD input features),
// s_c and s_h (the carry); writes the new carry to s_cn / s_hn.
// s_pre holds 4H floats. extra_row: this row's extra_xp [4H] or nullptr.
template <int XD, typename W>
__device__ void cell_step(const CellParams<W>& p, const float* s_x,
                          const float* extra_row, const float* s_c,
                          const float* s_h, float* s_pre, float* s_cn,
                          float* s_hn, float* s_red) {
  const int H = p.H, G = 4 * H;
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float acc[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * H + j;
      float xp = 0.0f;
#pragma unroll
      for (int k = 0; k < XD; ++k)
        xp = fmaf(rnd<W>(s_x[k]), to_f(p.wx[k * G + col]), xp);
      if (extra_row != nullptr) xp = xp + extra_row[col];
      if (p.b != nullptr) xp = xp + p.b[col];
      s_pre[col] = xp;
      acc[g] = 0.0f;
    }
    const W* w = p.wh + j;
#pragma unroll 4
    for (int k = 0; k < H; ++k, w += G) {
      const float hk = rnd<W>(s_h[k]);
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(hk, to_f(w[g * H]), acc[g]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) s_pre[g * H + j] += acc[g];
  }
  __syncthreads();

  if (p.layer_norm) {
    float mean[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = threadIdx.x; j < H; j += kThreads) {
#pragma unroll
      for (int g = 0; g < 4; ++g) mean[g] += s_pre[g * H + j];
    }
    row_block_sum<4>(mean, s_red);
#pragma unroll
    for (int g = 0; g < 4; ++g) mean[g] = mean[g] / (float)H;
    float var[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = threadIdx.x; j < H; j += kThreads) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float d = s_pre[g * H + j] - mean[g];
        var[g] += d * d;
      }
    }
    row_block_sum<4>(var, s_red);
    float rs[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) rs[g] = rsqrtf(var[g] / (float)H + 1e-6f);
    float csum[1] = {0.0f};
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float gt[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gt[g] = (s_pre[g * H + j] - mean[g]) * rs[g] * p.ln_gamma[g * H + j] +
                p.ln_beta[g * H + j];
      const float nc = s_c[j] * sigmoidf_(gt[2] + p.forget_bias) +
                       sigmoidf_(gt[0]) * tanhf(gt[1]);
      s_cn[j] = nc;
      s_pre[3 * H + j] = gt[3];  // the normalized output gate
      csum[0] += nc;
    }
    row_block_sum<1>(csum, s_red);
    const float cmean = csum[0] / (float)H;
    float cvar[1] = {0.0f};
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float d = s_cn[j] - cmean;
      cvar[0] += d * d;
    }
    row_block_sum<1>(cvar, s_red);
    const float crs = rsqrtf(cvar[0] / (float)H + 1e-6f);
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float oc = (s_cn[j] - cmean) * crs * p.lnc_gamma[j] + p.lnc_beta[j];
      s_hn[j] = tanhf(oc) * sigmoidf_(s_pre[3 * H + j]);
    }
  } else {
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float i = s_pre[j], g = s_pre[H + j], f = s_pre[2 * H + j],
                  o = s_pre[3 * H + j];
      const float nc =
          s_c[j] * sigmoidf_(f + p.forget_bias) + sigmoidf_(i) * tanhf(g);
      s_cn[j] = nc;
      s_hn[j] = tanhf(nc) * sigmoidf_(o);
    }
  }
  __syncthreads();
}

// Index of the first maximum (jnp.argmax semantics).
__device__ int argmax_(const float* a, int n, int stride) {
  int best = 0;
  for (int m = 1; m < n; ++m)
    if (a[m * stride] > a[best * stride]) best = m;
  return best;
}

// Inverse-CDF draw: softmax(a / tau), cumsum in index order, then
// min(#{u > cdf_m}, n - 1). a is read with the given stride; e holds n.
__device__ int inverse_cdf_(const float* a, int n, float tau, float u,
                            float* e) {
  float mx = -INFINITY;
  for (int m = 0; m < n; ++m) {
    e[m] = a[m] / tau;
    mx = fmaxf(mx, e[m]);
  }
  float s = 0.0f;
  for (int m = 0; m < n; ++m) {
    e[m] = expf(e[m] - mx);
    s += e[m];
  }
  float cdf = 0.0f;
  int count = 0;
  for (int m = 0; m < n; ++m) {
    cdf += e[m] / s;
    count += (u > cdf) ? 1 : 0;
  }
  return count < n - 1 ? count : n - 1;
}

// Shared memory of decode_chunk_kernel, in floats.
__host__ __device__ inline size_t decode_smem_floats(int H, int P, int M) {
  return (size_t)4 * H        // s_c, s_h, s_cn, s_hn
         + (size_t)4 * H      // s_pre
         + (size_t)kQuarters * 128  // s_part
         + (size_t)P          // s_raw
         + (size_t)M          // s_logpi
         + (size_t)M + 8      // s_e (scratch, >= 3)
         + 8                  // s_x (5) padded
         + (size_t)kWarps * 4 + 4;  // s_red
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(CellParams<W> p, const W* __restrict__ out_w,
                    const float* __restrict__ out_b,
                    const float* __restrict__ c0,
                    const float* __restrict__ h0,
                    const float* __restrict__ prev0,
                    const float* __restrict__ extra_xp,
                    const float* __restrict__ u,
                    const float* __restrict__ temps,
                    const int* __restrict__ t0,
                    const int* __restrict__ done0,
                    const int* __restrict__ caps,
                    const float* __restrict__ end_token, int B, int K,
                    int M, int greedy, float* __restrict__ strokes,
                    float* __restrict__ c_out, float* __restrict__ h_out,
                    int* __restrict__ t_out, int* __restrict__ done_out) {
  extern __shared__ float smem[];
  const int H = p.H, G = 4 * H, P = 6 * M + 3;
  const int row = blockIdx.x;
  float* s_c = smem;
  float* s_h = s_c + H;
  float* s_cn = s_h + H;
  float* s_hn = s_cn + H;
  float* s_pre = s_hn + H;
  float* s_part = s_pre + G;
  float* s_raw = s_part + kQuarters * 128;
  float* s_logpi = s_raw + P;
  float* s_e = s_logpi + M;
  float* s_x = s_e + M + 8;
  float* s_red = s_x + 8;
  __shared__ int s_t, s_done, s_live;

  for (int j = threadIdx.x; j < H; j += kThreads) {
    s_c[j] = c0[(size_t)row * H + j];
    s_h[j] = h0[(size_t)row * H + j];
  }
  if (threadIdx.x < 5) s_x[threadIdx.x] = prev0[row * 5 + threadIdx.x];
  if (threadIdx.x == 0) {
    s_t = t0[row];
    s_done = done0[row] != 0;
  }
  __syncthreads();
  const float* extra_row =
      extra_xp != nullptr ? extra_xp + (size_t)row * G : nullptr;
  const float tau = temps[row];
  const int cap = caps[row];
  const int quarter = threadIdx.x >> 7, lane128 = threadIdx.x & 127;
  const int kq = (H + kQuarters - 1) / kQuarters;

  for (int s = 0; s < K; ++s) {
    cell_step<5, W>(p, s_x, extra_row, s_c, s_h, s_pre, s_cn, s_hn, s_red);

    // raw = h_new @ out_w + out_b; H split into four quarters
    for (int col0 = 0; col0 < P; col0 += 128) {
      const int col = col0 + lane128;
      float acc = 0.0f;
      if (col < P) {
        const int k1 = min(H, (quarter + 1) * kq);
        for (int k = quarter * kq; k < k1; ++k)
          acc = fmaf(rnd<W>(s_hn[k]), to_f(out_w[(size_t)k * P + col]), acc);
      }
      s_part[quarter * 128 + lane128] = acc;
      __syncthreads();
      if (quarter == 0 && col < P)
        s_raw[col] = (((s_part[lane128] + s_part[128 + lane128]) +
                       s_part[256 + lane128]) +
                      s_part[384 + lane128]) +
                     out_b[col];
      __syncthreads();
    }

    if (threadIdx.x == 0) {
      const float* raw = s_raw;
      const float* logits = raw + 3;
      const float* mu1 = raw + 3 + M;
      const float* mu2 = raw + 3 + 2 * M;
      const float* ls1 = raw + 3 + 3 * M;
      const float* ls2 = raw + 3 + 4 * M;
      const float* rho_raw = raw + 3 + 5 * M;
      // log_pi = log_softmax(logits), jax.nn.log_softmax's association
      float mx = -INFINITY;
      for (int m = 0; m < M; ++m) mx = fmaxf(mx, logits[m]);
      float se = 0.0f;
      for (int m = 0; m < M; ++m) {
        s_logpi[m] = logits[m] - mx;
        se += expf(s_logpi[m]);
      }
      const float lse = logf(se);
      for (int m = 0; m < M; ++m) s_logpi[m] = s_logpi[m] - lse;

      const float* us = u + ((size_t)s * B + row) * 4;
      int idx, pen_idx;
      if (greedy) {
        idx = argmax_(s_logpi, M, 1);
        pen_idx = argmax_(raw, 3, 1);
      } else {
        idx = inverse_cdf_(s_logpi, M, tau, us[0], s_e);
        pen_idx = inverse_cdf_(raw, 3, tau, us[1], s_e);
      }
      float dx, dy;
      if (greedy) {
        dx = mu1[idx];
        dy = mu2[idx];
      } else {
        const float s1 = expf(ls1[idx]);
        const float s2 = expf(ls2[idx]);
        const float rho = tanhf(rho_raw[idx]);
        const float r = sqrtf(-2.0f * logf(fmaxf(us[2], 1e-12f)));
        const float theta = kTwoPi * us[3];
        const float e0 = r * cosf(theta), e1 = r * sinf(theta);
        const float sq = sqrtf(tau);
        dx = mu1[idx] + s1 * sq * e0;
        dy = mu2[idx] + s2 * sq * (rho * e0 + sqrtf(1.0f - rho * rho) * e1);
      }
      const int live = !s_done;
      float st[5] = {dx, dy, pen_idx == 0 ? 1.0f : 0.0f,
                     pen_idx == 1 ? 1.0f : 0.0f, pen_idx == 2 ? 1.0f : 0.0f};
      if (!live) {
        for (int q = 0; q < 5; ++q) st[q] = end_token[q];
      }
      const int t = s_t + live;
      s_done = s_done || (st[4] > 0.5f) || (live && t >= cap);
      s_t = t;
      s_live = live;
      float* out = strokes + ((size_t)s * B + row) * 5;
      for (int q = 0; q < 5; ++q) {
        out[q] = st[q];
        s_x[q] = st[q];
      }
    }
    __syncthreads();
    if (s_live) {
      for (int j = threadIdx.x; j < H; j += kThreads) {
        s_c[j] = s_cn[j];
        s_h[j] = s_hn[j];
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < H; j += kThreads) {
    c_out[(size_t)row * H + j] = s_c[j];
    h_out[(size_t)row * H + j] = s_h[j];
  }
  if (threadIdx.x == 0) {
    t_out[row] = s_t;
    done_out[row] = s_done;
  }
}

__host__ __device__ inline size_t replay_smem_floats(int H) {
  return (size_t)4 * H + (size_t)4 * H + 8 + (size_t)kWarps * 4 + 4;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
replay_chunk_kernel(CellParams<W> p, const float* __restrict__ c0,
                    const float* __restrict__ h0,
                    const float* __restrict__ xs,
                    const float* __restrict__ extra_xp,
                    const int* __restrict__ seq_len, int B, int E,
                    float* __restrict__ c_out, float* __restrict__ h_out) {
  extern __shared__ float smem[];
  const int H = p.H, G = 4 * H;
  const int row = blockIdx.x;
  float* s_c = smem;
  float* s_h = s_c + H;
  float* s_cn = s_h + H;
  float* s_hn = s_cn + H;
  float* s_pre = s_hn + H;
  float* s_x = s_pre + G;
  float* s_red = s_x + 8;

  for (int j = threadIdx.x; j < H; j += kThreads) {
    s_c[j] = c0[(size_t)row * H + j];
    s_h[j] = h0[(size_t)row * H + j];
  }
  const float* extra_row =
      extra_xp != nullptr ? extra_xp + (size_t)row * G : nullptr;
  const int len = seq_len[row];
  for (int s = 0; s < E; ++s) {
    if (threadIdx.x < 5)
      s_x[threadIdx.x] = xs[((size_t)s * B + row) * 5 + threadIdx.x];
    __syncthreads();
    cell_step<5, W>(p, s_x, extra_row, s_c, s_h, s_pre, s_cn, s_hn, s_red);
    if (s < len) {
      for (int j = threadIdx.x; j < H; j += kThreads) {
        s_c[j] = s_cn[j];
        s_h[j] = s_hn[j];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += kThreads) {
    c_out[(size_t)row * H + j] = s_c[j];
    h_out[(size_t)row * H + j] = s_h[j];
  }
}

template <typename W>
CellParams<W> make_params(const void* wx, const void* wh, const float* b,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          int H, int layer_norm, float forget_bias) {
  CellParams<W> p;
  p.wx = static_cast<const W*>(wx);
  p.wh = static_cast<const W*>(wh);
  p.b = b;
  p.ln_gamma = ln_gamma;
  p.ln_beta = ln_beta;
  p.lnc_gamma = lnc_gamma;
  p.lnc_beta = lnc_beta;
  p.H = H;
  p.layer_norm = layer_norm;
  p.forget_bias = forget_bias;
  return p;
}

template <typename W>
cudaError_t launch_decode_rowblock(const void* wx, const void* wh, const float* b,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          const void* out_w, const float* out_b,
                          const float* c0, const float* h0,
                          const float* prev0, const float* extra_xp,
                          const float* u, const float* temps, const int* t0,
                          const int* done0, const int* caps,
                          const float* end_token, int B, int K, int H, int M,
                          int layer_norm, int greedy, float forget_bias,
                          float* strokes, float* c_out, float* h_out,
                          int* t_out, int* done_out, cudaStream_t stream) {
  const CellParams<W> p = make_params<W>(wx, wh, b, ln_gamma, ln_beta,
                                         lnc_gamma, lnc_beta, H, layer_norm,
                                         forget_bias);
  const size_t smem = decode_smem_floats(H, 6 * M + 3, M) * sizeof(float);
  cudaError_t err = set_smem((const void*)decode_chunk_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  decode_chunk_kernel<W><<<B, kThreads, smem, stream>>>(
      p, static_cast<const W*>(out_w), out_b, c0, h0, prev0, extra_xp, u,
      temps, t0, done0, caps, end_token, B, K, M, greedy, strokes, c_out,
      h_out, t_out, done_out);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_replay_rowblock(const void* wx, const void* wh, const float* b,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          const float* c0, const float* h0, const float* xs,
                          const float* extra_xp, const int* seq_len, int B,
                          int E, int H, int layer_norm, float forget_bias,
                          float* c_out, float* h_out, cudaStream_t stream) {
  const CellParams<W> p = make_params<W>(wx, wh, b, ln_gamma, ln_beta,
                                         lnc_gamma, lnc_beta, H, layer_norm,
                                         forget_bias);
  const size_t smem = replay_smem_floats(H) * sizeof(float);
  cudaError_t err = set_smem((const void*)replay_chunk_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  replay_chunk_kernel<W><<<B, kThreads, smem, stream>>>(
      p, c0, h0, xs, extra_xp, seq_len, B, E, c_out, h_out);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The persistent design (srt_decode_chunk, srt_replay_chunk; header, "Design")

constexpr int kDecThreads = 256, kDecWarps = kDecThreads / 32;
constexpr int kSliceUnits = 16;                   // hidden units a slice
constexpr int kCols = 4 * kSliceUnits;            // a slice's gate columns
constexpr int kPass = kDecThreads / kSliceUnits;  // rows a pass: a pair a thread
constexpr int kXd = 5;                            // stroke-5 inputs
constexpr int kMaxSlices = 32;                    // H <= 512
constexpr int kHParts = 4;                        // cp.async groups over k
constexpr int kStEx = 8;    // stroke exchange a row: x[5], live, 2 unused
constexpr int kGateEx = 8;  // gate exchange a row and slice: mean[4], M2[4]
constexpr int kSimtRows = 2;  // rows a thread in the SIMT products

static_assert(kDecWarps == 8 && kPass == 16,
              "the products' tasks: 2 column halves x 4 row groups");

// elements of a resident wh or wx row (64 columns): bf16 rows padded by 16
// bytes, so that the 8 rows of a transposed ldmatrix fall in distinct banks
__host__ __device__ constexpr int w_stride(int wsize) {
  return wsize == 2 ? kCols + 8 : kCols;
}

// The projection's columns, padded to whole 16-byte rows of the partials
__host__ __device__ inline int padded_cols(int P) { return (P + 3) / 4 * 4; }

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) / 16 * 16; }

// elements of a staged h row: whole 16-byte copies, plus a pad that puts
// the four rows a warp reads at once in distinct banks
__host__ __device__ inline int serve_row_stride(int H, int wsize) {
  return (H + 7) / 8 * 8 + 16 / wsize;
}

// A block's shared memory, byte offsets of its parts for tiles of nb rows
// (ops/cuda_decode.py::decode_plan sums the same parts): the resident wh
// and wx columns [H + 5][w_stride] of type W; DEC: its units' out_w rows
// [16][P] as float; its tile's extra_xp [nb][64], its b [64], the slices'
// unit counts [32]; the pairs' c and h [nb][16]; DEC: their rounded new h
// [nb][16]; the pre-activations [nb][64] (LN: then nc and the normalized
// o); the step's x and liveness [nb][8]; DEC: t and done of its owned rows
// (replay: the rows' seq_len) [nb][2]; DEC: the sampler's raw row [Pp],
// out_b [Pp], END_TOKEN [8], log pi and the weights [2][Mp] and 4 more; a
// buffer for a pass's h rows or a pass's rows of the gate exchange.
struct ServeSmem {
  size_t w, ow, xe, b, n, c, h, hn, pre, x, own, samp, buf, total;
};

__host__ __device__ inline ServeSmem serve_smem(bool dec, int wsize, int H,
                                                int M, int slices, int nb) {
  const int P = 6 * M + 3, Pp = padded_cols(P), Mp = (M + 3) / 4 * 4;
  const size_t pairs = (size_t)nb * kSliceUnits * sizeof(float);
  ServeSmem s;
  size_t o = 0;
  s.w = o;
  o += al16((size_t)(H + kXd) * w_stride(wsize) * wsize);
  s.ow = o;
  o += dec ? al16((size_t)kSliceUnits * P * sizeof(float)) : 0;
  s.xe = o;
  o += (size_t)nb * kCols * sizeof(float);
  s.b = o;
  o += kCols * sizeof(float);
  s.n = o;
  o += kMaxSlices * sizeof(float);
  s.c = o;
  o += pairs;
  s.h = o;
  o += pairs;
  s.hn = o;
  o += dec ? pairs : 0;
  s.pre = o;
  o += (size_t)nb * kCols * sizeof(float);
  s.x = o;
  o += (size_t)nb * kStEx * sizeof(float);
  s.own = o;
  o += al16((size_t)nb * 2 * sizeof(int));
  s.samp = o;
  o += dec ? (size_t)(2 * Pp + 8 + 2 * Mp + 4) * sizeof(float) : 0;
  size_t buf = (size_t)kPass * serve_row_stride(H, wsize) * wsize;
  const size_t gx = (size_t)kPass * slices * kGateEx * sizeof(float);
  if (gx > buf) buf = gx;
  s.buf = o;
  o += al16(buf);
  s.total = o;
  return s;
}

// The scratch beside the kernel, carved from one buffer of this many bytes
// in this order (16-byte aligned first): hx [2][B][H] of type W; the gate
// exchange [B][slices][8]; DEC: the projection partials [B][slices][Pp]
// and the stroke exchange [B][8]; the cell exchange [B][slices][2].
template <typename W>
struct ServeWork {
  W* hx;
  float* exg;
  float* part;
  float* st;
  float* exc;
};

inline size_t serve_scratch_bytes(bool dec, int wsize, int B, int H, int M,
                                  int slices) {
  const size_t rs = (size_t)B * slices;
  size_t n = al16((size_t)2 * B * H * wsize) + rs * kGateEx * sizeof(float);
  if (dec)
    n += rs * padded_cols(6 * M + 3) * sizeof(float) +
         (size_t)B * kStEx * sizeof(float);
  return n + rs * 2 * sizeof(float);
}

template <typename W>
ServeWork<W> serve_work(void* scratch, bool dec, int B, int H, int M,
                        int slices) {
  unsigned char* p = static_cast<unsigned char*>(scratch);
  const size_t rs = (size_t)B * slices;
  ServeWork<W> w;
  w.hx = reinterpret_cast<W*>(p);
  w.exg = reinterpret_cast<float*>(p + al16((size_t)2 * B * H * sizeof(W)));
  float* q = w.exg + rs * kGateEx;
  w.part = dec ? q : nullptr;
  if (dec) q += rs * padded_cols(6 * M + 3);
  w.st = dec ? q : nullptr;
  if (dec) q += (size_t)B * kStEx;
  w.exc = q;
  return w;
}

// A call's operands (every pointer a device pointer of a contiguous tensor;
// DEC-only ones null in a replay, and the reverse).
template <typename W>
struct Serve {
  const W* wx;             // [5, 4H]: the stroke rows of the input weight
  const W* wh;             // [H, 4H]
  const float* b;          // [4H] (lstm)
  const float* ln_gamma;   // [4, H] (layer_norm)
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
  const W* out_w;          // [H, P] (DEC)
  const float* out_b;      // [P] (DEC)
  const float* c0;         // [B, H]
  const float* h0;         // [B, H]
  const float* xs;         // DEC: prev0 [B, 5]; replay: xs [E, B, 5]
  const float* extra_xp;   // [B, 4H] or null
  const float* u;          // [K, B, 4] (DEC)
  const float* temps;      // [B] (DEC)
  const int* t0;           // [B] (DEC)
  const int* done0;        // [B] (DEC)
  const int* caps;         // [B] (DEC)
  const float* end_token;  // [5] (DEC)
  const int* seq_len;      // [B] (replay)
  float* strokes;          // [K, B, 5] (DEC)
  float* c_out;            // [B, H]
  float* h_out;            // [B, H]
  int* t_out;              // [B] (DEC)
  int* done_out;           // [B] (DEC)
  ServeWork<W> wk;
  int B, steps, H, M, greedy;
  float forget_bias;
};

// one quad (4 consecutive elements) of shared memory as float
__device__ __forceinline__ float4 quad(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 quad(const bf16* w) {
  const uint2 r = *reinterpret_cast<const uint2*>(w);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

// b0, b1 of mma_bf16 (mma.cuh) from a [k][n] row-major 16 x 8 tile: lanes
// 0-15 give the addresses of its 16 rows
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float h, float4 w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// 4 consecutive weights into shared memory: 16 bytes of float (through
// L2), 8 bytes of bf16
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  static_assert(kHParts == 4, "one case per part");
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else
    asm volatile("cp.async.wait_group 3;\n" ::);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one h value written by another block of this kernel (L2, not L1)
__device__ __forceinline__ float ldcg_raw(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg_raw(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// h_{t-1} of the rows row0 .. row0 + pr - 1 into s_hb (row stride rs, type
// W). At t = 0 (hin null) rnd_W(h0) through registers. After it the hx
// plane of the previous step, written by other blocks of this kernel: by
// 16-byte cp.async.cg (L2, never a stale L1 line), kp columns of every row
// per commit group, when the rows allow it, else element by element. Each
// thread commits kHParts groups either way.
template <typename W>
__device__ __forceinline__ void load_h_rows(W* s_hb, int rs, const float* h0,
                                            const W* hin, bool async,
                                            size_t row0, int pr, int H,
                                            int kp) {
  constexpr int kE = 16 / sizeof(W);  // elements per copy
  if (hin != nullptr && async) {
    for (int part = 0; part < kHParts; ++part) {
      const int k0 = part * kp, k1 = k0 + kp < H ? k0 + kp : H;
      const int n = k0 < H ? (k1 - k0) / kE : 0;  // copies per row
      for (int e = threadIdx.x; e < pr * n; e += kDecThreads) {
        const int r = e / n, k = k0 + (e - r * n) * kE;
        cp_async16(s_hb + r * rs + k, hin + (row0 + r) * H + k);
      }
      cp_async_commit();
    }
    return;
  }
  for (int e = threadIdx.x; e < pr * H; e += kDecThreads) {
    const int r = e / H, k = e - r * H;
    const size_t at = (row0 + r) * H + k;
    s_hb[r * rs + k] = hin == nullptr ? from_f<W>(h0[at]) : ldcg_raw(hin + at);
  }
  for (int part = 0; part < kHParts; ++part) cp_async_commit();
}

// n floats of an exchange from src, written by other blocks of this
// kernel, into dst: 16-byte cp.async.cg copies (L2) where both allow them,
// else loads through L2. Every thread calls it; it ends with a barrier of
// the block.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  if (aligned16(src) && n % 4 == 0) {
    for (int e = threadIdx.x; e < n / 4; e += kDecThreads)
      cp_async16(dst + 4 * e, src + 4 * e);
    cp_async_commit();
    cp_async_wait_all();
  } else {
    for (int e = threadIdx.x; e < n; e += kDecThreads) dst[e] = __ldcg(src + e);
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void half_warp_sum(float (&v)[N]) {
#pragma unroll
  for (int off = kSliceUnits / 2; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < N; ++g)
      v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
}

// The slice-local moments of N values per lane over the 16 lanes of a half
// warp (one row's units; a lane past the slice's n units contributes
// nothing): mean[g] = sum / n, then m2[g] = sum of (v - mean)^2 (two
// passes). Every lane gets them. All 32 lanes must call it. (A copy of
// fused_rnn.cu's, as is chan_stats.)
template <int N>
__device__ __forceinline__ void slice_moments(const float (&v)[N], bool real,
                                              float n, float (&mean)[N],
                                              float (&m2)[N]) {
#pragma unroll
  for (int g = 0; g < N; ++g) mean[g] = real ? v[g] : 0.0f;
  half_warp_sum(mean);
#pragma unroll
  for (int g = 0; g < N; ++g) {
    mean[g] = mean[g] / n;
    const float d = v[g] - mean[g];
    m2[g] = real ? d * d : 0.0f;
  }
  half_warp_sum(m2);
}

// The layer-norm statistics of N rows from their slices' (mean, M2)
// partials, m[n][k * stride] and m[n][k * stride + off], each row's
// combined in slice order by Chan's rule: mean = sum_k n_k m_k / H, M2 =
// sum_k (M2_k + n_k (m_k - mean)^2), rs = rsqrt(M2 / H + 1e-6). s_n holds
// each slice's unit count.
template <int N>
__device__ __forceinline__ void chan_stats(const float* const (&m)[N],
                                           int stride, int off,
                                           const float* s_n, int slices,
                                           float fh, float (&mean)[N],
                                           float (&rs)[N]) {
  float s[N], q[N];
#pragma unroll
  for (int r = 0; r < N; ++r) s[r] = q[r] = 0.0f;
  for (int k = 0; k < slices; ++k) {
    const float n = s_n[k];
#pragma unroll
    for (int r = 0; r < N; ++r) s[r] += n * m[r][k * stride];
  }
#pragma unroll
  for (int r = 0; r < N; ++r) mean[r] = s[r] / fh;
  for (int k = 0; k < slices; ++k) {
    const float n = s_n[k];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float d = m[r][k * stride] - mean[r];
      q[r] += m[r][k * stride + off] + n * (d * d);
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) rs[r] = rsqrtf(q[r] / fh + 1e-6f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sampler of one row on one warp (all 32 lanes call it), from the
// row's raw projection s_raw (the slices' partials summed, out_b added):
// log_pi = log_softmax(logits) and the component's weights softmax(log_pi
// / tau) a lane a component with warp-shuffle maxima and sums; on lane 0
// the CDF, a running sum of the weights in index order, the pen draw and
// the Box-Muller offsets as the row-block design takes them, then the
// mask. us: the step's four uniforms; own holds the row's t and done (lane
// 0 updates them); the stroke goes to out (strokes[s, row]) and to st (the
// stroke exchange, with the row's liveness for the next step). samp holds
// 2 Mp + 4 floats.
__device__ __forceinline__ void sample_row(const float* s_raw, int M,
                                           float4 us, float tau, int cap,
                                           int greedy, const float* end_token,
                                           float* samp, int* own, float* out,
                                           float* st) {
  const int lane = threadIdx.x & 31, Mp = (M + 3) / 4 * 4;
  float* s_lp = samp;
  float* s_q = s_lp + Mp;  // the weights, then the pen draw's scratch
  // log_pi = log_softmax(logits), jax.nn.log_softmax's association
  const float* logits = s_raw + 3;
  float mx = -INFINITY;
  for (int m = lane; m < M; m += 32) mx = fmaxf(mx, logits[m]);
  mx = warp_max(mx);
  float se = 0.0f;
  for (int m = lane; m < M; m += 32) se += expf(logits[m] - mx);
  se = warp_sum(se);
  const float lse = logf(se);
  float emx = -INFINITY;
  for (int m = lane; m < M; m += 32) {
    const float lp = (logits[m] - mx) - lse;
    s_lp[m] = lp;
    emx = fmaxf(emx, lp / tau);
  }
  if (!greedy) {  // the component's weights, inverse_cdf_'s terms
    emx = warp_max(emx);
    float es = 0.0f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(s_lp[m] / tau - emx);
      s_q[m] = e;
      es += e;
    }
    es = warp_sum(es);
    for (int m = lane; m < M; m += 32) s_q[m] = s_q[m] / es;
  }
  __syncwarp();
  if (lane != 0) return;
  const float* mu1 = s_raw + 3 + M;
  const float* mu2 = s_raw + 3 + 2 * M;
  const float* ls1 = s_raw + 3 + 3 * M;
  const float* ls2 = s_raw + 3 + 4 * M;
  const float* rho_raw = s_raw + 3 + 5 * M;
  int idx, pen_idx;
  float dx, dy;
  if (greedy) {
    idx = argmax_(s_lp, M, 1);
    pen_idx = argmax_(s_raw, 3, 1);
    dx = mu1[idx];
    dy = mu2[idx];
  } else {
    const float r = sqrtf(-2.0f * logf(fmaxf(us.z, 1e-12f)));
    const float theta = kTwoPi * us.w;
    const float e0 = r * cosf(theta), e1 = r * sinf(theta);
    const float sq = sqrtf(tau);
    float cdf = 0.0f;
    int count = 0;
    for (int m = 0; m < M; ++m) {
      cdf += s_q[m];
      count += (us.x > cdf) ? 1 : 0;
    }
    idx = count < M - 1 ? count : M - 1;
    pen_idx = inverse_cdf_(s_raw, 3, tau, us.y, s_q + Mp);
    const float s1 = expf(ls1[idx]);
    const float s2 = expf(ls2[idx]);
    const float rho = tanhf(rho_raw[idx]);
    dx = mu1[idx] + s1 * sq * e0;
    dy = mu2[idx] + s2 * sq * (rho * e0 + sqrtf(1.0f - rho * rho) * e1);
  }
  const int done = own[1], live = !done;
  float x[5] = {dx, dy, pen_idx == 0 ? 1.0f : 0.0f,
                pen_idx == 1 ? 1.0f : 0.0f, pen_idx == 2 ? 1.0f : 0.0f};
  if (!live) {
    for (int q = 0; q < 5; ++q) x[q] = end_token[q];
  }
  const int t = own[0] + live;
  const int dn = done || (x[4] > 0.5f) || (live && t >= cap);
  own[0] = t;
  own[1] = dn;
  for (int q = 0; q < 5; ++q) {
    out[q] = x[q];
    st[q] = x[q];
  }
  st[kXd] = dn ? 0.0f : 1.0f;
}

template <typename W, bool LN, bool DEC>
__global__ void __launch_bounds__(kDecThreads, 1)
serve_loop_kernel(Serve<W> a, int slices, int tiles, int r0, int nr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, G = 4 * H, B = a.B, M = a.M, P = 6 * M + 3;
  const int Pp = padded_cols(P);
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  const int nb_max = (nr + tiles - 1) / tiles;
  const ServeSmem L = serve_smem(DEC, sizeof(W), H, M, slices, nb_max);
  W* s_w = reinterpret_cast<W*>(smem_raw + L.w);  // [H + 5][WS]
  float* s_ow = reinterpret_cast<float*>(smem_raw + L.ow);
  float* s_xe = reinterpret_cast<float*>(smem_raw + L.xe);
  float* s_b = reinterpret_cast<float*>(smem_raw + L.b);
  float* s_n = reinterpret_cast<float*>(smem_raw + L.n);
  float* s_c = reinterpret_cast<float*>(smem_raw + L.c);
  float* s_h = reinterpret_cast<float*>(smem_raw + L.h);
  float* s_hn = reinterpret_cast<float*>(smem_raw + L.hn);
  float* s_pre = reinterpret_cast<float*>(smem_raw + L.pre);
  float* s_x = reinterpret_cast<float*>(smem_raw + L.x);
  int* s_own = reinterpret_cast<int*>(smem_raw + L.own);
  float* s_raw = reinterpret_cast<float*>(smem_raw + L.samp);  // [Pp]
  float* s_ob = s_raw + Pp;                                     // [Pp]
  float* s_end = s_ob + Pp;                                     // [8]
  float* s_samp = s_end + 8;
  float* s_buf = reinterpret_cast<float*>(smem_raw + L.buf);
  W* s_hb = reinterpret_cast<W*>(smem_raw + L.buf);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the pair phases: unit u of row prow of a pass, a half warp a row
  const int u = tid % kSliceUnits, prow = tid / kSliceUnits;
  const int half = lane & ~(kSliceUnits - 1);
  const bool unit = u < nu;
  const int j = j0 + (unit ? u : 0);
  // the SIMT products: columns 4 qd .. 4 qd + 3 (gate qd / 4) of the kRows
  // rows from trow (warps past 16 / kRows row groups idle)
  constexpr int kRows = kSimtRows;
  const int qd = lane & 15, trow = (warp * 2 + (lane >> 4)) * kRows;
  constexpr int WS = w_stride(sizeof(W));
  const W* wc = s_w + 4 * qd;
  const float fh = (float)H, fn = (float)nu, fb = a.forget_bias;
  const bool has_xe = a.extra_xp != nullptr;
  float gam[4], bet[4], gc = 0.0f, bc = 0.0f;
  if (LN) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gam[g] = unit ? a.ln_gamma[g * H + j] : 0.0f;
      bet[g] = unit ? a.ln_beta[g * H + j] : 0.0f;
    }
    gc = unit ? a.lnc_gamma[j] : 0.0f;
    bc = unit ? a.lnc_beta[j] : 0.0f;
  }

  // the resident state; the wh and wx columns in flight while the rest is
  // read
  if (H == slices * kSliceUnits && aligned16(a.wh) && aligned16(a.wx)) {
    for (int e = tid; e < (H + kXd) * kSliceUnits; e += kDecThreads) {
      const int k = e / kSliceUnits, q = e % kSliceUnits;  // quad q of row k
      const W* src = (k < H ? a.wh + (size_t)k * G
                            : a.wx + (size_t)(k - H) * G) +
                     (q / 4) * H + j0 + 4 * (q % 4);
      cp_async_quad(s_w + (size_t)k * WS + 4 * q, src);
    }
  } else {
    for (int e = tid; e < (H + kXd) * kCols; e += kDecThreads) {
      const int k = e / kCols, c = e % kCols, uu = c % kSliceUnits;
      const size_t at = (size_t)(c / kSliceUnits) * H + j0 + uu;
      float v = 0.0f;
      if (uu < nu)
        v = to_f(k < H ? a.wh[(size_t)k * G + at]
                       : a.wx[(size_t)(k - H) * G + at]);
      s_w[(size_t)k * WS + c] = from_f<W>(v);
    }
  }
  cp_async_commit();
  if (DEC) {
#pragma unroll 4
    for (int e = tid; e < kSliceUnits * P; e += kDecThreads) {
      const int uu = e / P, col = e - uu * P;
      s_ow[e] = uu < nu ? to_f(a.out_w[(size_t)(j0 + uu) * P + col]) : 0.0f;
    }
    for (int e = tid; e < P; e += kDecThreads) s_ob[e] = a.out_b[e];
    if (tid < kXd) s_end[tid] = a.end_token[tid];
  }
#pragma unroll 4
  for (int e = tid; e < nb * kCols; e += kDecThreads) {
    const int lr = e / kCols, c = e % kCols, uu = c % kSliceUnits;
    s_xe[e] = (has_xe && uu < nu)
                  ? a.extra_xp[(size_t)(b0 + lr) * G +
                               (c / kSliceUnits) * H + j0 + uu]
                  : 0.0f;
  }
  if (tid < kCols) {
    const int uu = tid % kSliceUnits;
    s_b[tid] = (!LN && uu < nu) ? a.b[(tid / kSliceUnits) * H + j0 + uu]
                                : 0.0f;
  }
  if (tid < slices)
    s_n[tid] = (float)((tid + 1) * H / slices - tid * H / slices);
  for (int e = tid; e < nb * kSliceUnits; e += kDecThreads) {
    const int uu = e % kSliceUnits;
    const size_t at = (size_t)(b0 + e / kSliceUnits) * H + j0 + uu;
    s_c[e] = uu < nu ? a.c0[at] : 0.0f;
    s_h[e] = uu < nu ? a.h0[at] : 0.0f;
  }
  if (DEC) {  // the owned rows' t and done: local rows sl, sl + slices, ...
    for (int i = tid; sl + i * slices < nb; i += kDecThreads) {
      const int row = b0 + sl + i * slices;
      s_own[2 * i] = a.t0[row];
      s_own[2 * i + 1] = a.done0[row] != 0;
    }
  } else {
    for (int lr = tid; lr < nb; lr += kDecThreads)
      s_own[lr] = a.seq_len[b0 + lr];
  }
  __syncthreads();  // the resident state (wh and wx: at the first product)

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const size_t plane = (size_t)B * H;
  const int rs = serve_row_stride(H, sizeof(W));
  const int kp = ((H + kHParts - 1) / kHParts + 7) / 8 * 8;  // k per part
  const bool async = H % (16 / (int)sizeof(W)) == 0 && aligned16(a.wk.hx);

  // bf16 weights and whole 64-unit groups: h @ wh on the tensor cores, a
  // warp 8 columns (one mma.sync n-tile) of the pass's 16 rows (the m-tile;
  // rows past pr read stale h and are not stored), k in steps of 16 as the
  // parts land; then the x part and the sums of its four outputs in
  // _cell_step's order
  const bool mma = sizeof(W) == 2 && H % 64 == 0 && H == slices * kSliceUnits;
  auto mma_pass = [&](int p0, int pr) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const W* ah = s_hb + (size_t)(lane & 15) * rs + 8 * (lane >> 4);
    const W* bw = s_w + (size_t)(lane & 15) * WS + 8 * warp;
#pragma unroll
    for (int part = 0; part < kHParts; ++part) {
      cp_async_wait(kHParts - 1 - part);  // this part's copies landed
      __syncthreads();  // ... for every thread: this part of k in s_hb
      const int k1 = (part + 1) * kp < H ? (part + 1) * kp : H;
      for (int k = part * kp; k < k1; k += 16) {
        uint32_t af[4], bf[2];
        ldmatrix_x4(af, ah + k);
        ldmatrix_x2_trans(bf, bw + (size_t)k * WS);
        mma_bf16(acc, af, bf[0], bf[1]);
      }
    }
    const int g = lane >> 2, c = 8 * warp + 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows g, g + 8; columns c, c + 1
      const int r = g + 8 * (q >> 1), col = c + (q & 1);
      if (r >= pr) continue;
      const int lr = p0 + r;
      float xp = 0.0f;
#pragma unroll
      for (int x = 0; x < kXd; ++x)
        xp = fmaf(rnd<W>(s_x[lr * kStEx + x]),
                  to_f(s_w[(size_t)(H + x) * WS + col]), xp);
      if (has_xe) xp = xp + s_xe[lr * kCols + col];
      if (!LN) xp = xp + s_b[col];
      s_pre[lr * kCols + col] = xp + acc[q];
    }
  };
  // a pair's new carry: kept unless its row was done at the step's start;
  // rnd_W(h) to the exchange, DEC: rnd_W(h_t) for the projection
  auto emit = [&](int lr, float nc, float nh, W* hout) {
    float* cp = s_c + lr * kSliceUnits + u;
    float* hp = s_h + lr * kSliceUnits + u;
    if (s_x[lr * kStEx + kXd] != 0.0f) {
      *cp = nc;
      *hp = nh;
    }
    hout[(size_t)(b0 + lr) * H + j] = from_f<W>(*hp);
    if (DEC) s_hn[lr * kSliceUnits + u] = rnd<W>(nh);
  };
  // DEC: the slice's partials of raw = h_t @ out_w for a pass's rows: a
  // thread a column (its 16 weights in registers) and 8 rows, each output
  // an in-order fmaf chain over the slice's units
  auto project = [&](int p0, int pr) {
    __syncthreads();  // the pass's rounded h in s_hn
    const int r0 = (tid >> 7) * 8;
    if (r0 >= pr) return;
    for (int col = tid & 127; col < P; col += 128) {
      float w[kSliceUnits], acc[8];
#pragma unroll
      for (int uu = 0; uu < kSliceUnits; ++uu)
        w[uu] = uu < nu ? s_ow[uu * P + col] : 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int uu = 0; uu < kSliceUnits; ++uu) {
        if (uu >= nu) break;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int lr = p0 + (r0 + r < pr ? r0 + r : pr - 1);
          acc[r] = fmaf(s_hn[lr * kSliceUnits + uu], w[uu], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r >= pr) break;
        a.wk.part[((size_t)(b0 + p0 + r0 + r) * slices + sl) * Pp + col] =
            acc[r];
      }
    }
  };

  for (int t = 0; t < a.steps; ++t) {
    const W* hin = t == 0 ? nullptr : a.wk.hx + ((t + 1) & 1) * plane;
    W* hout = a.wk.hx + (t & 1) * plane;
    // the step's x and liveness of the tile's rows
    for (int e = tid; e < nb * kStEx; e += kDecThreads) {
      const int lr = e / kStEx, q = e % kStEx, row = b0 + lr;
      float v = 0.0f;
      if (DEC) {
        if (t > 0)
          v = __ldcg(a.wk.st + (size_t)row * kStEx + q);
        else if (q < kXd)
          v = a.xs[(size_t)row * kXd + q];
        else if (q == kXd)
          v = a.done0[row] != 0 ? 0.0f : 1.0f;
      } else if (q < kXd) {
        v = a.xs[((size_t)t * B + row) * kXd + q];
      } else if (q == kXd) {
        v = t < s_own[lr] ? 1.0f : 0.0f;
      }
      s_x[e] = v;
    }
    // (a) the products, 16 rows a pass: ((x @ wx + extra_xp) [+ b]) + h @ wh
    for (int p0 = 0; p0 < nb; p0 += kPass) {
      const int pr = nb - p0 < kPass ? nb - p0 : kPass;
      load_h_rows<W>(s_hb, rs, a.h0, hin, async, (size_t)(b0 + p0), pr, H,
                     kp);
      if constexpr (sizeof(W) == 2) {
        if (mma) {
          mma_pass(p0, pr);
          __syncthreads();  // the pass's h rows read, its pre in s_pre
          continue;
        }
      }
      const bool busy = trow < pr;
      const W* hr[kRows];
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        hr[r] = s_hb + (size_t)(trow + r < pr ? trow + r : 0) * rs;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.0f;
      }
#pragma unroll
      for (int part = 0; part < kHParts; ++part) {
        cp_async_wait(kHParts - 1 - part);  // this part's copies landed
        __syncthreads();  // ... for every thread: this part of k in s_hb
        if (!busy) continue;
        const int k1 = (part + 1) * kp < H ? (part + 1) * kp : H;
        int k = part * kp;
#pragma unroll 2
        for (; k + 4 <= k1; k += 4) {
          float4 hv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) hv[r] = quad(hr[r] + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = quad(wc + (size_t)(k + kk) * WS);
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              fma4(acc[r], kk == 0 ? hv[r].x : kk == 1 ? hv[r].y
                                   : kk == 2 ? hv[r].z : hv[r].w, w);
          }
        }
        for (; k < k1; ++k) {
          const float4 w = quad(wc + (size_t)k * WS);
#pragma unroll
          for (int r = 0; r < kRows; ++r) fma4(acc[r], to_f(hr[r][k]), w);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!busy || trow + r >= pr) break;
        const int lr = p0 + trow + r;
        float xp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < kXd; ++q)
          fma4(xp, rnd<W>(s_x[lr * kStEx + q]),
               quad(wc + (size_t)(H + q) * WS));
        const float4 xe = quad(s_xe + lr * kCols + 4 * qd);
        const float4 bq = quad(s_b + 4 * qd);
        const float xev[4] = {xe.x, xe.y, xe.z, xe.w};
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        float pre[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = xp[i];
          if (has_xe) v = v + xev[i];
          if (!LN) v = v + bv[i];
          pre[i] = v + acc[r][i];
        }
        *reinterpret_cast<float4*>(s_pre + lr * kCols + 4 * qd) =
            make_float4(pre[0], pre[1], pre[2], pre[3]);
      }
      __syncthreads();  // the pass's h rows read, its pre in s_pre
    }

    if (LN) {
      // (a) each gate's slice moments of the pairs
      for (int p0 = 0; p0 < nb; p0 += kPass) {
        const int lr = p0 + prow;
        const bool ok = lr < nb;
        float pre[4], mean[4], m2[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = s_pre[(ok ? lr : p0) * kCols + g * kSliceUnits + u];
        slice_moments(pre, unit, fn, mean, m2);
        if (ok && u == 0) {
          float4* dst = reinterpret_cast<float4*>(
              a.wk.exg + ((size_t)(b0 + lr) * slices + sl) * kGateEx);
          dst[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
          dst[1] = make_float4(m2[0], m2[1], m2[2], m2[3]);
        }
      }
      grid.sync();  // the gates' slice moments complete
      // (b) the gate norms, the gate block, the cell's slice moments
      for (int p0 = 0; p0 < nb; p0 += kPass) {
        const int pr = nb - p0 < kPass ? nb - p0 : kPass;
        stage(s_buf, a.wk.exg + (size_t)(b0 + p0) * slices * kGateEx,
              pr * slices * kGateEx);
        const int lr = p0 + prow;
        const bool ok = lr < nb;
        const int lq = ok ? lr : p0;
        // lane u combines gate u % 4 of its row; the half warp shares them
        const float* ex[1] = {s_buf + (size_t)(ok ? prow : 0) * slices *
                                          kGateEx + (u & 3)};
        float gm[1], gr[1];
        chan_stats(ex, kGateEx, 4, s_n, slices, fh, gm, gr);
        float y[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float mean = __shfl_sync(0xffffffffu, gm[0], half | g);
          const float rsg = __shfl_sync(0xffffffffu, gr[0], half | g);
          y[g] = (s_pre[lq * kCols + g * kSliceUnits + u] - mean) * rsg *
                     gam[g] + bet[g];
        }
        const float nc[1] = {s_c[lq * kSliceUnits + u] *
                                 sigmoidf_(y[2] + fb) +
                             sigmoidf_(y[0]) * tanhf(y[1])};
        float cm[1], cq[1];
        slice_moments(nc, unit, fn, cm, cq);
        if (ok) {
          if (u == 0)
            reinterpret_cast<float2*>(
                a.wk.exc)[(size_t)(b0 + lr) * slices + sl] =
                make_float2(cm[0], cq[0]);
          s_pre[lr * kCols + u] = nc[0];
          s_pre[lr * kCols + 3 * kSliceUnits + u] = y[3];
        }
        __syncthreads();  // s_buf read: next pass
      }
      grid.sync();  // the cell's slice moments complete
      // (c) the cell norm, h, the freeze, hx; DEC: the projection partials
      for (int p0 = 0; p0 < nb; p0 += kPass) {
        const int pr = nb - p0 < kPass ? nb - p0 : kPass;
        stage(s_buf, a.wk.exc + (size_t)(b0 + p0) * slices * 2,
              pr * slices * 2);
        const int lr = p0 + prow;
        const bool ok = lr < nb;
        const float* ex[1] = {s_buf + (size_t)(ok ? prow : 0) * slices * 2};
        float cmean[1], crs[1];
        chan_stats(ex, 2, 1, s_n, slices, fh, cmean, crs);
        if (ok && unit) {
          const float nc = s_pre[lr * kCols + u];
          const float yo = s_pre[lr * kCols + 3 * kSliceUnits + u];
          const float oc = (nc - cmean[0]) * crs[0] * gc + bc;
          emit(lr, nc, tanhf(oc) * sigmoidf_(yo), hout);
        }
        if (DEC) project(p0, pr);
        __syncthreads();  // s_buf read: next pass
      }
    } else {
      // (a) the gate block, h, the freeze, hx; DEC: the projection partials
      for (int p0 = 0; p0 < nb; p0 += kPass) {
        const int pr = nb - p0 < kPass ? nb - p0 : kPass;
        const int lr = p0 + prow;
        if (lr < nb && unit) {
          const float* pre = s_pre + lr * kCols + u;
          const float i = pre[0], g = pre[kSliceUnits],
                      f = pre[2 * kSliceUnits], o = pre[3 * kSliceUnits];
          const float nc = s_c[lr * kSliceUnits + u] * sigmoidf_(f + fb) +
                           sigmoidf_(i) * tanhf(g);
          emit(lr, nc, tanhf(nc) * sigmoidf_(o), hout);
        }
        if (DEC) project(p0, pr);
      }
    }
    if (!DEC) {
      if (t + 1 < a.steps) grid.sync();  // hx[t & 1] complete
      continue;
    }
    grid.sync();  // hx[t & 1] and the projection partials complete
    // (d) the sampler of each owned row
    for (int lr = sl, i = 0; lr < nb; lr += slices, ++i) {
      const int row = b0 + lr;
      float4 us = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float tau = 1.0f;
      int cap = 0;
      if (warp == 0) {  // asked for before the partials
        us = *reinterpret_cast<const float4*>(a.u + ((size_t)t * B + row) * 4);
        tau = a.temps[row];
        cap = a.caps[row];
      }
      // raw: the slices' partials summed in slice order, plus out_b; a
      // thread a column, all its loads in flight at once
      for (int col = tid; col < P; col += kDecThreads) {
        const float* src = a.wk.part + (size_t)row * slices * Pp + col;
        float v[kMaxSlices];
#pragma unroll
        for (int k = 0; k < kMaxSlices; ++k)
          if (k < slices) v[k] = __ldcg(src + (size_t)k * Pp);
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxSlices; ++k)
          if (k < slices) sum += v[k];
        s_raw[col] = sum + s_ob[col];
      }
      __syncthreads();  // the row's raw in s_raw
      if (warp == 0)
        sample_row(s_raw, M, us, tau, cap, a.greedy, s_end, s_samp,
                   s_own + 2 * i, a.strokes + ((size_t)t * B + row) * 5,
                   a.wk.st + (size_t)row * kStEx);
      __syncthreads();  // s_raw read, the row's t and done kept
    }
    if (t + 1 < a.steps) grid.sync();  // the strokes: step t + 1's x
  }

  __syncthreads();  // the last step's carries and owned rows
  for (int e = tid; e < nb * kSliceUnits; e += kDecThreads) {
    const int uu = e % kSliceUnits;
    if (uu >= nu) continue;
    const size_t at = (size_t)(b0 + e / kSliceUnits) * H + j0 + uu;
    a.c_out[at] = s_c[e];
    a.h_out[at] = s_h[e];
  }
  if (DEC) {
    for (int i = tid; sl + i * slices < nb; i += kDecThreads) {
      const int row = b0 + sl + i * slices;
      a.t_out[row] = s_own[2 * i];
      a.done_out[row] = s_own[2 * i + 1];
    }
  }
}

// The plan (ops/cuda_decode.py::decode_plan): `slices` slices of at most 16
// units, at most `tiles` batch tiles a window, `windows` windows of rows,
// `smem` bytes of shared memory a block.
struct ServePlan {
  int slices, tiles, windows, smem;
};

template <typename W, bool LN, bool DEC>
const void* serve_fn() {
  return (const void*)serve_loop_kernel<W, LN, DEC>;
}

// The plan checked against the shape before any launch (an error, never a
// fallback: cudaErrorInvalidValue where the plan does not hold the shape,
// persist.cuh's checks where its blocks cannot co-reside), then one
// cooperative launch a window.
template <typename W, bool LN, bool DEC>
cudaError_t launch_serve(const Serve<W>& a, const ServePlan& pl,
                         cudaStream_t stream) {
  const int B = a.B, H = a.H;
  if (B < 1 || H < 1 || a.M < 1 || a.steps < 0 || pl.slices < 1 ||
      pl.slices > kMaxSlices || pl.slices > H ||
      (H + pl.slices - 1) / pl.slices > kSliceUnits || pl.tiles < 1 ||
      pl.windows < 1 || pl.windows > B || pl.smem < 0 ||
      a.wk.hx == nullptr || (LN ? a.ln_gamma == nullptr : a.b == nullptr))
    return cudaErrorInvalidValue;
  Windows win;
  win.n = pl.windows;
  win.smem = (size_t)pl.smem;
  int blocks = 0;
  for (int i = 0; i < win.n; ++i) {
    const int nr = win.rows(i, B), tiles = nr < pl.tiles ? nr : pl.tiles;
    if (serve_smem(DEC, sizeof(W), H, a.M, pl.slices, (nr + tiles - 1) / tiles)
            .total > win.smem)
      return cudaErrorInvalidValue;
    if (pl.slices * tiles > blocks) blocks = pl.slices * tiles;
  }
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(sms, smem_max);
  const void* fn = serve_fn<W, LN, DEC>();
  if (err == cudaSuccess) err = ready_loop(fn, kDecThreads, win, blocks, sms);
  for (int i = 0; i < win.n && err == cudaSuccess; ++i) {
    int r0 = win.first(i, B), nr = win.rows(i, B);
    int slices = pl.slices, tiles = nr < pl.tiles ? nr : pl.tiles;
    Serve<W> args = a;
    void* params[] = {&args, &slices, &tiles, &r0, &nr};
    err = cudaLaunchCooperativeKernel(fn, dim3(slices * tiles),
                                      dim3(kDecThreads), params, win.smem,
                                      stream);
  }
  return err;
}

template <typename W>
Serve<W> make_serve(const void* wx, const void* wh, const float* b,
                    const float* ln_gamma, const float* ln_beta,
                    const float* lnc_gamma, const float* lnc_beta,
                    const float* c0, const float* h0, const float* xs,
                    const float* extra_xp, int B, int steps, int H,
                    float forget_bias, float* c_out, float* h_out) {
  Serve<W> a = {};
  a.wx = static_cast<const W*>(wx);
  a.wh = static_cast<const W*>(wh);
  a.b = b;
  a.ln_gamma = ln_gamma;
  a.ln_beta = ln_beta;
  a.lnc_gamma = lnc_gamma;
  a.lnc_beta = lnc_beta;
  a.c0 = c0;
  a.h0 = h0;
  a.xs = xs;
  a.extra_xp = extra_xp;
  a.c_out = c_out;
  a.h_out = h_out;
  a.B = B;
  a.steps = steps;
  a.H = H;
  a.M = 1;
  a.forget_bias = forget_bias;
  return a;
}

template <typename W>
cudaError_t launch_decode(const void* wx, const void* wh, const float* b,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          const void* out_w, const float* out_b,
                          const float* c0, const float* h0,
                          const float* prev0, const float* extra_xp,
                          const float* u, const float* temps, const int* t0,
                          const int* done0, const int* caps,
                          const float* end_token, int B, int K, int H, int M,
                          int layer_norm, int greedy, float forget_bias,
                          const ServePlan& pl, void* scratch, float* strokes,
                          float* c_out, float* h_out, int* t_out,
                          int* done_out, cudaStream_t stream) {
  if (scratch == nullptr || M < 1) return cudaErrorInvalidValue;
  Serve<W> a = make_serve<W>(wx, wh, b, ln_gamma, ln_beta, lnc_gamma,
                             lnc_beta, c0, h0, prev0, extra_xp, B, K, H,
                             forget_bias, c_out, h_out);
  a.out_w = static_cast<const W*>(out_w);
  a.out_b = out_b;
  a.u = u;
  a.temps = temps;
  a.t0 = t0;
  a.done0 = done0;
  a.caps = caps;
  a.end_token = end_token;
  a.strokes = strokes;
  a.t_out = t_out;
  a.done_out = done_out;
  a.M = M;
  a.greedy = greedy;
  a.wk = serve_work<W>(scratch, true, B, H, M, pl.slices);
  return layer_norm ? launch_serve<W, true, true>(a, pl, stream)
                    : launch_serve<W, false, true>(a, pl, stream);
}

template <typename W>
cudaError_t launch_replay(const void* wx, const void* wh, const float* b,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          const float* c0, const float* h0, const float* xs,
                          const float* extra_xp, const int* seq_len, int B,
                          int E, int H, int layer_norm, float forget_bias,
                          const ServePlan& pl, void* scratch, float* c_out,
                          float* h_out, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  Serve<W> a = make_serve<W>(wx, wh, b, ln_gamma, ln_beta, lnc_gamma,
                             lnc_beta, c0, h0, xs, extra_xp, B, E, H,
                             forget_bias, c_out, h_out);
  a.seq_len = seq_len;
  a.wk = serve_work<W>(scratch, false, B, H, 1, pl.slices);
  return layer_norm ? launch_serve<W, true, false>(a, pl, stream)
                    : launch_serve<W, false, false>(a, pl, stream);
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers of contiguous tensors (float32 unless
// named int32; wx, wh and out_w are bfloat16 when w_bf16); b is null for
// layer_norm, the ln_* are null for lstm, extra_xp is null for an
// unconditional, classless model. The plan (slices, tiles, windows, smem)
// is ops/cuda_decode.py::decode_plan's, checked here; scratch holds its
// bytes (serve_scratch_bytes). Returns the first CUDA error of the checks
// and launches, 0 when there is none.
int srt_decode_chunk(const void* wx, const void* wh, const float* b,
                     const float* ln_gamma, const float* ln_beta,
                     const float* lnc_gamma, const float* lnc_beta,
                     const void* out_w, const float* out_b, const float* c0,
                     const float* h0, const float* prev0,
                     const float* extra_xp, const float* u,
                     const float* temps, const int* t0, const int* done0,
                     const int* caps, const float* end_token, int B, int K,
                     int H, int M, int layer_norm, int greedy, int w_bf16,
                     float forget_bias, int slices, int tiles, int windows,
                     int smem, void* scratch, float* strokes, float* c_out,
                     float* h_out, int* t_out, int* done_out, void* stream) {
  const ServePlan pl = {slices, tiles, windows, smem};
#define SRT_DECODE_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, out_w, out_b, c0, h0,  \
      prev0, extra_xp, u, temps, t0, done0, caps, end_token, B, K, H, M,    \
      layer_norm, greedy, forget_bias, pl, scratch, strokes, c_out, h_out,  \
      t_out, done_out, (cudaStream_t)stream
  if (w_bf16) return (int)launch_decode<bf16>(SRT_DECODE_ARGS);
  return (int)launch_decode<float>(SRT_DECODE_ARGS);
#undef SRT_DECODE_ARGS
}

int srt_replay_chunk(const void* wx, const void* wh, const float* b,
                     const float* ln_gamma, const float* ln_beta,
                     const float* lnc_gamma, const float* lnc_beta,
                     const float* c0, const float* h0, const float* xs,
                     const float* extra_xp, const int* seq_len, int B, int E,
                     int H, int layer_norm, int w_bf16, float forget_bias,
                     int slices, int tiles, int windows, int smem,
                     void* scratch, float* c_out, float* h_out,
                     void* stream) {
  const ServePlan pl = {slices, tiles, windows, smem};
#define SRT_REPLAY_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0, xs, extra_xp,  \
      seq_len, B, E, H, layer_norm, forget_bias, pl, scratch, c_out, h_out, \
      (cudaStream_t)stream
  if (w_bf16) return (int)launch_replay<bf16>(SRT_REPLAY_ARGS);
  return (int)launch_replay<float>(SRT_REPLAY_ARGS);
#undef SRT_REPLAY_ARGS
}

// The row-block design, the first port's entries (the same arguments
// without the plan and the scratch); kept for the A/B and the card tests.
int srt_decode_chunk_rowblock(const void* wx, const void* wh, const float* b,
                              const float* ln_gamma, const float* ln_beta,
                              const float* lnc_gamma, const float* lnc_beta,
                              const void* out_w, const float* out_b,
                              const float* c0, const float* h0,
                              const float* prev0, const float* extra_xp,
                              const float* u, const float* temps,
                              const int* t0, const int* done0,
                              const int* caps, const float* end_token, int B,
                              int K, int H, int M, int layer_norm, int greedy,
                              int w_bf16, float forget_bias, float* strokes,
                              float* c_out, float* h_out, int* t_out,
                              int* done_out, void* stream) {
#define SRT_DECODE_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, out_w, out_b, c0, h0,  \
      prev0, extra_xp, u, temps, t0, done0, caps, end_token, B, K, H, M,    \
      layer_norm, greedy, forget_bias, strokes, c_out, h_out, t_out,        \
      done_out, (cudaStream_t)stream
  if (w_bf16) return (int)launch_decode_rowblock<bf16>(SRT_DECODE_ARGS);
  return (int)launch_decode_rowblock<float>(SRT_DECODE_ARGS);
#undef SRT_DECODE_ARGS
}

int srt_replay_chunk_rowblock(const void* wx, const void* wh, const float* b,
                              const float* ln_gamma, const float* ln_beta,
                              const float* lnc_gamma, const float* lnc_beta,
                              const float* c0, const float* h0,
                              const float* xs, const float* extra_xp,
                              const int* seq_len, int B, int E, int H,
                              int layer_norm, int w_bf16, float forget_bias,
                              float* c_out, float* h_out, void* stream) {
#define SRT_REPLAY_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0, xs, extra_xp,  \
      seq_len, B, E, H, layer_norm, forget_bias, c_out, h_out,              \
      (cudaStream_t)stream
  if (w_bf16) return (int)launch_replay_rowblock<bf16>(SRT_REPLAY_ARGS);
  return (int)launch_replay_rowblock<float>(SRT_REPLAY_ARGS);
#undef SRT_REPLAY_ARGS
}

}  // extern "C"
