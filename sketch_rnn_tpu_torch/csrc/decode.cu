// Serving kernels of the PyTorch port, hand-written CUDA C++ for Hopper
// (sm_90a). Built by ops/_build.py with nvcc into a shared library with a
// plain C interface (no PyTorch headers) and bound with ctypes by
// ops/cuda_decode.py, whose plain PyTorch versions they are held against.
//
// decode_chunk_kernel replaces the TPU kernel
//   sketch_rnn_tpu/ops/pallas_decode.py::decode_chunk (pallas_call at :327)
// replay_chunk_kernel replaces
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
// per-request fold_in(key, t) discipline.
//
// Design. A slot's recurrence never reads another slot, so the grid is
// one block per slot row (grid = B) and the K (or E) steps are a loop
// inside the block. c, h, the previous stroke, t and done live in shared
// memory for the whole chunk; only the weights, the uniforms in and the
// strokes out touch device memory. Each thread owns hidden index j (and
// j + blockDim, ...): it computes that column of all four gates,
//   pre = ((x @ wx + extra_xp) + b) + h @ wh        (the order of
// pallas_decode._cell_step), reading row k of wh coalesced across the
// block. Block reductions give the per-gate layer-norm statistics
// (two-pass: mean, then the biased variance), then the cell update, the
// cell layer norm and the new h. The 6M+3 projection splits H into four
// quarters over the block's threads. One thread then runs the mixture
// head and the sampler sequentially, so the softmax sums and the CDF
// cumsum are taken in index order, exactly as written in the plain
// version.
//
// Bound on the H100 at the slice's shapes (B=64, K=8, H=512, M=20,
// f32): the chunk does 2*B*K*(H*4H + 5*4H + H*(6M+3)) ~= 1.14 GFLOP of
// f32 multiply-add that is not tensor-core work (67 TFLOP/s: ~17 us),
// and must move its weights once (wh 4 MiB + out_w 0.25 MiB + the rest,
// ~4.5 MB: ~1.3 us at 3.35 TB/s) — compute-bound. This first kernel does
// not reach that bound: every row block re-reads wh from L2 on every
// step (B*K*4 MiB per chunk), only B=64 of the 132 SMs have work, and
// the per-step sampler runs on one thread. Sharing weight tiles across
// rows, tensor cores and TMA are later work; PERF.md keeps its time
// beside the bound.
//
// Numerics: f32 throughout, no fast-math intrinsics (the sampler's
// log(max(u, 1e-12)) and cos(2 pi u) feed the strokes directly), rsqrtf
// for the layer norm as ops/linear.py uses rsqrt. At compute_dtype
// bfloat16 the three weight matrices (wx, wh, out_w) arrive as bf16 (W)
// and every product rounds its activation operand (the stroke, h, the new
// h) to bf16 and accumulates in float -- ops/linear.py::matmul's contract,
// as pallas_decode._cell_step and its out_w product apply it -- so each
// product is exact and only the order of the float sums differs from the
// plain version. The carry, the layer norms and the sampler stay float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQuarters = 4;  // H split of the MDN projection
constexpr float kTwoPi = 6.28318530717958647692f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v rounded to W's precision (round to nearest even), held as a float
template <typename W>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Sum N values per thread across the block; every thread gets the sums.
// s_red must hold kWarps * N + N floats.
template <int N>
__device__ void block_sum(float (&v)[N], float* s_red) {
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
    block_sum<4>(mean, s_red);
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
    block_sum<4>(var, s_red);
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
    block_sum<1>(csum, s_red);
    const float cmean = csum[0] / (float)H;
    float cvar[1] = {0.0f};
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float d = s_cn[j] - cmean;
      cvar[0] += d * d;
    }
    block_sum<1>(cvar, s_red);
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

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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
cudaError_t launch_replay(const void* wx, const void* wh, const float* b,
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

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers of contiguous tensors (float32 unless
// named int32; wx, wh and out_w are bfloat16 when w_bf16); b is null for
// layer_norm, the ln_* are null for lstm, extra_xp is null for an
// unconditional, classless model. Returns the launch's cudaGetLastError().
int srt_decode_chunk(const void* wx, const void* wh, const float* b,
                     const float* ln_gamma, const float* ln_beta,
                     const float* lnc_gamma, const float* lnc_beta,
                     const void* out_w, const float* out_b, const float* c0,
                     const float* h0, const float* prev0,
                     const float* extra_xp, const float* u,
                     const float* temps, const int* t0, const int* done0,
                     const int* caps, const float* end_token, int B, int K,
                     int H, int M, int layer_norm, int greedy, int w_bf16,
                     float forget_bias, float* strokes, float* c_out,
                     float* h_out, int* t_out, int* done_out, void* stream) {
#define SRT_DECODE_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, out_w, out_b, c0, h0,  \
      prev0, extra_xp, u, temps, t0, done0, caps, end_token, B, K, H, M,    \
      layer_norm, greedy, forget_bias, strokes, c_out, h_out, t_out,        \
      done_out, (cudaStream_t)stream
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
                     float* c_out, float* h_out, void* stream) {
#define SRT_REPLAY_ARGS                                                     \
  wx, wh, b, ln_gamma, ln_beta, lnc_gamma, lnc_beta, c0, h0, xs, extra_xp,  \
      seq_len, B, E, H, layer_norm, forget_bias, c_out, h_out,              \
      (cudaStream_t)stream
  if (w_bf16) return (int)launch_replay<bf16>(SRT_REPLAY_ARGS);
  return (int)launch_replay<float>(SRT_REPLAY_ARGS);
#undef SRT_REPLAY_ARGS
}

}  // extern "C"
