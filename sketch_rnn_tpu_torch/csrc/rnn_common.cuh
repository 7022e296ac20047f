// Device and host helpers shared by the training kernels of the PyTorch
// port (fused_rnn.cu, fused_hyper.cu): bf16 conversions and rounding, the
// in-kernel dropout mask of pallas_fused._prng_mask, block-wide sums, the
// two-pass layer-norm statistics, the LayerNorm-LSTM gate block forward and
// backward, the row-order sum of per-row partials, and the dispatch on
// weight and residual types. Everything sits in an
// unnamed namespace: each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {


using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kRedMax = 8;  // most values one block_sum reduces

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision (round to nearest even), held as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
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

// The layer-norm parameters of a LayerNorm-LSTM gate block.
struct LnParams {
  const float* ln_gamma;   // [4, H]
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
};

// The LayerNorm-LSTM gate block of column j (pallas_fused._ln_gates): a
// layer norm per gate, the forget bias after the norm, the dropout mask m
// on the candidate, a layer norm of the new cell state. Block-wide: every
// thread of the block must call it (own == false contributes nothing). It
// takes the four parameter pointers one by one: handed an LnParams, the
// LayerNorm-LSTM forward kernel was compiled to a slower schedule (23.8
// instead of 18.0 ms at B=100, T=250, H=512, float, on an H100).
__device__ __forceinline__ void ln_gates_fwd(const float (&pre)[4], float c,
                                             float m, bool own, int H, int j,
                                             const float* ln_gamma,
                                             const float* ln_beta,
                                             const float* lnc_gamma,
                                             const float* lnc_beta,
                                             float forget_bias, float* s_red,
                                             float& nc, float& nh) {
  float mean[4], rs[4];
  gate_stats(pre, own, H, s_red, mean, rs);
  float y[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    y[g] = own ? (pre[g] - mean[g]) * rs[g] * ln_gamma[g * H + j] +
                     ln_beta[g * H + j]
               : 0.0f;
  const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
  const float f = sigmoidf_(y[2] + forget_bias), o = sigmoidf_(y[3]);
  nc = c * f + i * (gu * m);
  float cmean, crs;
  row_stats(nc, own, H, s_red, cmean, crs);
  const float yc =
      own ? (nc - cmean) * crs * lnc_gamma[j] + lnc_beta[j] : 0.0f;
  nh = tanhf(yc) * o;
}

// The LN parameters' gradient sums one thread keeps over time.
struct LnGrads {
  float dgam[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dbet[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dgc = 0.0f, dbc = 0.0f;
};

// Backward through the gate block of column j (pallas_fused.
// _ln_lstm_bwd_gates): recomputes the block from (pre, c_prev, m), adds
// this step's LN-parameter terms to acc and returns the pre-activation
// gradient dp and the cell carry's gradient dc_next. dh_tot is the whole
// gradient of this step's h, dc the carried cell gradient. Block-wide.
__device__ __forceinline__ void ln_gates_bwd(const float (&pre)[4],
                                             float c_prev, float m,
                                             float dh_tot, float dc, bool own,
                                             int H, int j, const LnParams& ln,
                                             float forget_bias, float* s_red,
                                             LnGrads& acc, float (&dp)[4],
                                             float& dc_next) {
  float mean[4], rs[4], xhat[4], y[4];
  gate_stats(pre, own, H, s_red, mean, rs);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    xhat[g] = (pre[g] - mean[g]) * rs[g];
    y[g] = own ? xhat[g] * ln.ln_gamma[g * H + j] + ln.ln_beta[g * H + j]
               : 0.0f;
  }
  const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
  const float f = sigmoidf_(y[2] + forget_bias), o = sigmoidf_(y[3]);
  const float nc = c_prev * f + i * (gu * m);
  float cmean, crs;
  row_stats(nc, own, H, s_red, cmean, crs);
  const float xhat_c = (nc - cmean) * crs;
  const float gc = own ? ln.lnc_gamma[j] : 0.0f;
  const float yc = own ? xhat_c * gc + ln.lnc_beta[j] : 0.0f;
  const float tanh_yc = tanhf(yc);
  const float do_ = dh_tot * tanh_yc;
  const float dyc = dh_tot * o * (1.0f - tanh_yc * tanh_yc);
  acc.dgc += dyc * xhat_c;
  acc.dbc += dyc;
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
    acc.dgam[g] += dy[g] * xhat[g];
    acc.dbet[g] += dy[g];
    dxh[g] = own ? dy[g] * ln.ln_gamma[g * H + j] : 0.0f;
    q8[g] = dxh[g];
    q8[4 + g] = own ? dxh[g] * xhat[g] : 0.0f;
  }
  block_sum<8>(q8, s_red);
#pragma unroll
  for (int g = 0; g < 4; ++g)
    dp[g] = rs[g] * (dxh[g] - q8[g] / (float)H -
                     xhat[g] * (q8[4 + g] / (float)H));
  dc_next = dcv * f;
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

Dropout make_dropout(const float* masks, const int* seed, float keep,
                     float inv_keep) {
  Dropout d;
  d.masks = masks;
  d.seed = seed;
  d.keep = keep;
  d.inv_keep = inv_keep;
  return d;
}

// Call f(W{}, R{}) with the weight and residual types the flags name.
template <typename F>
cudaError_t with_types(int w_bf16, int r_bf16, F&& f) {
  if (w_bf16) return r_bf16 ? f(bf16{}, bf16{}) : f(bf16{}, 0.0f);
  return r_bf16 ? f(0.0f, bf16{}) : f(0.0f, 0.0f);
}

}  // namespace
