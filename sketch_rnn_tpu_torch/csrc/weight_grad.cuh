// The fixed-order weight-gradient reduction shared by the training kernels
// of the PyTorch port (fused_rnn.cu, lstm_seq.cu): one tiled product over
// K = T*B row-steps, its left operand gathered in place from the inputs and
// the hidden-state stream, no atomics, so every result is the same bit for
// bit on every run. Sits in an unnamed namespace: each translation unit
// gets its own copy.

#pragma once

#include "rnn_common.cuh"

namespace {

// [dwx; dwh; db] (R = D + H + ones rows, N = 4H columns)
//   = sum over k = t*B + b of A[k, r] * dpre[k, n],
// A[k] = [xs[t, b]; h_{t-1}[b] (h0 rounded to RT at t = 0); 1], the x and
// h entries rounded to W; dpre rounded to W for the dwx/dwh rows and taken
// unrounded by the row of ones (db). One 64 x 64 output tile per block,
// 256 threads of 4 x 4 (strided) outputs, K in chunks of 16 in a fixed
// order: deterministic.
constexpr int kTM = 64, kTN = 64, kTK = 16, kGemmThreads = 256;

template <typename W, typename RT>
__global__ void __launch_bounds__(kGemmThreads)
weight_grad_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
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

}  // namespace
