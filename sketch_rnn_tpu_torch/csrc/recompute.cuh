// The hoisted recomputes' tiled products of the PyTorch port's training
// backwards (fused_rnn.cu: the LSTM and LayerNorm-LSTM backwards' gate
// recompute, rows 3b-5b; fused_hyper.cu: the HyperLSTM backward's stage 1,
// row 6b). Each computes C[m, n] = op.out(z, m, n, sum over k < K of A[m,
// k] * Bw[k, n]) for M rows m (row-steps), N columns n and a batch index z
// (blockIdx.z), k in order from 0.0f. The operand Op gives A (op.val(z,
// m, k), already rounded to the weight type; where op.a16_ok() holds,
// op.a16, 16 bf16 values of a row ready to copy, or null), Bw (op.b(z), a
// row-major [K, N] matrix of stride op.ldb), the sizes (op.M, op.K, op.N)
// and the epilogue op.out.
//  - float weights (recompute_simt_kernel): a SIMT tiled product (no TF32:
//    it would round operands the float contract keeps). 128 x 128 outputs
//    per block, 256 threads of 8 x 8, k in chunks of 8 in order, the next
//    chunk loaded into registers while this one is multiplied.
//  - bf16 weights (recompute_mma_kernel): the tensor cores, mma.sync
//    m16n8k16 (bf16 operands, float sums: a product of two bf16 values is
//    exact in float, so only the order of the float sums differs from the
//    plain version). 128 x 128 outputs per block, 8 warps of 64 x 32, k in
//    chunks of 32, two buffers: the weight tile arrives by cp.async, the A
//    tile through registers (it is gathered and rounded on the way), the
//    next chunk's copies in flight while this one is multiplied. Rows
//    padded by 8 bf16 so ldmatrix is free of bank conflicts (mma.cuh).
// PreOp is the LSTM backwards' operand (h_{t-1} @ wh, the x part and the
// biases in the epilogue, as the two sums gate_pre adds). Everything sits
// in an unnamed namespace: each translation unit gets its own copy.

#pragma once

#include "lstm_loops.cuh"
#include "mma.cuh"
#include "rnn_common.cuh"

namespace {

// A stored residual's previous-step row as a product operand: h_{t-1} of
// row-step m = t * B + b, the stored value (the initial carry rounded to R
// at t = 0), rounded to W.
template <typename W, typename R>
__device__ __forceinline__ float prev_row(const float* first, const R* rs,
                                          int B, int H, int m, int k) {
  return rnd<W>(m < B ? rnd<R>(first[(size_t)m * H + k])
                      : to_f(rs[(size_t)(m - B) * H + k]));
}

// Whether a stored residual's rows can be copied as bf16, 16 bytes at a
// time (bf16 residuals whose rows are 16-byte aligned), checked once a
// kernel; then the row's 16 values from k on past the first step, or null.
template <typename R>
__device__ __forceinline__ bool prev_row16_ok(const R* rs, int H) {
  return sizeof(R) == 2 && H % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(rs) & 15) == 0;
}

template <typename R>
__device__ __forceinline__ const bf16* prev_row16(const R* rs, int B, int H,
                                                  int M, int m, int k) {
  if constexpr (sizeof(R) == 2) {
    if (m >= B && m < M && k + 16 <= H) return rs + (size_t)(m - B) * H + k;
  }
  return nullptr;
}

// The LSTM backwards' recompute: pre = ((x_m @ wx [+ b]) + h_{t-1} @ wh)
// [+ xb[b]] into the d_pre scratch.
template <typename W, typename R>
struct PreOp {
  Bwd<W, R> a;
  __device__ int M() const { return a.T * a.B; }
  __device__ int K() const { return a.p.H; }
  __device__ int N() const { return 4 * a.p.H; }
  __device__ int ldb() const { return 4 * a.p.H; }
  __device__ const W* b(int) const { return a.p.wh; }
  __device__ float val(int, int m, int k) const {
    return prev_row<W, R>(a.h0, a.hs, a.B, a.p.H, m, k);
  }
  __device__ bool a16_ok() const { return prev_row16_ok(a.hs, a.p.H); }
  __device__ const bf16* a16(int, int m, int k) const {
    return prev_row16(a.hs, a.B, a.p.H, M(), m, k);
  }
  // the two sums of gate_pre, ((x_m @ wx[:, n] + b[n]) + hp) [+ xb[b, n]]
  __device__ void out(int, int m, int n, float hp) const {
    const Cell<W>& p = a.p;
    const int G = 4 * p.H;
    const float* x = a.xs + (size_t)m * p.D;
    float xp = 0.0f;
    for (int q = 0; q < p.D; ++q)
      xp = fmaf(rnd<W>(x[q]), to_f(p.wx[(size_t)q * G + n]), xp);
    if (p.b != nullptr) xp = xp + p.b[n];
    float v = xp + hp;
    if (p.xb != nullptr) v = v + p.xb[(size_t)(m % a.B) * G + n];
    a.dpre[(size_t)m * G + n] = v;
  }
};

constexpr int kRcM = 128, kRcN = 128, kRcK = 8, kRcThreads = 256;

template <typename W, typename Op>
__global__ void __launch_bounds__(kRcThreads) recompute_simt_kernel(Op op) {
  __shared__ __align__(16) float sA[2][kRcK][kRcM];
  __shared__ __align__(16) float sB[2][kRcK][kRcN];
  const int H = op.K(), G = op.N(), M = op.M(), z = blockIdx.z;
  const W* bw = op.b(z);
  const int ldb = op.ldb();
  const int m0 = blockIdx.y * kRcM, n0 = blockIdx.x * kRcN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int am = tid >> 1, ak = (tid & 1) * 4;   // A: 4 k of one row
  const int bk = tid >> 5, bn = (tid & 31) * 4;  // B: 4 n of one k
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + am, k = k0 + ak + i;
      ra[i] = (m < M && k < H) ? op.val(z, m, k) : 0.0f;
      const int kb = k0 + bk, n = n0 + bn + i;
      rb[i] = (kb < H && n < G) ? to_f(bw[(size_t)kb * ldb + n]) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sA[buf][ak + i][am] = ra[i];
      sB[buf][bk][bn + i] = rb[i];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < H; k0 += kRcK) {
    const bool more = k0 + kRcK < H;
    if (more) load(k0 + kRcK);
#pragma unroll
    for (int kk = 0; kk < kRcK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sA[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sB[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < G) op.out(z, m, n, acc[i][j]);
    }
  }
}

constexpr int kMmM = 128, kMmN = 128, kMmK = 32, kMmThreads = 256;
constexpr int kAPad = kMmK + 8, kBPad = kMmN + 8;

template <typename Op>
__global__ void __launch_bounds__(kMmThreads) recompute_mma_kernel(Op op) {
  __shared__ __align__(16) bf16 sA[2][kMmM][kAPad];
  __shared__ __align__(16) bf16 sB[2][kMmK][kBPad];
  const int H = op.K(), G = op.N(), M = op.M(), z = blockIdx.z;
  const bf16* bw = op.b(z);
  const int ldb = op.ldb();
  const int m0 = blockIdx.y * kMmM, n0 = blockIdx.x * kMmN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int am = tid >> 1, ak = (tid & 1) * 16;  // A: 16 k of one row
  // 16-byte copies of whole chunks need 16-byte aligned rows
  const bool vec_b =
      ldb % 8 == 0 && (reinterpret_cast<uintptr_t>(bw) & 15) == 0;
  const bool vec_a = op.a16_ok();
  uint4 ra[2];
  auto load_a = [&](int k0) {
    const int m = m0 + am, k = k0 + ak;
    const bf16* src = vec_a ? op.a16(z, m, k) : nullptr;
    if (src != nullptr) {
      // bf16 residuals are bf16 already: copied as they are
      ra[0] = reinterpret_cast<const uint4*>(src)[0];
      ra[1] = reinterpret_cast<const uint4*>(src)[1];
      return;
    }
    bf16* r = reinterpret_cast<bf16*>(ra);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = __float2bfloat16_rn((m < M && k + i < H) ? op.val(z, m, k + i)
                                                      : 0.0f);
  };
  auto store_a = [&](int buf) {
    uint4* dst = reinterpret_cast<uint4*>(&sA[buf][am][ak]);
    dst[0] = ra[0];
    dst[1] = ra[1];
  };
  auto load_b = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmThreads;
      const int kk = c >> 4, nn = (c & 15) * 8;
      const int k = k0 + kk, n = n0 + nn;
      bf16* dst = &sB[buf][kk][nn];
      if (vec_b && k < H && n + 8 <= G) {
        cp_async16(dst, bw + (size_t)k * ldb + n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (k < H && n + e < G) ? bw[(size_t)k * ldb + n + e]
                                        : __float2bfloat16_rn(0.0f);
      }
    }
    cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load_a(0);
  load_b(0, 0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < H; k0 += kMmK) {
    const bool more = k0 + kMmK < H;
    if (more) {
      load_a(k0 + kMmK);
      load_b(k0 + kMmK, buf ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < kMmK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i],
                    &sA[buf][wm + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (more) {
      store_a(buf ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
    buf ^= 1;
  }
  // accumulator (i, j): rows wm + 16 i + lane / 4 (+ 8), columns
  // wn + 8 j + 2 (lane % 4) (+ 1)
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm + i * 16 + gr + hh * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + gc + e;
          if (n < G) op.out(z, m, n, acc[i][j][hh * 2 + e]);
        }
    }
}

// The product of op over `batch` indices z: the tensor cores when W is
// bf16, else SIMT. M, N (host values) size the grid.
template <typename W, typename Op>
cudaError_t launch_product_grid(const Op& op, int M, int N, int batch,
                                cudaStream_t stream) {
  if (M == 0 || batch == 0) return cudaSuccess;
  if constexpr (sizeof(W) == 2) {
    const dim3 grid((N + kMmN - 1) / kMmN, (M + kMmM - 1) / kMmM, batch);
    recompute_mma_kernel<Op><<<grid, kMmThreads, 0, stream>>>(op);
  } else {
    const dim3 grid((N + kRcN - 1) / kRcN, (M + kRcM - 1) / kRcM, batch);
    recompute_simt_kernel<W, Op><<<grid, kRcThreads, 0, stream>>>(op);
  }
  return cudaGetLastError();
}

template <typename W, typename R>
cudaError_t launch_product(const PreOp<W, R>& op, int batch,
                           cudaStream_t stream) {
  return launch_product_grid<W>(op, op.a.T * op.a.B, 4 * op.a.p.H, batch,
                                stream);
}

}  // namespace
