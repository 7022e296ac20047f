// The cuDNN-layout LSTM with a reserve space, hand-written CUDA C++ for
// Hopper (sm_90a). Built by ops/_build.py with nvcc into a shared library
// with a plain C interface (no PyTorch headers) and bound with ctypes by
// ops/cuda_lstm.py, whose plain PyTorch versions it is held against.
//
// Which TPU kernels it replaces (sketch_rnn_tpu/ops/pallas_lstm.py):
//   srt_lstm_seq_fwd <- lstm_seq forward, _fwd_kernel (pallas_call at :195)
//   srt_lstm_seq_bwd <- lstm_seq backward, _bwd_kernel (pallas_call at :242)
//
// What they compute, float32 only (as the TPU kernel does). The inputs are
// projected outside, for all steps at once: xp [T, B, 4H] = x @ wx + b. The
// forward runs T steps of pre = xp_t + h_{t-1} @ wh, gates (i, g, f, o)
// with the forget bias added to f, an optional dropout mask [T, B, H] on
// the candidate, and writes hs, the final carry and cuDNN's "reserve
// space": the post-activation gates [T, B, 4H] (i, UNMASKED g, f, o) and
// the pre-step cell states cs [T, B, H]. The backward walks t = T-1..0 from
// that reserve and recomputes no product: new_c, tanh(new_c) and the
// pre-activation gradient d_pre from the stored gates (tanh' on the
// unmasked g, the mask on dg), dh_{t-1} = d_pre @ wh^T, dc_{t-1} = dc * f.
// d_pre is the input gradient dxp itself. The masks get no gradient.
//
// Design. The recurrence of a batch row reads no other row, so the forward
// and the backward recurrence are one block per row (grid = B) with the T
// loop inside, one thread per hidden unit j (blockDim = H rounded up to a
// warp, H <= 512), the carries in registers and h_{t-1} (forward) or
// d_pre (backward) in shared memory. Forward: thread j accumulates column j
// of the four gates over k, reading row k of wh coalesced across the
// block. Backward: each warp owns whole rows k of wh, reads them coalesced
// and reduces dh_{t-1}[k] by shuffles. dwh = sum over (t, b) of
// h_{t-1}^T d_pre crosses rows; blocks run in no order, so it is not
// summed with atomics (whose order, and so rounding, would change from run
// to run) but by the fixed-order split-K weight pass of weight_grad.cuh
// (K = T*B), gathering h_{t-1} from hs and h0 in place: the same bits on
// every run.
//
// Bound on the H100 at the path's shape, the `vae` decoder: B=100, T=250,
// H=512. The products are float32 SIMT multiply-adds (67 TFLOP/s). Forward
// 2*T*B*H*4H = 52.4 GFLOP: 0.78 ms; its bytes (xp and the gate reserve
// 204.8 MB each, hs, cs, masks 51.2 MB each) ~0.56 GB, 0.17 ms. Backward
// 104.9 GFLOP (the transposed product and dwh): 1.57 ms; ~0.61 GB, 0.18
// ms. Bound by operations. This first design does not approach that: only
// 100 of the 132 SMs hold a row, each block reads wh (4 MiB) from L2 on
// every step, and the step-to-step dependency leaves that latency exposed.
// The reserve writes 205 MB the recompute-backward kernels of fused_rnn.cu
// do not, and saves the backward its gate product. Sharing wh tiles across
// rows and tensor cores are later work; PERF.md keeps the measured times.

#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

struct SeqFwd {
  const float* xp;     // [T, B, 4H]
  const float* wh;     // [H, 4H]
  const float* c0;     // [B, H]
  const float* h0;     // [B, H]
  const float* masks;  // [T, B, H] or null
  float* hs;           // [T, B, H]
  float* cT;           // [B, H]
  float* hT;           // [B, H]
  float* gates;        // [T, B, 4H] post-activation (i, g unmasked, f, o)
  float* cs;           // [T, B, H] c_{t-1}
  int T, B, H;
  float forget_bias;
};

__global__ void __launch_bounds__(kMaxThreads) lstm_seq_fwd_kernel(SeqFwd a) {
  extern __shared__ float s_h[];  // H: h_{t-1}
  const int H = a.H, G = 4 * H, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  float c = 0.0f, h = 0.0f;
  if (own) {
    c = a.c0[(size_t)row * H + j];
    h = a.h0[(size_t)row * H + j];
    s_h[j] = h;
  }
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();  // s_h holds h_{t-1}
    if (own) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* w = a.wh + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k, w += G) {
        const float hk = s_h[k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = fmaf(hk, w[g * H], acc[g]);
      }
      const size_t rt = (size_t)t * B + row;
      const float* xp = a.xp + rt * G + j;
      const float i = sigmoidf_(xp[0] + acc[0]);
      const float gu = tanhf(xp[H] + acc[1]);
      const float f = sigmoidf_(xp[2 * H] + acc[2] + a.forget_bias);
      const float o = sigmoidf_(xp[3 * H] + acc[3]);
      const float m = a.masks != nullptr ? a.masks[rt * H + j] : 1.0f;
      const float nc = c * f + i * (gu * m);
      const float nh = tanhf(nc) * o;
      float* gt = a.gates + rt * G + j;
      gt[0] = i;
      gt[H] = gu;
      gt[2 * H] = f;
      gt[3 * H] = o;
      a.cs[rt * H + j] = c;
      a.hs[rt * H + j] = nh;
      c = nc;
      h = nh;
    }
    __syncthreads();  // every read of s_h of this step is done
    if (own) s_h[j] = h;
  }
  if (own) {
    a.cT[(size_t)row * H + j] = c;
    a.hT[(size_t)row * H + j] = h;
  }
}

struct SeqBwd {
  const float* wh;     // [H, 4H]
  const float* gates;  // [T, B, 4H]
  const float* cs;     // [T, B, H]
  const float* masks;  // [T, B, H] or null
  const float* dhs;    // [T, B, H]
  const float* dcT;    // [B, H]
  const float* dhT;    // [B, H]
  float* dxp;          // [T, B, 4H] = every step's d_pre
  float* dc0;          // [B, H]
  float* dh0;          // [B, H]
  int T, B, H;
};

__global__ void __launch_bounds__(kMaxThreads) lstm_seq_bwd_kernel(SeqBwd a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 4 * H, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* s_dp = smem;       // 4H: d_pre of this step
  float* s_dhn = s_dp + G;  // H: dh_{t-1}
  float dh = 0.0f, dc = 0.0f;
  if (own) {
    dh = a.dhT[(size_t)row * H + j];
    dc = a.dcT[(size_t)row * H + j];
  }
  for (int s = a.T - 1; s >= 0; --s) {
    float f = 0.0f;
    if (own) {
      const size_t rs = (size_t)s * B + row;
      const float* gt = a.gates + rs * G + j;
      const float i = gt[0], gu = gt[H];
      f = gt[2 * H];
      const float o = gt[3 * H];
      const float m = a.masks != nullptr ? a.masks[rs * H + j] : 1.0f;
      const float c_prev = a.cs[rs * H + j];
      const float g = gu * m;
      const float nc = c_prev * f + i * g;
      const float tanh_c = tanhf(nc);
      const float dh_tot = dh + a.dhs[rs * H + j];
      const float dcv = dc + dh_tot * o * (1.0f - tanh_c * tanh_c);
      const float do_ = dh_tot * tanh_c;
      const float df = dcv * c_prev;
      const float di = dcv * g;
      const float dgu = dcv * i * m;
      const float dp[4] = {di * i * (1.0f - i), dgu * (1.0f - gu * gu),
                           df * f * (1.0f - f), do_ * o * (1.0f - o)};
      float* out = a.dxp + rs * G + j;
#pragma unroll
      for (int g4 = 0; g4 < 4; ++g4) {
        out[g4 * H] = dp[g4];
        s_dp[g4 * H + j] = dp[g4];
      }
      dc = dcv * f;
    }
    __syncthreads();  // s_dp complete
    // dh_{t-1}[k] = sum_n d_pre[n] wh[k, n]: warp-owned rows of wh
    for (int k = warp; k < H; k += nw) {
      const float* wr = a.wh + (size_t)k * G;
      float acc = 0.0f;
      for (int n = lane; n < G; n += 32) acc = fmaf(s_dp[n], wr[n], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_dhn[k] = acc;
    }
    __syncthreads();  // s_dhn complete; s_dp free again
    if (own) dh = s_dhn[j];
  }
  if (own) {
    a.dc0[(size_t)row * H + j] = dc;
    a.dh0[(size_t)row * H + j] = dh;
  }
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous float32 tensors; masks may be
// null. Each returns the cudaError_t of its launches (0 when all were
// accepted).

int srt_lstm_seq_fwd(const float* xp, const float* wh, const float* c0,
                     const float* h0, const float* masks, int T, int B,
                     int H, float forget_bias, float* hs, float* cT,
                     float* hT, float* gates, float* cs, void* stream) {
  if (H < 1 || H > kMaxThreads) return (int)cudaErrorInvalidValue;
  SeqFwd a;
  a.xp = xp;
  a.wh = wh;
  a.c0 = c0;
  a.h0 = h0;
  a.masks = masks;
  a.hs = hs;
  a.cT = cT;
  a.hT = hT;
  a.gates = gates;
  a.cs = cs;
  a.T = T;
  a.B = B;
  a.H = H;
  a.forget_bias = forget_bias;
  const size_t smem = (size_t)H * sizeof(float);
  lstm_seq_fwd_kernel<<<B, threads_for(H), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// hs/h0 give h_{t-1} (h0 at t = 0) to the dwh reduction; wg_slices,
// wg_kslice and wg_part are its split-K plan (cuda_fused.weight_grad_plan)
// and float partials scratch, [wg_slices, H, 4H].
int srt_lstm_seq_bwd(const float* wh, const float* gates, const float* cs,
                     const float* hs, const float* h0, const float* masks,
                     const float* dhs, const float* dcT, const float* dhT,
                     int T, int B, int H, float* dxp, float* dwh, float* dc0,
                     float* dh0, int wg_slices, int wg_kslice,
                     float* wg_part, void* stream) {
  if (H < 1 || H > kMaxThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  SeqBwd a;
  a.wh = wh;
  a.gates = gates;
  a.cs = cs;
  a.masks = masks;
  a.dhs = dhs;
  a.dcT = dcT;
  a.dhT = dhT;
  a.dxp = dxp;
  a.dc0 = dc0;
  a.dh0 = dh0;
  a.T = T;
  a.B = B;
  a.H = H;
  const size_t smem = (size_t)5 * H * sizeof(float);
  cudaError_t err = set_smem((const void*)lstm_seq_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_seq_bwd_kernel<<<B, threads_for(H), smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dwh: no x rows, no row of ones
  const WgArgs<float> w = {nullptr, h0, hs, dxp, T, B, 0, H, 0,
                           {wg_slices, wg_kslice, wg_part}, nullptr, dwh,
                           nullptr};
  return (int)launch_weight_grad_pass<float>(w, st);
}

}  // extern "C"
