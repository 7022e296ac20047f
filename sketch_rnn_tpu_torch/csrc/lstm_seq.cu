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
// Design. Both directions run on the persistent weight-resident loops of
// lstm_loops.cuh, which fused_rnn.cu's LSTM (rows 3 and 4 of PERF.md's
// table) runs too; fused_rnn.cu's header has their design. The first
// design here, kept as srt_lstm_seq_fwd_rowblock and
// srt_lstm_seq_bwd_rowblock to be held and timed beside the loops, was
// one block per batch row (one thread per unit): at the path's B=100, 32
// of the 132 SMs held no row, and every block read all of wh (4 MiB at
// float) from L2 on every step both ways, ~105 GB a call, with its latency
// exposed by the step-to-step dependency; in the backward every warp
// reduced whole rows of wh for every batch row. The loops keep wh resident
// in shared memory, spread over the grid: block (batch tile, slice of 16
// units) holds the columns (forward) or rows (backward) of wh of its
// units, so a step reads from L2 only the h (forward) or d_pre (backward)
// rows of its tile, and the blocks exchange h through an hx [2, B, H]
// scratch with one grid barrier per step.
//  - Forward (srt_lstm_seq_fwd): the loop with the XStreamed x part. The
//    xp[t] values of the chunk's rows are read while its h rows arrive by
//    cp.async; the gate block is lstm_seq's (the forget bias on f, the mask
//    on the candidate only) and stores the post-activation gates, cs and
//    hs, and the final carry after the last step. Every pre-activation is
//    xp + acc, acc one fmaf chain over k = 0..H-1 in order from 0.0f, as
//    the row-block kernel sums it, and both take the gate block with every
//    sum and product rounded on its own (seq_gates): the two entries agree
//    bit for bit.
//  - Backward (srt_lstm_seq_bwd): two launches. The loop with the
//    GatesReserve source: per step, the gate block of each owned (row,
//    unit) from the stored gates, cs, the mask and dhs writes d_pre into
//    dxp and updates dc; one grid barrier; then dh_{s-1} = d_pre[s] @ wh^T
//    for the block's rows and units (dxp read through L2), the parts summed
//    in a fixed order. Nothing is recomputed: the reserve holds the gates.
//    Then dwh = sum over (t, b) of h_{t-1}^T d_pre by the fixed-order
//    split-K weight pass of weight_grad.cuh (K = T*B), gathering h_{t-1}
//    from hs and h0 in place. The dh sums take another order than the
//    row-block kernel's, so the two agree within tolerance; there are no
//    atomics, so every run gives the same bits.
// A batch whose tiles do not fit in shared memory runs as windows of rows
// (persist.cuh); a grid that cannot co-reside is refused
// (cudaErrorCooperativeLaunchTooLarge), never sent to the row-block design.
//
// Bound on the H100 at the path's shape, the `vae` decoder: B=100, T=250,
// H=512. The products are float32 SIMT multiply-adds (67 TFLOP/s). Forward
// 2*T*B*H*4H = 52.4 GFLOP: 0.78 ms; its bytes (xp and the gate reserve
// 204.8 MB each, hs, cs, masks 51.2 MB each) ~0.56 GB, 0.17 ms. Backward
// 104.9 GFLOP (the transposed product and dwh): 1.57 ms; ~0.61 GB, 0.18
// ms. Bound by operations. What holds the loops above that bound: the T
// steps are serial, each a grid barrier plus a (B / tiles) x 16 x 4H
// product per block whose operands come from shared memory, so latency
// and shared-memory bandwidth bound a step, not the FLOP count. The tensor
// cores would take TF32 operands, which round what the f32 contract keeps.
// PERF.md keeps the measured times beside these bounds.

#include "lstm_loops.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

// The row-block design (srt_lstm_seq_fwd_rowblock,
// srt_lstm_seq_bwd_rowblock): one block per batch row with the T loop
// inside, one thread per hidden unit j, the carries in registers and
// h_{t-1} (forward) or d_pre (backward) in shared memory. Forward: thread
// j accumulates column j of the four gates over k, reading row k of wh
// coalesced across the block. Backward: each warp owns whole rows k of wh
// and reduces dh_{t-1}[k] by shuffles.
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
      // seq_gates's operations (lstm_loops.cuh), each rounded on its own,
      // written out: called as a function here, it left the k loop above
      // a quarter of its loads in flight (26.8 ms a call at the path's
      // shape on an H100, against 15.6 written out)
      const size_t rt = (size_t)t * B + row;
      const float* xp = a.xp + rt * G + j;
      const float i = sigmoid_rn(__fadd_rn(xp[0], acc[0]));
      const float gu = tanhf(__fadd_rn(xp[H], acc[1]));
      const float f =
          sigmoid_rn(__fadd_rn(__fadd_rn(xp[2 * H], acc[2]), a.forget_bias));
      const float o = sigmoid_rn(__fadd_rn(xp[3 * H], acc[3]));
      const float m = a.masks != nullptr ? a.masks[rt * H + j] : 1.0f;
      const float nc =
          __fadd_rn(__fmul_rn(c, f), __fmul_rn(i, __fmul_rn(gu, m)));
      const float nh = __fmul_rn(tanhf(nc), o);
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

// The forward: the shared loop with the streamed x part (rowblock false),
// or the row-block design (which needs no hx).
cudaError_t seq_fwd_any(bool rowblock, const float* xp, const float* wh,
                        const float* c0, const float* h0, const float* masks,
                        int T, int B, int H, float forget_bias, float* hs,
                        float* cT, float* hT, float* gates, float* cs,
                        float* hx, cudaStream_t st) {
  if (H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  if (rowblock) {
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
    lstm_seq_fwd_kernel<<<B, threads_for(H), smem, st>>>(a);
    return cudaGetLastError();
  }
  Fwd<float, float> a;
  a.p = make_cell<float>(nullptr, wh, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, 0, H, forget_bias);
  a.xs = nullptr;
  a.c0 = c0;
  a.h0 = h0;
  a.drop = make_dropout(masks, nullptr, 1.0f, 1.0f);
  a.hs = hs;
  a.cs = cs;
  a.cT = cT;
  a.hT = hT;
  a.T = T;
  a.B = B;
  return launch_lstm_fwd_loop(a, XStreamed{xp, gates}, hx, st);
}

// The backward: stage 0 the loop then the weight pass, 1 the loop alone, 2
// the weight pass alone, -1 the row-block design then the weight pass.
cudaError_t seq_bwd_any(int stage, const float* wh, const float* gates,
                        const float* cs, const float* hs, const float* h0,
                        const float* masks, const float* dhs,
                        const float* dcT, const float* dhT, int T, int B,
                        int H, float* dxp, float* dwh, float* dc0, float* dh0,
                        int wg_slices, int wg_kslice, float* wg_part,
                        cudaStream_t st) {
  if (H < 1 || H > kMaxThreads || stage < -1 || stage > 2)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (stage < 0) {
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
    err = set_smem((const void*)lstm_seq_bwd_kernel, smem);
    if (err != cudaSuccess) return err;
    lstm_seq_bwd_kernel<<<B, threads_for(H), smem, st>>>(a);
    err = cudaGetLastError();
  } else if (stage != 2) {
    Bwd<float, float> a;
    a.p = make_cell<float>(nullptr, wh, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, 0, H, 0.0f);
    a.xs = nullptr;
    a.h0 = h0;
    a.hs = hs;
    a.cs = cs;
    a.dhs = dhs;
    a.dcT = dcT;
    a.dhT = dhT;
    a.drop = make_dropout(masks, nullptr, 1.0f, 1.0f);
    a.dpre = dxp;
    a.dxs = nullptr;
    a.dxb = nullptr;
    a.dc0 = dc0;
    a.dh0 = dh0;
    a.part = nullptr;
    a.wg = {wg_slices, wg_kslice, wg_part};
    a.T = T;
    a.B = B;
    LoopPlan plan;
    err = loop_plan<GatesReserve>(a, plan);
    if (err == cudaSuccess)
      err = launch_loop(a, GatesReserve{gates}, plan, st);
  }
  if (err != cudaSuccess || stage == 1) return err;
  // dwh: no x rows, no row of ones
  const WgArgs<float> w =
      wg_lstm_args(static_cast<const float*>(nullptr), h0, hs, dxp, T, B, 0,
                   H, 0, WgPlan{wg_slices, wg_kslice, wg_part}, nullptr, dwh,
                   nullptr);
  return launch_weight_grad_pass<float>(w, st);
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous float32 tensors; masks may be
// null. Each returns the cudaError_t of its launches (0 when all were
// accepted).

// hx: a [2, B, H] float scratch, the h exchange between the loop's blocks.
// The cooperative loop, over windows of rows where the batch's tiles do
// not fit at once; a grid that cannot co-reside is
// cudaErrorCooperativeLaunchTooLarge, before any launch.
int srt_lstm_seq_fwd(const float* xp, const float* wh, const float* c0,
                     const float* h0, const float* masks, int T, int B,
                     int H, float forget_bias, float* hs, float* cT,
                     float* hT, float* gates, float* cs, float* hx,
                     void* stream) {
  return (int)seq_fwd_any(false, xp, wh, c0, h0, masks, T, B, H, forget_bias,
                          hs, cT, hT, gates, cs, hx, (cudaStream_t)stream);
}

// The row-block design srt_lstm_seq_fwd replaced (lstm_seq_fwd_kernel),
// kept to be held and timed beside it; hx is not used.
int srt_lstm_seq_fwd_rowblock(const float* xp, const float* wh,
                              const float* c0, const float* h0,
                              const float* masks, int T, int B, int H,
                              float forget_bias, float* hs, float* cT,
                              float* hT, float* gates, float* cs, float* hx,
                              void* stream) {
  return (int)seq_fwd_any(true, xp, wh, c0, h0, masks, T, B, H, forget_bias,
                          hs, cT, hT, gates, cs, hx, (cudaStream_t)stream);
}

// hs/h0 give h_{t-1} (h0 at t = 0) to the dwh reduction; wg_slices,
// wg_kslice and wg_part are its split-K plan (cuda_fused.weight_grad_plan)
// and float partials scratch, [wg_slices, H, 4H]. The cooperative loop
// over the reserve (over windows of rows where the batch's tiles do not
// fit at once), then the weight pass; a grid that cannot co-reside is
// cudaErrorCooperativeLaunchTooLarge, before any launch.
int srt_lstm_seq_bwd(const float* wh, const float* gates, const float* cs,
                     const float* hs, const float* h0, const float* masks,
                     const float* dhs, const float* dcT, const float* dhT,
                     int T, int B, int H, float* dxp, float* dwh, float* dc0,
                     float* dh0, int wg_slices, int wg_kslice,
                     float* wg_part, void* stream) {
  return (int)seq_bwd_any(0, wh, gates, cs, hs, h0, masks, dhs, dcT, dhT, T,
                          B, H, dxp, dwh, dc0, dh0, wg_slices, wg_kslice,
                          wg_part, (cudaStream_t)stream);
}

// One of srt_lstm_seq_bwd's two launches (stage 1: the loop, 2: the weight
// pass), on the same arguments, to time them apart.
int srt_lstm_seq_bwd_stage(int stage, const float* wh, const float* gates,
                           const float* cs, const float* hs, const float* h0,
                           const float* masks, const float* dhs,
                           const float* dcT, const float* dhT, int T, int B,
                           int H, float* dxp, float* dwh, float* dc0,
                           float* dh0, int wg_slices, int wg_kslice,
                           float* wg_part, void* stream) {
  if (stage < 1 || stage > 2) return (int)cudaErrorInvalidValue;
  return (int)seq_bwd_any(stage, wh, gates, cs, hs, h0, masks, dhs, dcT, dhT,
                          T, B, H, dxp, dwh, dc0, dh0, wg_slices, wg_kslice,
                          wg_part, (cudaStream_t)stream);
}

// The row-block design srt_lstm_seq_bwd replaced (lstm_seq_bwd_kernel, then
// the same weight pass), kept to be held and timed beside it.
int srt_lstm_seq_bwd_rowblock(const float* wh, const float* gates,
                              const float* cs, const float* hs,
                              const float* h0, const float* masks,
                              const float* dhs, const float* dcT,
                              const float* dhT, int T, int B, int H,
                              float* dxp, float* dwh, float* dc0, float* dh0,
                              int wg_slices, int wg_kslice, float* wg_part,
                              void* stream) {
  return (int)seq_bwd_any(-1, wh, gates, cs, hs, h0, masks, dhs, dcT, dhT, T,
                          B, H, dxp, dwh, dc0, dh0, wg_slices, wg_kslice,
                          wg_part, (cudaStream_t)stream);
}

}  // extern "C"
