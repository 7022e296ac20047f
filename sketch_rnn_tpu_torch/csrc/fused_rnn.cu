// Training kernels of the PyTorch port, hand-written CUDA C++ for Hopper
// (sm_90a). Built by ops/_build.py with nvcc into a shared library with a
// plain C interface (no PyTorch headers) and bound with ctypes by
// ops/cuda_fused.py, whose plain PyTorch versions they are held against.
//
// Which TPU kernels they replace (sketch_rnn_tpu/ops/pallas_fused.py):
//   srt_lstm_fwd     <- fused_lstm forward, _lstm_fwd_kernel (pallas_call at
//                       :516), and, with no x_bias and no final carry,
//                       fused_lstm_seq forward, _lstm_seq_fwd_kernel (:731)
//   srt_lstm_bwd     <- fused_lstm backward, _lstm_bwd_kernel (:564), and,
//                       with no carry cotangents and no input or carry
//                       gradients, fused_lstm_seq backward,
//                       _lstm_seq_bwd_kernel (:771)
//   srt_ln_lstm_fwd  <- fused_ln_lstm forward, _lnlstm_fwd_kernel (:1016)
//   srt_ln_lstm_bwd  <- fused_ln_lstm backward, _lnlstm_bwd_kernel (:1066)
//
// What they compute. The forward runs T steps of the LSTM (gates
// (i, g, f, o), pre = ((x @ wx + b) + h @ wh) [+ x_bias]) or of the
// LayerNorm-LSTM (pre = (x @ wx + h @ wh) [+ x_bias], a two-pass layer
// norm per gate, the forget bias after the norm, a layer norm of the new
// cell state), with recurrent dropout on the candidate g. It writes hs and
// the PRE-step cell states cs (and the final carry when asked) and nothing
// else: no [T, B, 4H] gate buffer, no mask buffer. The backward walks time
// backwards, recomputes each step's gates from (x_t, h_{t-1}, c_{t-1}) --
// h_{t-1} read as hs[t-1], or h0 at t = 0 -- and back-propagates through
// the gate block into the pre-activation gradient d_pre, the carries'
// gradients, the inputs' (dxs, dx_bias) and (LN) the LN parameters'.
//
// Mixed precision, the Pallas contract (pallas_fused.py:28-51, _cast):
// the weights wx/wh arrive as W (float or bf16, pre-cast by the caller);
// every product rounds its activation operand (x, h, d_pre) to W and
// accumulates in float, so a bf16 product is exact and only the order of
// the float sums differs from the plain version. b, x_bias and the LN
// parameters are float. hs/cs (and dhs) are stored as R (float or bf16):
// the recurrence reads its unrounded float carry from registers, while
// the backward recomputes from the STORED values (h0 rounded to R at step
// 0, as pallas_fused._prev_block). d_pre is rounded to W for the
// transposed products and the weight-gradient sums; dx_bias, db and the
// LN-parameter sums take the unrounded float d_pre.
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
// d_pre [T, B, 4H] (float, unrounded) to a scratch the wrapper allocates,
// and a second kernel (weight_grad_kernel) reduces
//   [dwx; dwh; db] = sum over (t, b) of [x_t; h_{t-1}; 1]^T d_pre_t
// (K = T*B terms) as a tiled product in a fixed order, gathering its left
// operand from xs, hs and h0 in place. It rounds d_pre to W on load for the
// dwx/dwh rows and keeps it unrounded for the db row of ones, so the one
// float scratch serves both. Per-row quantities need no cross-block
// reduction: dx_bias sums d_pre over time in registers; the LN parameters'
// gradients are summed over time per row into a [B, 10H] partials scratch
// that a third kernel (sum_rows_kernel) adds up in row order. Every result
// is therefore the same, bit for bit, on every run. The weight gradients
// are written as float; the wrapper rounds them to W (the cotangent of a
// bf16 primal), as the JAX package's custom VJP does.
//
// Bound on the H100 at the training shapes (B=100, T=250; the encoder at
// H=256, the decoders at H=512, D=5): the recurrences' products are SIMT
// multiply-adds, outside the tensor cores: float 67 TFLOP/s. fused_lstm_seq
// fwd 13.4 GFLOP, bwd ~39.8; fused_lstm / fused_ln_lstm fwd 52.9, bwd
// ~158.9 GFLOP (including the weight-gradient products), i.e. 0.20 / 0.59 /
// 0.79 / 2.37 ms, above the time their bytes need at 3.35 TB/s -- bound by
// operations. With bf16 operands the same products could run on the tensor
// cores (989 TFLOP/s dense bf16), a bound 15x lower. This first design does
// not approach either: only B=100 of the 132 SMs hold a row, each row's
// block re-reads wh from L2 on every step (1 MiB encoder, 4 MiB decoder at
// float; half that at bf16; twice a step backwards), and the step-to-step
// dependency leaves a block's memory latency exposed. Sharing weight tiles
// across rows, tensor cores (TF32/bf16 wgmma) and TMA are later work;
// PERF.md keeps the measured times beside these bounds.

#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

template <typename W>
struct Cell {
  const W* wx;             // [D, 4H]
  const W* wh;             // [H, 4H]
  const float* b;          // [4H] (lstm) or null
  const float* xb;         // [B, 4H] per-row gate bias or null
  const float* ln_gamma;   // [4, H] (LN)
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
  int D, H;
  float forget_bias;
};

// Column j of the four pre-activations of one row:
//   ((x @ wx [+ b]) + h @ wh) [+ xb]
// s_x holds the D inputs, s_h the H previous hidden values, both already
// rounded to W.
template <typename W>
__device__ __forceinline__ void gate_pre(const Cell<W>& p, const float* s_x,
                                         const float* s_h, int row, int j,
                                         float (&pre)[4]) {
  const int H = p.H, G = 4 * H;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * H + j;
    float xp = 0.0f;
    for (int q = 0; q < p.D; ++q)
      xp = fmaf(s_x[q], to_f(p.wx[q * G + col]), xp);
    if (p.b != nullptr) xp = xp + p.b[col];
    pre[g] = xp;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const W* w = p.wh + j;
#pragma unroll 4
  for (int k = 0; k < H; ++k, w += G) {
    const float hk = s_h[k];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[g] = fmaf(hk, to_f(w[g * H]), acc[g]);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    pre[g] = pre[g] + acc[g];
    if (p.xb != nullptr) pre[g] = pre[g] + p.xb[(size_t)row * G + g * H + j];
  }
}

template <typename W, typename R>
struct Fwd {
  Cell<W> p;
  const float* xs;  // [T, B, D]
  const float* c0;  // [B, H]
  const float* h0;  // [B, H]
  Dropout drop;
  R* hs;      // [T, B, H]
  R* cs;      // [T, B, H] pre-step cell states
  float* cT;  // [B, H] or null
  float* hT;  // [B, H] or null
  int T, B;
};

template <bool LN, typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads) rnn_fwd_kernel(Fwd<W, R> a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const Cell<W>& p = a.p;
  const int H = p.H, D = p.D, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  float* s_h = smem;       // H: h_{t-1} rounded to W (the product's operand)
  float* s_x = s_h + H;    // D: x_t rounded to W
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float c = 0.0f, h = 0.0f;
  if (own) {
    c = a.c0[(size_t)row * H + j];
    h = a.h0[(size_t)row * H + j];
    s_h[j] = rnd<W>(h);
  }
  for (int t = 0; t < a.T; ++t) {
    for (int q = threadIdx.x; q < D; q += blockDim.x)
      s_x[q] = rnd<W>(a.xs[((size_t)t * B + row) * D + q]);
    __syncthreads();  // s_x and s_h ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_h, row, j, pre);
    const float m = own ? dropout_mask(a.drop, seed, t, B, row, H, j) : 1.0f;
    float nc, nh;
    if (LN) {
      ln_gates_fwd(pre, c, m, own, H, j, p.ln_gamma, p.ln_beta, p.lnc_gamma,
                   p.lnc_beta, p.forget_bias, s_red, nc, nh);
    } else {
      const float i = sigmoidf_(pre[0]), gu = tanhf(pre[1]);
      const float f = sigmoidf_(pre[2] + p.forget_bias), o = sigmoidf_(pre[3]);
      nc = c * f + i * (gu * m);
      nh = tanhf(nc) * o;
    }
    __syncthreads();  // every read of s_h and s_x of this step is done
    if (own) {
      const size_t at = ((size_t)t * B + row) * H + j;
      a.cs[at] = from_f<R>(c);
      a.hs[at] = from_f<R>(nh);
      s_h[j] = rnd<W>(nh);
      c = nc;
      h = nh;
    }
  }
  if (own && a.cT != nullptr) {
    a.cT[(size_t)row * H + j] = c;
    a.hT[(size_t)row * H + j] = h;
  }
}

template <typename W, typename R>
struct Bwd {
  Cell<W> p;
  const float* xs;   // [T, B, D]
  const float* h0;   // [B, H]
  const R* hs;       // [T, B, H]
  const R* cs;       // [T, B, H]
  const R* dhs;      // [T, B, H]
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

template <bool LN, typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads) rnn_bwd_kernel(Bwd<W, R> a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const Cell<W>& p = a.p;
  const int H = p.H, D = p.D, G = 4 * H, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* s_hp = smem;         // H: h_{t-1} (stored value) rounded to W
  float* s_dhn = s_hp + H;    // H: dh_{t-1}
  float* s_dp = s_dhn + H;    // 4H: d_pre of this step rounded to W
  float* s_x = s_dp + G;      // D: x_t rounded to W
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float dh = 0.0f, dc = 0.0f;
  float xb_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const LnParams ln = {p.ln_gamma, p.ln_beta, p.lnc_gamma, p.lnc_beta};
  LnGrads lg;
  if (own) {
    if (a.dhT != nullptr) dh = a.dhT[(size_t)row * H + j];
    if (a.dcT != nullptr) dc = a.dcT[(size_t)row * H + j];
  }
  // the transposed product covers the wx rows too when dxs is wanted
  const int r_first = a.dxs != nullptr ? 0 : D;

  for (int s = a.T - 1; s >= 0; --s) {
    for (int q = threadIdx.x; q < D; q += blockDim.x)
      s_x[q] = rnd<W>(a.xs[((size_t)s * B + row) * D + q]);
    float c_prev = 0.0f, dh_tot = 0.0f;
    if (own) {
      const size_t at = ((size_t)s * B + row) * H + j;
      const float hp = s > 0 ? to_f(a.hs[at - (size_t)B * H])
                             : rnd<R>(a.h0[(size_t)row * H + j]);
      s_hp[j] = rnd<W>(hp);
      c_prev = to_f(a.cs[at]);
      dh_tot = dh + to_f(a.dhs[at]);
    }
    __syncthreads();  // s_x, s_hp ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_hp, row, j, pre);
    const float m = own ? dropout_mask(a.drop, seed, s, B, row, H, j) : 1.0f;
    float dp[4], dc_next;
    if (LN) {
      ln_gates_bwd(pre, c_prev, m, dh_tot, dc, own, H, j, ln, p.forget_bias,
                   s_red, lg, dp, dc_next);
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
        s_dp[g * H + j] = rnd<W>(dp[g]);
        xb_acc[g] += dp[g];
      }
    }
    __syncthreads();  // s_dp complete
    // dh_{t-1}[k] = sum_c d_pre[c] wh[k, c]; dx[q] = sum_c d_pre[c] wx[q, c]
    for (int r = r_first + warp; r < D + H; r += nw) {
      const W* wr = r < D ? p.wx + (size_t)r * G : p.wh + (size_t)(r - D) * G;
      float acc = 0.0f;
      for (int col = lane; col < G; col += 32)
        acc = fmaf(s_dp[col], to_f(wr[col]), acc);
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
      pr[g * H + j] = lg.dgam[g];
      pr[4 * H + g * H + j] = lg.dbet[g];
    }
    pr[8 * H + j] = lg.dgc;
    pr[9 * H + j] = lg.dbc;
  }
}

template <typename W>
Cell<W> make_cell(const void* wx, const void* wh, const float* b,
                  const float* xb, const float* ln_gamma,
                  const float* ln_beta, const float* lnc_gamma,
                  const float* lnc_beta, int D, int H, float forget_bias) {
  Cell<W> p;
  p.wx = static_cast<const W*>(wx);
  p.wh = static_cast<const W*>(wh);
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

template <bool LN, typename W, typename R>
cudaError_t launch_fwd(const Fwd<W, R>& a, cudaStream_t stream) {
  if (a.p.H < 1 || a.p.H > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.p.H + a.p.D) * sizeof(float);
  cudaError_t err = set_smem((const void*)rnn_fwd_kernel<LN, W, R>, smem);
  if (err != cudaSuccess) return err;
  rnn_fwd_kernel<LN, W, R><<<a.B, threads_for(a.p.H), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool LN, typename W, typename R>
cudaError_t launch_bwd(const Bwd<W, R>& a, int ones, float* dwx, float* dwh,
                       float* db, cudaStream_t stream) {
  const int H = a.p.H, D = a.p.D;
  if (H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * H + D) * sizeof(float);
  cudaError_t err = set_smem((const void*)rnn_bwd_kernel<LN, W, R>, smem);
  if (err != cudaSuccess) return err;
  rnn_bwd_kernel<LN, W, R><<<a.B, threads_for(H), smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((4 * H + kTN - 1) / kTN, (D + H + ones + kTM - 1) / kTM);
  weight_grad_kernel<W, R><<<grid, kGemmThreads, 0, stream>>>(
      a.xs, a.h0, a.hs, a.dpre, a.T, a.B, D, H, ones, dwx, dwh, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous tensors: wx/wh are float32,
// or bfloat16 when w_bf16; hs/cs/dhs are float32, or bfloat16 when
// r_bf16; everything else is float32 unless named int32. masks / seed /
// xb may be null (no streamed masks, no in-kernel dropout, no per-row
// bias), and so may every output of the LSTM entry points marked
// "or null" (the sequence-only kernel asks for none of them). The weight
// gradients are written as float32. Each returns the cudaError_t of its
// launches (0 when all were accepted).

// cT, hT: or null.
int srt_lstm_fwd(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* c0,
                 const float* h0, const float* masks, const int* seed, int T,
                 int B, int D, int H, int w_bf16, int r_bf16, float keep,
                 float inv_keep, float forget_bias, void* hs, void* cs,
                 float* cT, float* hT, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    Fwd<W, R> a;
    a.p = make_cell<W>(wx, wh, b, xb, nullptr, nullptr, nullptr, nullptr, D,
                       H, forget_bias);
    a.xs = xs;
    a.c0 = c0;
    a.h0 = h0;
    a.drop = make_dropout(masks, seed, keep, inv_keep);
    a.hs = static_cast<R*>(hs);
    a.cs = static_cast<R*>(cs);
    a.cT = cT;
    a.hT = hT;
    a.T = T;
    a.B = B;
    return launch_fwd<false>(a, (cudaStream_t)stream);
  });
}

// dcT, dhT, dxs, dxb, dc0, dh0: or null.
int srt_lstm_bwd(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* h0,
                 const void* hs, const void* cs, const void* dhs,
                 const float* dcT, const float* dhT, const float* masks,
                 const int* seed, int T, int B, int D, int H, int w_bf16,
                 int r_bf16, float keep, float inv_keep, float forget_bias,
                 float* dpre, float* dxs, float* dxb, float* dwx, float* db,
                 float* dwh, float* dc0, float* dh0, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    Bwd<W, R> a;
    a.p = make_cell<W>(wx, wh, b, xb, nullptr, nullptr, nullptr, nullptr, D,
                       H, forget_bias);
    a.xs = xs;
    a.h0 = h0;
    a.hs = static_cast<const R*>(hs);
    a.cs = static_cast<const R*>(cs);
    a.dhs = static_cast<const R*>(dhs);
    a.dcT = dcT;
    a.dhT = dhT;
    a.drop = make_dropout(masks, seed, keep, inv_keep);
    a.dpre = dpre;
    a.dxs = dxs;
    a.dxb = dxb;
    a.dc0 = dc0;
    a.dh0 = dh0;
    a.part = nullptr;
    a.T = T;
    a.B = B;
    return launch_bwd<false>(a, 1, dwx, dwh, db, (cudaStream_t)stream);
  });
}

int srt_ln_lstm_fwd(const float* xs, const float* xb, const void* wx,
                    const void* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* c0, const float* h0,
                    const float* masks, const int* seed, int T, int B, int D,
                    int H, int w_bf16, int r_bf16, float keep,
                    float inv_keep, float forget_bias, void* hs, void* cs,
                    float* cT, float* hT, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    Fwd<W, R> a;
    a.p = make_cell<W>(wx, wh, nullptr, xb, ln_gamma, ln_beta, lnc_gamma,
                       lnc_beta, D, H, forget_bias);
    a.xs = xs;
    a.c0 = c0;
    a.h0 = h0;
    a.drop = make_dropout(masks, seed, keep, inv_keep);
    a.hs = static_cast<R*>(hs);
    a.cs = static_cast<R*>(cs);
    a.cT = cT;
    a.hT = hT;
    a.T = T;
    a.B = B;
    return launch_fwd<true>(a, (cudaStream_t)stream);
  });
}

int srt_ln_lstm_bwd(const float* xs, const float* xb, const void* wx,
                    const void* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* h0, const void* hs,
                    const void* cs, const void* dhs, const float* dcT,
                    const float* dhT, const float* masks, const int* seed,
                    int T, int B, int D, int H, int w_bf16, int r_bf16,
                    float keep, float inv_keep, float forget_bias,
                    float* dpre, float* part, float* dxs, float* dxb,
                    float* dwx, float* dwh, float* dln, float* dc0,
                    float* dh0, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    Bwd<W, R> a;
    a.p = make_cell<W>(wx, wh, nullptr, xb, ln_gamma, ln_beta, lnc_gamma,
                       lnc_beta, D, H, forget_bias);
    a.xs = xs;
    a.h0 = h0;
    a.hs = static_cast<const R*>(hs);
    a.cs = static_cast<const R*>(cs);
    a.dhs = static_cast<const R*>(dhs);
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
    return launch_bwd<true>(a, 0, dwx, dwh, nullptr, st);
  });
  if (err != cudaSuccess) return (int)err;
  const int cols = 10 * H;
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, st>>>(part, B, cols, dln);
  return (int)cudaGetLastError();
}

}  // extern "C"
