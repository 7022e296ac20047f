// The LayerNorm-LSTM decomposition ladder of the PyTorch port, hand-written
// CUDA C++ for Hopper (sm_90a): the production LayerNorm-LSTM forward and
// backward (srt_ln_lstm_fwd, srt_ln_lstm_bwd; rows 5f and 5b) with one term
// of work taken out per arm, so that the difference of two arms' times
// prices that term. Built by ops/_build.py with nvcc into a shared library
// with a plain C interface and bound with ctypes by
// sketch_rnn_tpu_torch/scripts/probe_dec_bwd_split.py and probe_ln_stats.py,
// whose plain PyTorch versions they are held against.
//
// Which TPU kernels they replace:
//   srt_ln_probe_fwd <- scripts/probe_dec_bwd_split.py make_fwd_kernel
//                       (:281, pallas_call at :374), arms prod / no_ln /
//                       no_gates / floor
//   srt_ln_probe_bwd <- scripts/probe_dec_bwd_split.py make_bwd_kernel
//                       (:141, pallas_call at :504), arms prod / no_lnbwd /
//                       no_ln / no_gates / no_gradmm / floor, and
//                       scripts/probe_ln_stats.py _bwd_kernel_fake (:87,
//                       pallas_call at :209), arm fake
//
// The arms compute what the reference's arms compute, oddities included:
// they are op-count probes, not models.
//
// Forward (outputs hs, cs [T, B, H] in R, cT, hT float):
//   prod      the production forward.
//   no_ln     the ten layer-norm statistics replaced by stand-ins read from
//             the row's pre-step cell state: mean = c[0] * 1e-3, r = 1 +
//             c[1] * 1e-3 for the four gates and for the cell norm (which
//             reads c_prev, not the new cell state); the mask on the
//             candidate once.
//   no_gates  c' = 0.9 c + 0.1 pre[gate 0], h' = 0.5 h + 0.1 pre[gate 1]:
//             the products stay (all four gates), the gate block goes.
//   floor     no products: c' = 0.9 c + x[0] * 1e-3 (the product taken in
//             W, as the reference's bf16 x does), h' = 0.5 h + 1e-3 x_bias[j]
//             (1e-3 c without x_bias).
// Backward (outputs dxs, dxb, dwx, dwh, the LN-parameter sums, dc0, dh0, all
// float, the weight gradients NOT rounded to W), from two flags and a tail:
//   stats         real (prod, no_lnbwd) or the stand-ins above (no_ln,
//                 fake). The stand-in forward builds the new cell state
//                 WITHOUT the mask, then hands the backward g_u * m as the
//                 candidate, which it masks again: g = g_u * m * m, and
//                 1 - g_u^2 is taken of the masked g_u.
//   corrections   the layer-norm backward's two row-mean corrections (prod,
//                 fake) or d_pre = dy * gamma, dc += dyc * lnc_gamma
//                 (no_lnbwd, no_ln); the LN-parameter sums are kept.
//   tail          full (the gate block, every product: prod, no_lnbwd,
//                 no_ln, fake); no_gates (d_pre = 0.25 pre + dh + 0.1 dc,
//                 dc' = 0.9 dc + 1e-3 c_prev, every product kept, LN sums
//                 zero); no_gradmm (no_gates without the dwx/dwh/dx
//                 products: dh_{t-1} = d_pre @ wh^T stays, dx = 0.5 x);
//                 floor (no products: d_pre = dh + 0.1 dc [+ x_bias],
//                 dh_{t-1} = 0.5 dh + 1e-3 h_prev, dx = 0.5 x).
//
// The arms on Hopper. Every arm runs on the production kernels' persistent
// cooperative loops (ln_lstm.cuh; fused_rnn.cu's header has their design),
// its arm a compile-time policy of the loop and of its launches, so that
// prod IS the production instantiation: bit for bit srt_ln_lstm_fwd and
// srt_ln_lstm_bwd, over the same windows of rows. What the others take out:
//   forward (one kernel; per step (a) the products and the gates' slice
//   moments, (b) the gate block and the cell's moments, (c) the cell norm,
//   h and the stores, each ended by a grid barrier):
//     no_ln     both moment exchanges and their barriers: the gate block and
//               h follow each chunk's products, one barrier a step (the h
//               exchange). The stand-ins read c_prev[0] and c_prev[1] of the
//               row, which slice 0 owns: its blocks publish them, in the
//               phase that writes h, to a [2, B, 2] exchange beside hx.
//     no_gates  the gate block too: one barrier a step; the float h carry
//               in a [B, H] scratch; gates 2 and 3's products kept alive by
//               a store behind a null pointer test the compiler cannot
//               resolve.
//     floor     every product, exchange and barrier: on the same grid, each
//               thread walks its pairs' sequences with the carries in
//               registers, over the same streams.
//   backward (production's launches: the hoisted recompute, the statistics,
//   the loop with (a)-(c) ending in a grid barrier each and (d) the
//   transposed product, the LN sums' row sum, the weight pass):
//     no_lnbwd  the corrections' two exchanges and their barriers: one pass
//               over the pairs and one barrier a step, before (d); the
//               statistics launch, the LN sums and the row sum kept.
//     no_ln     also the statistics launch: the stand-ins come from the
//               residual cs (units 0 and 1 of the row), which every block
//               reads.
//     fake      the statistics launch alone: the stand-ins, both exchanges
//               and all three barriers kept.
//     no_gates  the gate block: the recompute, then d_pre and dc' as above
//               in one pass, one barrier a step; the dx product and the
//               weight pass kept, no row sum, the LN sums zero.
//     no_gradmm no_gates without the weight pass and the dx product (dx =
//               0.5 x, zero dwx/dwh). d_pre is still written to the
//               scratch: (d) reads the other slices' d_pre through it (the
//               row-block arm kept no d_pre).
//     floor     the recompute, every product and every barrier: each thread
//               walks its pairs' sequences backwards with dh and dc in
//               registers on the loop's grid; zero dwx/dwh and LN sums.
// The zero outputs are cudaMemsetAsync calls, not kernel launches. The
// wrappers allocate only what an arm uses (probe_dec_bwd_split.fwd_plan and
// bwd_plan). windows > 0 forces the loops' windows of rows (the ladder's
// grid-scaling runs, each window T more steps of grid barriers); 0 takes
// the production plan.
//
// The row-block design, which every arm ran first, stays reachable as
// srt_ln_probe_fwd_rowblock and srt_ln_probe_bwd_rowblock (namespace
// rowblock below), to be held and timed beside the design that replaced
// it: fused_rnn.cu's row-block kernels (rnn_fwd_kernel<true, W, R>,
// rnn_bwd_kernel<true, W, R>) with the arms' terms taken out, one block
// per batch row, T inside the block, one thread per hidden unit, weights
// read from L2 every step, the layer-norm statistics as block reductions
// (block_sum), the weight gradients by the fixed-order second pass. Their
// prod arms repeat the row-block kernels' operations in their order
// (gate_pre is copied), so they are the row-block entries
// srt_ln_lstm_fwd_rowblock and srt_ln_lstm_bwd_rowblock, bit for bit.
// There, no_gradmm drops the d_pre scratch and the wx rows of the
// transposed product, and floor has no shared operand and so no barrier;
// the stand-in stats take c_prev[0] and c_prev[1] of the row through one
// shared-memory broadcast.
//
// Bound on the H100 at the probe's shape (B=4096, T=250, H=512, D=5, bf16
// weights and residuals): the products of bf16 operands could run on the
// tensor cores (989 TFLOP/s dense). A forward with products does 2*T*B*(D +
// H)*4H = 2.17 TFLOP (2.19 ms); a backward with every product three times
// that (6.58 ms), no_gradmm the recompute and the dh product (4.3 TFLOP,
// 4.36 ms); floor moves ~1.1 (fwd) / ~1.6 (bwd) GB at 3.35 TB/s (~0.34 /
// ~0.48 ms). The loops run the products as production does (SIMT float
// multiply-adds from resident weights, the recompute and the weight pass on
// the tensor cores at bf16): the ladder measures differences, not the bound.

#include <type_traits>

#include "ln_lstm.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

// ---------------------------------------------------------------------------
// The row-block design (srt_ln_probe_*_rowblock), as it was before the arms
// moved onto the persistent loops; its own Cell, Fwd and Bwd.
namespace rowblock {


enum FwdArm { kFwdProd = 0, kFwdNoLn, kFwdNoGates, kFwdFloor };
enum BwdArm { kProd = 0, kNoLnBwd, kNoLn, kNoGates, kNoGradmm, kFloor, kFake };

template <int ARM>
struct BwdPlan {
  static constexpr bool kGates =  // the gate block (real or stand-in stats)
      ARM == kProd || ARM == kNoLnBwd || ARM == kNoLn || ARM == kFake;
  static constexpr bool kFakeStats = ARM == kNoLn || ARM == kFake;
  static constexpr bool kCorrections = ARM == kProd || ARM == kFake;
  // dwx/dwh (the d_pre scratch and the second pass) and the dx product
  static constexpr bool kWeightGrads = kGates || ARM == kNoGates;
  static constexpr bool kLnGrads = kGates;
};

template <typename W>
struct Cell {
  const W* wx;             // [D, 4H]
  const W* wh;             // [H, 4H]
  const float* xb;         // [B, 4H] per-row gate bias or null
  const float* ln_gamma;   // [4, H]
  const float* ln_beta;    // [4, H]
  const float* lnc_gamma;  // [H]
  const float* lnc_beta;   // [H]
  int D, H;
  float forget_bias;
};

// Column j of the four pre-activations of one row, (x @ wx + h @ wh) [+ xb]:
// fused_rnn.cu's gate_pre without the LSTM bias, in its order.
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
  R* hs;            // [T, B, H]
  R* cs;            // [T, B, H] pre-step cell states
  float* cT;        // [B, H]
  float* hT;        // [B, H]
  float* keep_live; // null: the store that keeps a kept product alive
  int T, B;
};

template <int ARM, typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads) probe_fwd_kernel(Fwd<W, R> a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  __shared__ float s_c01[2];  // c[0], c[1] of the row: the stand-in stats
  const Cell<W>& p = a.p;
  const int H = p.H, D = p.D, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H;
  float* s_h = smem;     // H: h_{t-1} rounded to W (the product's operand)
  float* s_x = s_h + H;  // D: x_t rounded to W
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float c = 0.0f, h = 0.0f;
  if (own) {
    c = a.c0[(size_t)row * H + j];
    h = a.h0[(size_t)row * H + j];
    s_h[j] = rnd<W>(h);
  }
  for (int t = 0; t < a.T; ++t) {
    if constexpr (ARM == kFwdFloor) {
      // nothing crosses threads: no barrier
      if (own) {
        const float x0 = rnd<W>(a.xs[((size_t)t * B + row) * D]);
        const float nc = c * 0.9f + rnd<W>(x0 * rnd<W>(1e-3f));
        const float nh =
            h * 0.5f + (p.xb != nullptr
                            ? p.xb[(size_t)row * 4 * H + j] * 1e-3f
                            : c * 1e-3f);
        const size_t at = ((size_t)t * B + row) * H + j;
        a.cs[at] = from_f<R>(c);
        a.hs[at] = from_f<R>(nh);
        c = nc;
        h = nh;
      }
      continue;
    }
    for (int q = threadIdx.x; q < D; q += blockDim.x)
      s_x[q] = rnd<W>(a.xs[((size_t)t * B + row) * D + q]);
    if (ARM == kFwdNoLn && j < 2) s_c01[j] = c;
    __syncthreads();  // s_x, s_h (and s_c01) ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_h, row, j, pre);
    float nc, nh;
    if constexpr (ARM == kFwdProd) {
      const float m = own ? dropout_mask(a.drop, seed, t, B, row, H, j) : 1.0f;
      ln_gates_fwd(pre, c, m, own, H, j, p.ln_gamma, p.ln_beta, p.lnc_gamma,
                   p.lnc_beta, p.forget_bias, s_red, nc, nh);
    } else if constexpr (ARM == kFwdNoLn) {
      const float m = own ? dropout_mask(a.drop, seed, t, B, row, H, j) : 1.0f;
      const float mean = s_c01[0] * 1e-3f, r = 1.0f + s_c01[1] * 1e-3f;
      float y[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        y[g] = own ? (pre[g] - mean) * r * p.ln_gamma[g * H + j] +
                         p.ln_beta[g * H + j]
                   : 0.0f;
      const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
      const float f = sigmoidf_(y[2] + p.forget_bias), o = sigmoidf_(y[3]);
      nc = c * f + i * (gu * m);
      const float yc =
          own ? (nc - mean) * r * p.lnc_gamma[j] + p.lnc_beta[j] : 0.0f;
      nh = tanhf(yc) * o;
    } else {  // kFwdNoGates
      nc = c * 0.9f + pre[0] * 0.1f;
      nh = h * 0.5f + pre[1] * 0.1f;
      if (a.keep_live != nullptr) a.keep_live[j] = pre[2] + pre[3];
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
  if (own) {
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
  float* dpre;  // [T, B, 4H] scratch of the arms with weight gradients
  float* dxs;   // [T, B, D]
  float* dxb;   // [B, 4H] or null
  float* dc0;   // [B, H]
  float* dh0;   // [B, H]
  float* part;  // [B, 10H] LN partials (dgam 4H | dbet 4H | dgc H | dbc H)
  WgPlan wg;    // the weight pass's split-K plan and partials scratch
  int T, B;
};

// The gate block's backward of the arms no_lnbwd (real stats, no
// corrections), no_ln (stand-in stats, no corrections) and fake (stand-in
// stats, corrections): rnn_common.cuh's ln_gates_bwd with the reference's
// substitutions. c01 holds c_prev[0], c_prev[1] of the row. Block-wide.
template <bool FAKE, bool CORR>
__device__ __forceinline__ void arm_gates_bwd(
    const float (&pre)[4], float c_prev, float m, float dh_tot, float dc,
    bool own, int H, int j, const LnParams& ln, float forget_bias,
    const float* c01, float* s_red, LnGrads& acc, float (&dp)[4],
    float& dc_next) {
  float mean[4], rs[4], xhat[4], y[4];
  if constexpr (FAKE) {
    const float mu = c01[0] * 1e-3f, r = 1.0f + c01[1] * 1e-3f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      mean[g] = mu;
      rs[g] = r;
    }
  } else {
    gate_stats(pre, own, H, s_red, mean, rs);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    xhat[g] = (pre[g] - mean[g]) * rs[g];
    y[g] = own ? xhat[g] * ln.ln_gamma[g * H + j] + ln.ln_beta[g * H + j]
               : 0.0f;
  }
  const float i = sigmoidf_(y[0]);
  float gu = tanhf(y[1]);
  const float f = sigmoidf_(y[2] + forget_bias), o = sigmoidf_(y[3]);
  float nc, cmean, crs;
  if constexpr (FAKE) {
    nc = c_prev * f + i * gu;  // the stand-in forward: no mask
    gu = gu * m;               // ln_res[1] = g_u * m
    cmean = mean[0];
    crs = rs[0];
  } else {
    nc = c_prev * f + i * (gu * m);
    row_stats(nc, own, H, s_red, cmean, crs);
  }
  const float xhat_c = (nc - cmean) * crs;
  const float gc = own ? ln.lnc_gamma[j] : 0.0f;
  const float yc = own ? xhat_c * gc + ln.lnc_beta[j] : 0.0f;
  const float tanh_yc = tanhf(yc);
  const float do_ = dh_tot * tanh_yc;
  const float dyc = dh_tot * o * (1.0f - tanh_yc * tanh_yc);
  acc.dgc += dyc * xhat_c;
  acc.dbc += dyc;
  float dcv;
  if constexpr (CORR) {
    const float dxh_c = dyc * gc;
    float q2[2] = {own ? dxh_c : 0.0f, own ? dxh_c * xhat_c : 0.0f};
    block_sum<2>(q2, s_red);
    dcv = dc + crs * (dxh_c - q2[0] / (float)H - xhat_c * (q2[1] / (float)H));
  } else {
    dcv = dc + dyc * gc;
  }
  const float df = dcv * c_prev;
  const float di = dcv * (gu * m);
  const float dgu = dcv * i * m;
  const float dy[4] = {di * i * (1.0f - i), dgu * (1.0f - gu * gu),
                       df * f * (1.0f - f), do_ * o * (1.0f - o)};
  float dxh[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    acc.dgam[g] += dy[g] * xhat[g];
    acc.dbet[g] += dy[g];
    dxh[g] = own ? dy[g] * ln.ln_gamma[g * H + j] : 0.0f;
  }
  if constexpr (CORR) {
    float q8[8];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      q8[g] = dxh[g];
      q8[4 + g] = own ? dxh[g] * xhat[g] : 0.0f;
    }
    block_sum<8>(q8, s_red);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      dp[g] = rs[g] * (dxh[g] - q8[g] / (float)H -
                       xhat[g] * (q8[4 + g] / (float)H));
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) dp[g] = dxh[g];
  }
  dc_next = dcv * f;
}

template <int ARM, typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads) probe_bwd_kernel(Bwd<W, R> a) {
  using Plan = BwdPlan<ARM>;
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  __shared__ float s_c01[2];  // c_prev[0], c_prev[1]: the stand-in stats
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
  // the transposed product covers the wx rows only for the arms that keep
  // the dx product
  const int r_first = Plan::kWeightGrads ? 0 : D;

  for (int s = a.T - 1; s >= 0; --s) {
    if constexpr (ARM == kFloor) {
      // no products and nothing crosses threads: no barrier
      if (own) {
        const size_t at = ((size_t)s * B + row) * H + j;
        const float hp = s > 0 ? to_f(a.hs[at - (size_t)B * H])
                               : rnd<R>(a.h0[(size_t)row * H + j]);
        const float c_prev = to_f(a.cs[at]);
        const float dh_tot = dh + to_f(a.dhs[at]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = dh_tot + dc * 0.1f;
          if (p.xb != nullptr) v = v + p.xb[(size_t)row * G + g * H + j];
          xb_acc[g] += v;
        }
        dc = dc * 0.9f + c_prev * 1e-3f;
        dh = dh_tot * 0.5f + hp * 1e-3f;
      }
      for (int q = threadIdx.x; q < D; q += blockDim.x) {
        const size_t at = ((size_t)s * B + row) * D + q;
        a.dxs[at] = a.xs[at] * 0.5f;
      }
      continue;
    }
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
    if (Plan::kFakeStats && j < 2) s_c01[j] = c_prev;
    __syncthreads();  // s_x, s_hp (and s_c01) ready
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (own) gate_pre(p, s_x, s_hp, row, j, pre);
    float dp[4], dc_next;
    if constexpr (Plan::kGates) {
      const float m = own ? dropout_mask(a.drop, seed, s, B, row, H, j) : 1.0f;
      if constexpr (ARM == kProd)
        ln_gates_bwd(pre, c_prev, m, dh_tot, dc, own, H, j, ln, p.forget_bias,
                     s_red, lg, dp, dc_next);
      else
        arm_gates_bwd<Plan::kFakeStats, Plan::kCorrections>(
            pre, c_prev, m, dh_tot, dc, own, H, j, ln, p.forget_bias, s_c01,
            s_red, lg, dp, dc_next);
    } else {  // kNoGates, kNoGradmm
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g] = pre[g] * 0.25f + dh_tot + dc * 0.1f;
      dc_next = dc * 0.9f + c_prev * 1e-3f;
    }
    if (own) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if constexpr (Plan::kWeightGrads)
          a.dpre[((size_t)s * B + row) * G + g * H + j] = dp[g];
        s_dp[g * H + j] = rnd<W>(dp[g]);
        xb_acc[g] += dp[g];
      }
    }
    if (!Plan::kWeightGrads) {
      for (int q = threadIdx.x; q < D; q += blockDim.x) {
        const size_t at = ((size_t)s * B + row) * D + q;
        a.dxs[at] = a.xs[at] * 0.5f;
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
  if (Plan::kLnGrads) {
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
Cell<W> make_cell(const void* wx, const void* wh, const float* xb,
                  const float* ln_gamma, const float* ln_beta,
                  const float* lnc_gamma, const float* lnc_beta, int D, int H,
                  float forget_bias) {
  Cell<W> p;
  p.wx = static_cast<const W*>(wx);
  p.wh = static_cast<const W*>(wh);
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

template <int ARM, typename W, typename R>
cudaError_t launch_fwd(const Fwd<W, R>& a, cudaStream_t stream) {
  const size_t smem = (size_t)(a.p.H + a.p.D) * sizeof(float);
  cudaError_t err = set_smem((const void*)probe_fwd_kernel<ARM, W, R>, smem);
  if (err != cudaSuccess) return err;
  probe_fwd_kernel<ARM, W, R><<<a.B, threads_for(a.p.H), smem, stream>>>(a);
  return cudaGetLastError();
}

// The recurrence, then (the arms with weight gradients) the fixed-order
// weight-gradient pass and (the arms with LN gradients) the row-order sum
// of the LN partials; the other arms' dwx/dwh/dln are written as zeros.
template <int ARM, typename W, typename R>
cudaError_t launch_bwd(const Bwd<W, R>& a, float* dwx, float* dwh, float* dln,
                       cudaStream_t stream) {
  using Plan = BwdPlan<ARM>;
  const int H = a.p.H, D = a.p.D;
  const size_t smem = (size_t)(6 * H + D) * sizeof(float);
  cudaError_t err = set_smem((const void*)probe_bwd_kernel<ARM, W, R>, smem);
  if (err != cudaSuccess) return err;
  probe_bwd_kernel<ARM, W, R><<<a.B, threads_for(H), smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (Plan::kWeightGrads) {
    const WgArgs<R> w = wg_lstm_args(a.xs, a.h0, a.hs, a.dpre, a.T, a.B, D,
                                     H, 0, a.wg, dwx, dwh, nullptr);
    err = launch_weight_grad_pass<W>(w, stream);
  } else {
    err = cudaMemsetAsync(dwx, 0, (size_t)D * 4 * H * sizeof(float), stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dwh, 0, (size_t)H * 4 * H * sizeof(float), stream);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = 10 * H;
  if constexpr (Plan::kLnGrads)
    sum_rows_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(a.part, a.B, cols,
                                                           dln);
  else
    err = cudaMemsetAsync(dln, 0, (size_t)cols * sizeof(float), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace rowblock

// Call f(std::integral_constant<int, ARM>) for the arm id, or refuse it.
template <int N, typename F>
cudaError_t with_arm(int arm, F&& f) {
  if constexpr (N < 0) {
    return cudaErrorInvalidValue;
  } else {
    if (arm == N) return f(std::integral_constant<int, N>{});
    return with_arm<N - 1>(arm, f);
  }
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous tensors: wx/wh are float32,
// or bfloat16 when w_bf16; hs/cs/dhs are float32, or bfloat16 when r_bf16;
// everything else is float32 unless named int32. seed (int32 scalar, the
// in-kernel dropout of keep), xb, dcT and dhT may be null; dpre (the
// [T, B, 4H] float scratch) and part ([B, 10H]) may be null for the arms
// that do not use them, and so may wg_part, the weight pass's [wg_slices,
// D + H, 4H] partials scratch (wg_slices and wg_kslice: its split-K plan,
// cuda_fused.weight_grad_plan). H is 2..512. Each returns the cudaError_t
// of its launches (0 when all were accepted).

// The persistent arms (ln_lstm.cuh). hx: a [2, B, H] scratch of the weight
// type, null for floor; work: the arm's float scratch
// (probe_dec_bwd_split.fwd_plan: prod (ceil(H / 16) * 10 + 4 * H) * B
// floats, no_ln 4 * B, no_gates B * H, floor none); windows: 0 for the
// production plan of windows of rows, else that many. prod is
// srt_ln_lstm_fwd. arm: 0 prod, 1 no_ln, 2 no_gates, 3 floor.
int srt_ln_probe_fwd(int arm, const float* xs, const float* xb,
                     const void* wx, const void* wh, const float* ln_gamma,
                     const float* ln_beta, const float* lnc_gamma,
                     const float* lnc_beta, const float* c0, const float* h0,
                     const int* seed, int T, int B, int D, int H, int w_bf16,
                     int r_bf16, float keep, float inv_keep,
                     float forget_bias, void* hs, void* cs, float* cT,
                     float* hT, void* hx, float* work, int windows,
                     void* stream) {
  if (H < 2 || H > kMaxThreads || windows < 0)
    return (int)cudaErrorInvalidValue;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    Fwd<W, R> a;
    a.p = make_cell<W>(wx, wh, nullptr, xb, ln_gamma, ln_beta, lnc_gamma,
                       lnc_beta, D, H, forget_bias);
    a.xs = xs;
    a.c0 = c0;
    a.h0 = h0;
    a.drop = make_dropout(nullptr, seed, keep, inv_keep);
    a.hs = static_cast<R*>(hs);
    a.cs = static_cast<R*>(cs);
    a.cT = cT;
    a.hT = hT;
    a.T = T;
    a.B = B;
    return with_arm<kLnFwdFloor>(arm, [&](auto arm_c) {
      constexpr int A = decltype(arm_c)::value;
      if (A != kLnFwdFloor && (hx == nullptr || work == nullptr))
        return cudaErrorInvalidValue;
      return launch_ln_fwd_loop<W, R, A>(a, static_cast<W*>(hx),
                                         ln_arm_fwd_work<A>(work, B, H),
                                         (cudaStream_t)stream, windows);
    });
  });
}

// The persistent arms: production's launches less what each arm takes out
// (LnBwdPolicy), then the arm's zero outputs (cudaMemsetAsync). dpre: the
// [T, B, 4H] float scratch (null for floor); part: [B, 10H] (the arms with
// LN sums); work: the arm's float scratch (bwd_plan: prod (ceil(H / 16) *
// 10 + T * 10 + 4 * H) * B floats, no_lnbwd T * B * 10, fake
// (ceil(H / 16) * 10 + 4 * H) * B, the others none); wg_*: the weight
// pass's plan and partials (the arms with the pass); windows as
// srt_ln_probe_fwd's. prod is srt_ln_lstm_bwd. arm: 0 prod, 1 no_lnbwd,
// 2 no_ln, 3 no_gates, 4 no_gradmm, 5 floor, 6 fake (probe_ln_stats).
// dln: [10H] = dgam 4H | dbet 4H | dgc H | dbc H.
int srt_ln_probe_bwd(int arm, const float* xs, const float* xb,
                     const void* wx, const void* wh, const float* ln_gamma,
                     const float* ln_beta, const float* lnc_gamma,
                     const float* lnc_beta, const float* h0, const void* hs,
                     const void* cs, const void* dhs, const float* dcT,
                     const float* dhT, const int* seed, int T, int B, int D,
                     int H, int w_bf16, int r_bf16, float keep,
                     float inv_keep, float forget_bias, float* dpre,
                     float* part, float* work, float* dxs, float* dxb,
                     float* dwx, float* dwh, float* dln, float* dc0,
                     float* dh0, int wg_slices, int wg_kslice,
                     float* wg_part, int windows, void* stream) {
  if (H < 2 || H > kMaxThreads || windows < 0 || dxs == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
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
    a.drop = make_dropout(nullptr, seed, keep, inv_keep);
    a.dpre = dpre;
    a.dxs = dxs;
    a.dxb = dxb;
    a.dc0 = dc0;
    a.dh0 = dh0;
    a.part = part;
    a.wg = {wg_slices, wg_kslice, wg_part};
    a.T = T;
    a.B = B;
    return with_arm<kLnBwdFake>(arm, [&](auto arm_c) {
      constexpr int A = decltype(arm_c)::value;
      using P = LnBwdPolicy<A>;
      if ((P::kRecompute && dpre == nullptr) ||
          ((P::kStats || P::kExchanges) && work == nullptr))
        return cudaErrorInvalidValue;
      cudaError_t err =
          launch_ln_lstm_bwd<W, R, A>(a, work, 0, dwx, dwh, dln, st, windows);
      const size_t g4 = (size_t)4 * H * sizeof(float);
      if (err == cudaSuccess && !P::kWeightPass) {
        err = cudaMemsetAsync(dwx, 0, (size_t)D * g4, st);
        if (err == cudaSuccess)
          err = cudaMemsetAsync(dwh, 0, (size_t)H * g4, st);
      }
      if (err == cudaSuccess && !P::kGates)
        err = cudaMemsetAsync(dln, 0, (size_t)10 * H * sizeof(float), st);
      return err;
    });
  });
}

// The row-block design (namespace rowblock): the arms as they ran before
// the persistent loops, prod bit for bit srt_ln_lstm_fwd_rowblock.
// arm: 0 prod, 1 no_ln, 2 no_gates, 3 floor.
int srt_ln_probe_fwd_rowblock(
    int arm, const float* xs, const float* xb, const void* wx, const void* wh,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* c0, const float* h0, const int* seed,
    int T, int B, int D, int H, int w_bf16, int r_bf16, float keep,
    float inv_keep, float forget_bias, void* hs, void* cs, float* cT, float* hT,
    void* stream) {
  if (H < 2 || H > kMaxThreads) return (int)cudaErrorInvalidValue;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    rowblock::Fwd<W, R> a;
    a.p = rowblock::make_cell<W>(wx, wh, xb, ln_gamma, ln_beta, lnc_gamma,
                                 lnc_beta, D, H, forget_bias);
    a.xs = xs;
    a.c0 = c0;
    a.h0 = h0;
    a.drop = make_dropout(nullptr, seed, keep, inv_keep);
    a.hs = static_cast<R*>(hs);
    a.cs = static_cast<R*>(cs);
    a.cT = cT;
    a.hT = hT;
    a.keep_live = nullptr;
    a.T = T;
    a.B = B;
    return with_arm<rowblock::kFwdFloor>(arm, [&](auto arm_c) {
      return rowblock::launch_fwd<decltype(arm_c)::value>(
          a, (cudaStream_t)stream);
    });
  });
}

// The row-block design: prod bit for bit srt_ln_lstm_bwd_rowblock. arm:
// as srt_ln_probe_bwd's.
int srt_ln_probe_bwd_rowblock(
    int arm, const float* xs, const float* xb, const void* wx, const void* wh,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* h0, const void* hs, const void* cs,
    const void* dhs, const float* dcT, const float* dhT, const int* seed, int T,
    int B, int D, int H, int w_bf16, int r_bf16, float keep, float inv_keep,
    float forget_bias, float* dpre, float* part, float* dxs, float* dxb,
    float* dwx, float* dwh, float* dln, float* dc0, float* dh0, int wg_slices,
    int wg_kslice, float* wg_part, void* stream) {
  if (H < 2 || H > kMaxThreads) return (int)cudaErrorInvalidValue;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    rowblock::Bwd<W, R> a;
    a.p = rowblock::make_cell<W>(wx, wh, xb, ln_gamma, ln_beta, lnc_gamma,
                                 lnc_beta, D, H, forget_bias);
    a.xs = xs;
    a.h0 = h0;
    a.hs = static_cast<const R*>(hs);
    a.cs = static_cast<const R*>(cs);
    a.dhs = static_cast<const R*>(dhs);
    a.dcT = dcT;
    a.dhT = dhT;
    a.drop = make_dropout(nullptr, seed, keep, inv_keep);
    a.dpre = dpre;
    a.dxs = dxs;
    a.dxb = dxb;
    a.dc0 = dc0;
    a.dh0 = dh0;
    a.part = part;
    a.wg = {wg_slices, wg_kslice, wg_part};
    a.T = T;
    a.B = B;
    return with_arm<rowblock::kFake>(arm, [&](auto arm_c) {
      return rowblock::launch_bwd<decltype(arm_c)::value>(
          a, dwx, dwh, dln, (cudaStream_t)stream);
    });
  });
}

}  // extern "C"
