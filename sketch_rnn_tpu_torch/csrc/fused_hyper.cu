// The HyperLSTM training kernels of the PyTorch port, hand-written CUDA C++
// for Hopper (sm_90a). Built by ops/_build.py with nvcc into a shared
// library with a plain C interface (no PyTorch headers) and bound with
// ctypes by ops/cuda_fused.py, whose plain PyTorch versions
// (hyper_lstm_fwd_reference, hyper_lstm_bwd_reference) they are held
// against.
//
// Which TPU kernels they replace (sketch_rnn_tpu/ops/pallas_fused.py):
//   srt_hyper_fwd <- fused_hyper_lstm forward, _hyper_fwd_kernel (:1246,
//                    pallas_call at :1530)
//   srt_hyper_bwd <- fused_hyper_lstm backward, _hyper_bwd_kernel (:1297,
//                    pallas_call at :1613)
// with the step math of _hyper_recompute (:1198) and the per-gate block
// projections _block_scale / _block_unscale / _block_scale_grad.
//
// What they compute, per step and batch row (layer-norm variant):
//   hyper_pre = ((x @ wxh_x + h @ wxh_h) + bh) + hh @ whh  [+ x_bias_hyper]
//   (hc, hh) <- LSTM gates of hyper_pre (forget bias, NO dropout)
//   z_p = hh_new @ w_hz_p (+ b_hz_p for p in x, h)                   [4e]
//   s_p[g] = z_p[g] @ zd_p[g]        (four [e, H] blocks per path)   [4H]
//   pre = s_x * (x @ wx [+ x_bias]) + s_h * (h @ wh) + s_b + b
//   (c, h) <- the LayerNorm-LSTM gate block of pre, dropout mask on g
// The forward writes hs, hyhs (post-step hidden states) and cs, hycs
// (PRE-step cell states) and the four final carries, nothing else. The
// backward walks time backwards, recomputes each step from the stored
// residuals (h_{t-1} = hs[t-1], hh_{t-1} = hyhs[t-1]; h0 / hh0 at t = 0)
// and back-propagates through the gate block, the scaling (x_bias sits
// INSIDE it: d x_bias = sum_t d_pre * s_x), the block and z projections
// and the auxiliary LSTM. The carries' gradients are overwritten each
// step, not accumulated: dhh <- dh_pre @ whh^T, dh <- dhp @ wh^T + dh_pre
// @ wxh_h^T, dx = dxp @ wx^T + dh_pre @ wxh_x^T.
//
// Mixed precision, the Pallas contract (_cast): the eight matrices wx, wh,
// wxh_x, wxh_h, whh, w_hz_{x,h,b} arrive as W (float or bf16); a product
// with one of them rounds its activation operand to W and accumulates in
// float. zd_* are float, so the block projections and their gradients are
// float x float at either W. b, bh, b_hz_*, the LN parameters and both
// x_bias are float. The four residual streams (and dhs) are stored as R;
// the recurrence reads its unrounded float carries, the backward the
// stored values (h0, hh0 rounded to R at step 0). Backwards dz_p, dh_pre,
// dxp and dhp are rounded to W for the transposed products and the
// weight-gradient sums; every bias gradient, both x_bias gradients and the
// LN sums take the unrounded values.
//
// Design. One block per batch row, the T loop inside, blockDim =
// max(H, HH) rounded up to a warp (both <= 512); every phase is guarded or
// strided, so H, HH and 4e may stand in any order. Thread j < H owns column
// j of the four main gates, thread j < HH column j of the auxiliary LSTM's
// state. Within a step, each phase behind a __syncthreads():
//   1. the 4HH auxiliary pre-activations, strided over ALL threads (up to
//      four columns a thread at once, so the block's upper half is not
//      idle when HH < H), into shared memory; x @ wx and h @ wh of the
//      thread's own four main columns into registers;
//   2. the auxiliary gates (threads j < HH); hh_new rounded to W into
//      shared memory;
//   3. the 12e values of z_x, z_h, z_b, strided, into shared memory;
//   4. the thread's twelve block products (length e), pre, and the
//      LayerNorm-LSTM gate block shared with fused_ln_lstm
//      (rnn_common.cuh: block-wide two-pass statistics).
// Backwards, after the gate block: dz (12e outputs, each a length-H dot
// of a shared ds vector with one contiguous zd row: one warp per output,
// shuffle-reduced); dhh (one warp per row of the three w_hz); the
// auxiliary gates' backward; then the transposed products, one warp per
// row of [wx|wxh_x], [wh|wxh_h], whh, read coalesced.
//
// Nineteen parameter gradients, no atomics. Blocks run in no fixed order,
// so nothing is accumulated across blocks. What a row can sum over time it
// keeps in registers or shared memory and writes once per row (the LN
// sums, db, dbh, db_hz_x, db_hz_h into a [B, P] partials scratch that
// sum_rows_kernel adds up in row order; both x_bias gradients straight to
// their rows). The eleven matrix gradients are products over K = T * B of
// a left operand (x, h_{t-1}, hh_{t-1}, the recomputed hh_new or z_p) with
// a per-step gradient stream; the recurrence writes those streams to
// float scratch (d_pre and its products dxp, dhp, dsx, dsh [T, B, 4H];
// dh_pre [T, B, 4HH]; dz and z [3, T, B, 4e]; hh_new [T, B, HH]) and
// tn_gemm_kernel reduces each in a fixed order, rounding its operands to W
// on load where the Pallas kernel does and leaving the zd products float.
// h_{t-1} and hh_{t-1} are gathered from hs / hyhs and h0 / hh0 in place.
// Every result is therefore the same, bit for bit, on every run. At B=100,
// T=250, H=512, HH=256, e=32 the scratch is 1.23 GB.
//
// Bound on the H100 at the hyper preset's shape (B=100, T=250, D=5): the
// forward's products are 4.29 MFLOP per row-step, 107.3 GFLOP in all, SIMT
// float multiply-adds at 67 TFLOP/s: 1.60 ms, above the time its bytes
// need -- bound by operations; the backward about three times that. With
// bf16 matrices the same products could run on the tensor cores (the zd
// products stay float). This first design approaches neither: a row's
// block re-reads about 8 MiB of weights from L2 on every step at float
// (wh 4, wxh_h 2, whh 1, zd 0.75, w_hz 0.4), only 100 of 132 SMs hold a
// row, and the phases of a step are serial. Sharing weight tiles across
// rows, tensor cores and a smaller scratch are later work; PERF.md keeps
// the measured times beside the bounds.

#include "rnn_common.cuh"

namespace {

template <typename W>
struct HyperCell {
  const W* wx;           // [D, 4H]
  const float* b;        // [4H]
  const W* wh;           // [H, 4H]
  const W* wxh_x;        // [D, 4HH]
  const W* wxh_h;        // [H, 4HH]
  const float* bh;       // [4HH]
  const W* whh;          // [HH, 4HH]
  const W* w_hz[3];      // [HH, 4e]: paths x, h, b
  const float* b_hz[2];  // [4e]: paths x, h
  const float* zd[3];    // [4, e, H]: paths x, h, b
  LnParams ln;
  const float* xb;   // [B, 4H] or null
  const float* xbh;  // [B, 4HH] or null
  int D, H, HH, E;
  float forget_bias;
};

// What one step leaves in the registers of its owning threads.
struct StepRegs {
  float xp[4], hp[4], sx[4], sh[4], pre[4];  // thread j < H, per gate
  float hi, hg, hf, ho, nhc, nhh;            // thread j < HH
};

// The shared memory one step works in.
struct StepSmem {
  float* x;     // D: x_t rounded to W
  float* h;     // H: h_{t-1} rounded to W
  float* hh;    // HH: hh_{t-1} rounded to W on entry, hh_t rounded on exit
  float* hpre;  // 4HH: the auxiliary pre-activations
  float* z;     // 12e: z_x | z_h | z_b
};

// N auxiliary pre-activation columns c, c + stride, ... of one row.
template <int N, typename W>
__device__ __forceinline__ void aux_cols(const HyperCell<W>& p,
                                         const StepSmem& sm, int row, int c,
                                         int stride) {
  const int G = 4 * p.HH;
  float ax[N], ah[N], ar[N];
#pragma unroll
  for (int n = 0; n < N; ++n) ax[n] = ah[n] = ar[n] = 0.0f;
  for (int q = 0; q < p.D; ++q) {
    const float xq = sm.x[q];
#pragma unroll
    for (int n = 0; n < N; ++n)
      ax[n] = fmaf(xq, to_f(p.wxh_x[(size_t)q * G + c + n * stride]), ax[n]);
  }
  const W* w = p.wxh_h + c;
#pragma unroll 4
  for (int k = 0; k < p.H; ++k, w += G) {
    const float hk = sm.h[k];
#pragma unroll
    for (int n = 0; n < N; ++n) ah[n] = fmaf(hk, to_f(w[n * stride]), ah[n]);
  }
  w = p.whh + c;
#pragma unroll 4
  for (int k = 0; k < p.HH; ++k, w += G) {
    const float hk = sm.hh[k];
#pragma unroll
    for (int n = 0; n < N; ++n) ar[n] = fmaf(hk, to_f(w[n * stride]), ar[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = c + n * stride;
    float v = ((ax[n] + ah[n]) + p.bh[col]) + ar[n];
    if (p.xbh != nullptr) v = v + p.xbh[(size_t)row * G + col];
    sm.hpre[col] = v;
  }
}

// One HyperLSTM step of one row up to the main pre-activations
// (pallas_fused._hyper_recompute without the gate block). On entry sm.x,
// sm.h, sm.hh are complete and visible; hc is the thread's pre-step
// auxiliary cell state (j < HH). Block-wide: every thread calls it. On
// exit sm.hh holds the new hyper_h rounded to W and sm.z the three z.
template <typename W>
__device__ __forceinline__ void hyper_step(const HyperCell<W>& p,
                                           const StepSmem& sm, int row,
                                           float hc, StepRegs& r) {
  const int H = p.H, HH = p.HH, E4 = 4 * p.E, G = 4 * H, GH = 4 * HH;
  const int j = threadIdx.x, nt = blockDim.x;
  // 1. auxiliary pre-activations (all threads), main products (j < H)
  {
    int c = j;
    for (; c + 3 * nt < GH; c += 4 * nt) aux_cols<4>(p, sm, row, c, nt);
    for (; c + nt < GH; c += 2 * nt) aux_cols<2>(p, sm, row, c, nt);
    for (; c < GH; c += nt) aux_cols<1>(p, sm, row, c, nt);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) r.xp[g] = r.hp[g] = 0.0f;
  if (j < H) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * H + j;
      float acc = 0.0f;
      for (int q = 0; q < p.D; ++q)
        acc = fmaf(sm.x[q], to_f(p.wx[(size_t)q * G + col]), acc);
      if (p.xb != nullptr) acc = acc + p.xb[(size_t)row * G + col];
      r.xp[g] = acc;
    }
    const W* w = p.wh + j;
#pragma unroll 4
    for (int k = 0; k < H; ++k, w += G) {
      const float hk = sm.h[k];
#pragma unroll
      for (int g = 0; g < 4; ++g) r.hp[g] = fmaf(hk, to_f(w[g * H]), r.hp[g]);
    }
  }
  __syncthreads();  // hpre complete; sm.hh (old) read by everyone
  // 2. the auxiliary LSTM's gates, no dropout
  r.hi = r.hg = r.hf = r.ho = r.nhc = r.nhh = 0.0f;
  if (j < HH) {
    r.hi = sigmoidf_(sm.hpre[j]);
    r.hg = tanhf(sm.hpre[HH + j]);
    r.hf = sigmoidf_(sm.hpre[2 * HH + j] + p.forget_bias);
    r.ho = sigmoidf_(sm.hpre[3 * HH + j]);
    r.nhc = hc * r.hf + r.hi * r.hg;
    r.nhh = tanhf(r.nhc) * r.ho;
    sm.hh[j] = rnd<W>(r.nhh);
  }
  __syncthreads();  // the new hyper_h is in sm.hh
  // 3. z_p = hyper_h @ w_hz_p (+ b_hz_p)
  for (int c = j; c < 3 * E4; c += nt) {
    const int path = c / E4, q = c - path * E4;
    const W* w = p.w_hz[path] + q;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < HH; ++k, w += E4) acc = fmaf(sm.hh[k], to_f(*w), acc);
    if (path < 2) acc = acc + p.b_hz[path][q];
    sm.z[c] = acc;
  }
  __syncthreads();  // z complete
  // 4. the block scales and pre = s_x * xp + s_h * hp + s_b + b
#pragma unroll
  for (int g = 0; g < 4; ++g) r.sx[g] = r.sh[g] = r.pre[g] = 0.0f;
  if (j < H) {
    const int E = p.E;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float sx = 0.0f, sh = 0.0f, sb = 0.0f;
      const size_t at = (size_t)g * E * H + j;
      for (int q = 0; q < E; ++q) {
        const size_t o = at + (size_t)q * H;
        sx = fmaf(sm.z[g * E + q], p.zd[0][o], sx);
        sh = fmaf(sm.z[E4 + g * E + q], p.zd[1][o], sh);
        sb = fmaf(sm.z[2 * E4 + g * E + q], p.zd[2][o], sb);
      }
      r.sx[g] = sx;
      r.sh[g] = sh;
      r.pre[g] = ((sx * r.xp[g] + sh * r.hp[g]) + sb) + p.b[g * H + j];
    }
  }
}

__host__ __device__ inline int step_smem_floats(int D, int H, int HH, int E) {
  return D + H + HH + 4 * HH + 12 * E;
}

__device__ __forceinline__ StepSmem carve_step(float* base, int D, int H,
                                               int HH, int E) {
  StepSmem sm;
  sm.h = base;
  sm.hh = sm.h + H;
  sm.hpre = sm.hh + HH;
  sm.z = sm.hpre + 4 * HH;
  sm.x = sm.z + 12 * E;
  return sm;
}

template <typename W, typename R>
struct HyperFwd {
  HyperCell<W> p;
  const float* xs;   // [T, B, D]
  const float* c0;   // [B, H]
  const float* h0;   // [B, H]
  const float* hc0;  // [B, HH]
  const float* hh0;  // [B, HH]
  Dropout drop;
  R* hs;    // [T, B, H]  post-step h
  R* cs;    // [T, B, H]  pre-step c
  R* hycs;  // [T, B, HH] pre-step hyper_c
  R* hyhs;  // [T, B, HH] post-step hyper_h
  float *cT, *hT, *hcT, *hhT;
  int T, B;
};

template <typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads)
hyper_fwd_kernel(HyperFwd<W, R> a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const HyperCell<W>& p = a.p;
  const int H = p.H, HH = p.HH, D = p.D, B = a.B;
  const int row = blockIdx.x, j = threadIdx.x;
  const bool own = j < H, ownh = j < HH;
  const StepSmem sm = carve_step(smem, D, H, HH, p.E);
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float c = 0.0f, h = 0.0f, hc = 0.0f, hh = 0.0f;
  if (own) {
    c = a.c0[(size_t)row * H + j];
    h = a.h0[(size_t)row * H + j];
    sm.h[j] = rnd<W>(h);
  }
  if (ownh) {
    hc = a.hc0[(size_t)row * HH + j];
    hh = a.hh0[(size_t)row * HH + j];
    sm.hh[j] = rnd<W>(hh);
  }
  for (int t = 0; t < a.T; ++t) {
    for (int q = j; q < D; q += blockDim.x)
      sm.x[q] = rnd<W>(a.xs[((size_t)t * B + row) * D + q]);
    __syncthreads();  // sm.x, sm.h, sm.hh ready
    StepRegs r;
    hyper_step(p, sm, row, hc, r);
    const float m = own ? dropout_mask(a.drop, seed, t, B, row, H, j) : 1.0f;
    float nc, nh;
    // block-wide; its reductions also order every read of sm.h and sm.x
    // of this step before the writes below
    ln_gates_fwd(r.pre, c, m, own, H, j, p.ln.ln_gamma, p.ln.ln_beta,
                 p.ln.lnc_gamma, p.ln.lnc_beta, p.forget_bias, s_red, nc, nh);
    if (own) {
      const size_t at = ((size_t)t * B + row) * H + j;
      a.cs[at] = from_f<R>(c);
      a.hs[at] = from_f<R>(nh);
      sm.h[j] = rnd<W>(nh);
      c = nc;
      h = nh;
    }
    if (ownh) {
      const size_t at = ((size_t)t * B + row) * HH + j;
      a.hycs[at] = from_f<R>(hc);
      a.hyhs[at] = from_f<R>(r.nhh);
      hc = r.nhc;
      hh = r.nhh;  // sm.hh already holds it, rounded to W
    }
  }
  if (own) {
    a.cT[(size_t)row * H + j] = c;
    a.hT[(size_t)row * H + j] = h;
  }
  if (ownh) {
    a.hcT[(size_t)row * HH + j] = hc;
    a.hhT[(size_t)row * HH + j] = hh;
  }
}

template <typename W, typename R>
struct HyperBwd {
  HyperCell<W> p;
  const float* xs;   // [T, B, D]
  const float* h0;   // [B, H]
  const float* hh0;  // [B, HH]
  const R* hs;       // [T, B, H]
  const R* cs;       // [T, B, H]
  const R* hycs;     // [T, B, HH]
  const R* hyhs;     // [T, B, HH]
  const R* dhs;      // [T, B, H]
  const float *dcT, *dhT;    // [B, H]
  const float *dhcT, *dhhT;  // [B, HH]
  Dropout drop;
  // scratch streams, one entry per (t, row)
  float* dpre;   // [T, B, 4H] d_pre (== ds_b)
  float* dxp;    // [T, B, 4H] d_pre * s_x
  float* dhp;    // [T, B, 4H] d_pre * s_h
  float* dsx;    // [T, B, 4H] d_pre * xp
  float* dsh;    // [T, B, 4H] d_pre * hp
  float* dhpre;  // [T, B, 4HH] the auxiliary pre-activations' gradient
  float* zs;     // [3, T, B, 4e] the recomputed z_x, z_h, z_b
  float* dzs;    // [3, T, B, 4e] their gradients
  float* hhn;    // [T, B, HH] the recomputed hyper_h, rounded to W
  float* part;   // [B, P] per-row sums, P = 14H + 4HH + 8e:
                 //   dgam 4H | dbet 4H | dgc H | dbc H | db 4H | dbh 4HH |
                 //   db_hz_x 4e | db_hz_h 4e
  float* dxs;    // [T, B, D]
  float* dxb;    // [B, 4H] or null
  float* dxbh;   // [B, 4HH] or null
  float *dc0, *dh0;    // [B, H]
  float *dhc0, *dhh0;  // [B, HH]
  int T, B;
};

__host__ __device__ inline int bwd_smem_floats(int D, int H, int HH, int E) {
  return step_smem_floats(D, H, HH, E) + 5 * 4 * H + 12 * E + 12 * E + 8 * E +
         HH + 4 * HH + H + HH;
}

template <typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads)
hyper_bwd_kernel(HyperBwd<W, R> a) {
  extern __shared__ float smem[];
  __shared__ float s_red[33 * kRedMax];
  const HyperCell<W>& p = a.p;
  const int H = p.H, HH = p.HH, D = p.D, E = p.E, B = a.B, T = a.T;
  const int G = 4 * H, GH = 4 * HH, E4 = 4 * E;
  const int row = blockIdx.x, j = threadIdx.x, nt = blockDim.x;
  const bool own = j < H, ownh = j < HH;
  const int lane = j & 31, warp = j >> 5, nw = nt >> 5;
  const StepSmem sm = carve_step(smem, D, H, HH, E);
  float* s_dsx = smem + step_smem_floats(D, H, HH, E);  // 4H: d_pre * xp
  float* s_dsh = s_dsx + G;    // 4H: d_pre * hp
  float* s_dp = s_dsh + G;     // 4H: d_pre
  float* s_dxp = s_dp + G;     // 4H: d_pre * s_x rounded to W
  float* s_dhp = s_dxp + G;    // 4H: d_pre * s_h rounded to W
  float* s_dz = s_dhp + G;     // 12e: dz_x | dz_h | dz_b
  float* s_dzc = s_dz + 3 * E4;   // 12e: the same rounded to W
  float* s_dbz = s_dzc + 3 * E4;  // 8e: sums over time of dz_x | dz_h
  float* s_dhh = s_dbz + 2 * E4;  // HH: dz @ w_hz^T
  float* s_dha = s_dhh + HH;      // 4HH: dh_pre rounded to W
  float* s_dhn = s_dha + GH;      // H: dh_{t-1}
  float* s_dhhn = s_dhn + H;      // HH: dhh_{t-1}
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  float dh = 0.0f, dc = 0.0f, dhh = 0.0f, dhc = 0.0f;
  float xb_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // d x_bias
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // db of this row
  float xbh_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // d x_bias_hyper == dbh row
  LnGrads lg;
  if (own) {
    dh = a.dhT[(size_t)row * H + j];
    dc = a.dcT[(size_t)row * H + j];
  }
  if (ownh) {
    dhh = a.dhhT[(size_t)row * HH + j];
    dhc = a.dhcT[(size_t)row * HH + j];
  }
  for (int q = j; q < 2 * E4; q += nt) s_dbz[q] = 0.0f;

  for (int s = T - 1; s >= 0; --s) {
    const size_t step = (size_t)s * B + row;
    for (int q = j; q < D; q += nt) sm.x[q] = rnd<W>(a.xs[step * D + q]);
    float c_prev = 0.0f, dh_tot = 0.0f, hc_prev = 0.0f;
    if (own) {
      const size_t at = step * H + j;
      const float hp = s > 0 ? to_f(a.hs[at - (size_t)B * H])
                             : rnd<R>(a.h0[(size_t)row * H + j]);
      sm.h[j] = rnd<W>(hp);
      c_prev = to_f(a.cs[at]);
      dh_tot = dh + to_f(a.dhs[at]);
    }
    if (ownh) {
      const size_t at = step * HH + j;
      const float hhp = s > 0 ? to_f(a.hyhs[at - (size_t)B * HH])
                              : rnd<R>(a.hh0[(size_t)row * HH + j]);
      sm.hh[j] = rnd<W>(hhp);
      hc_prev = to_f(a.hycs[at]);
    }
    __syncthreads();  // sm.x, sm.h, sm.hh ready
    StepRegs r;
    hyper_step(p, sm, row, hc_prev, r);
    // what the weight-gradient products read of the recomputed step
    if (ownh) a.hhn[step * HH + j] = sm.hh[j];
    for (int c = j; c < 3 * E4; c += nt) {
      const int path = c / E4;
      a.zs[((size_t)path * T * B + step) * E4 + (c - path * E4)] = sm.z[c];
    }
    const float m = own ? dropout_mask(a.drop, seed, s, B, row, H, j) : 1.0f;
    float dp[4], dc_next;
    ln_gates_bwd(r.pre, c_prev, m, dh_tot, dc, own, H, j, p.ln, p.forget_bias,
                 s_red, lg, dp, dc_next);
    // pre = s_x * xp + s_h * hp + s_b + b
    if (own) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int col = g * H + j;
        const float dsx = dp[g] * r.xp[g], dxp = dp[g] * r.sx[g];
        const float dsh = dp[g] * r.hp[g], dhp = dp[g] * r.sh[g];
        const size_t at = step * G + col;
        a.dpre[at] = dp[g];
        a.dxp[at] = dxp;
        a.dhp[at] = dhp;
        a.dsx[at] = dsx;
        a.dsh[at] = dsh;
        s_dp[col] = dp[g];
        s_dsx[col] = dsx;
        s_dsh[col] = dsh;
        s_dxp[col] = rnd<W>(dxp);
        s_dhp[col] = rnd<W>(dhp);
        db_acc[g] += dp[g];
        xb_acc[g] += dxp;
      }
    }
    __syncthreads();  // the five 4H vectors complete
    // dz_p[g * e + q] = sum_j ds_p[g * H + j] * zd_p[g][q][j]
    for (int o = warp; o < 3 * E4; o += nw) {
      const int path = o / E4, q = o - path * E4, g = q / E;
      const float* src = (path == 0 ? s_dsx : path == 1 ? s_dsh : s_dp) + g * H;
      const float* zr = p.zd[path] + (size_t)q * H;
      float acc = 0.0f;
      for (int col = lane; col < H; col += 32)
        acc = fmaf(src[col], zr[col], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        s_dz[o] = acc;
        s_dzc[o] = rnd<W>(acc);
        a.dzs[((size_t)path * T * B + step) * E4 + q] = acc;
      }
    }
    __syncthreads();  // dz complete
    for (int q = j; q < 2 * E4; q += nt) s_dbz[q] += s_dz[q];
    // (dz_x @ w_hz_x^T + dz_h @ w_hz_h^T + dz_b @ w_hz_b^T)[k]
    for (int k = warp; k < HH; k += nw) {
      float acc = 0.0f;
      for (int c = lane; c < 3 * E4; c += 32) {
        const int path = c / E4;
        acc = fmaf(s_dzc[c],
                   to_f(p.w_hz[path][(size_t)k * E4 + (c - path * E4)]), acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_dhh[k] = acc;
    }
    __syncthreads();  // s_dhh complete
    // the auxiliary LSTM's backward
    float dhc_next = 0.0f;
    if (ownh) {
      const float dhh_tot = dhh + s_dhh[j];
      const float tanh_hc = tanhf(r.nhc);
      const float dhcv = dhc + dhh_tot * r.ho * (1.0f - tanh_hc * tanh_hc);
      const float dho = dhh_tot * tanh_hc;
      const float dhf = dhcv * hc_prev, dhi = dhcv * r.hg, dhg = dhcv * r.hi;
      const float da[4] = {dhi * r.hi * (1.0f - r.hi),
                           dhg * (1.0f - r.hg * r.hg),
                           dhf * r.hf * (1.0f - r.hf),
                           dho * r.ho * (1.0f - r.ho)};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a.dhpre[step * GH + g * HH + j] = da[g];
        s_dha[g * HH + j] = rnd<W>(da[g]);
        xbh_acc[g] += da[g];
      }
      dhc_next = dhcv * r.hf;
    }
    __syncthreads();  // s_dha complete
    // the transposed products, one warp per weight row:
    //   dx[q]   = dxp . wx[q]  + dh_pre . wxh_x[q]
    //   dh[k]   = dhp . wh[k]  + dh_pre . wxh_h[k]
    //   dhh[k]  = dh_pre . whh[k]
    for (int rr = warp; rr < D + H + HH; rr += nw) {
      float acc = 0.0f;
      if (rr < D + H) {
        const bool isx = rr < D;
        const W* wm = isx ? p.wx + (size_t)rr * G : p.wh + (size_t)(rr - D) * G;
        const W* wa = isx ? p.wxh_x + (size_t)rr * GH
                          : p.wxh_h + (size_t)(rr - D) * GH;
        const float* dv = isx ? s_dxp : s_dhp;
        for (int col = lane; col < G; col += 32)
          acc = fmaf(dv[col], to_f(wm[col]), acc);
        float acc2 = 0.0f;
        for (int col = lane; col < GH; col += 32)
          acc2 = fmaf(s_dha[col], to_f(wa[col]), acc2);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
          acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
        }
        acc = acc + acc2;
      } else {
        const W* wr = p.whh + (size_t)(rr - D - H) * GH;
        for (int col = lane; col < GH; col += 32)
          acc = fmaf(s_dha[col], to_f(wr[col]), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) {
        if (rr < D)
          a.dxs[step * D + rr] = acc;
        else if (rr < D + H)
          s_dhn[rr - D] = acc;
        else
          s_dhhn[rr - D - H] = acc;
      }
    }
    __syncthreads();  // the carries' gradients complete; step buffers free
    if (own) dh = s_dhn[j];
    if (ownh) {
      dhh = s_dhhn[j];
      dhc = dhc_next;
    }
    dc = dc_next;
  }

  const int P = 14 * H + 4 * HH + 8 * E;
  float* pr = a.part + (size_t)row * P;
  if (own) {
    a.dc0[(size_t)row * H + j] = dc;
    a.dh0[(size_t)row * H + j] = dh;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (a.dxb != nullptr) a.dxb[(size_t)row * G + g * H + j] = xb_acc[g];
      pr[g * H + j] = lg.dgam[g];
      pr[4 * H + g * H + j] = lg.dbet[g];
      pr[10 * H + g * H + j] = db_acc[g];
    }
    pr[8 * H + j] = lg.dgc;
    pr[9 * H + j] = lg.dbc;
  }
  if (ownh) {
    a.dhc0[(size_t)row * HH + j] = dhc;
    a.dhh0[(size_t)row * HH + j] = dhh;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (a.dxbh != nullptr) a.dxbh[(size_t)row * GH + g * HH + j] = xbh_acc[g];
      pr[14 * H + g * HH + j] = xbh_acc[g];
    }
  }
  for (int q = j; q < 2 * E4; q += nt) pr[14 * H + GH + q] = s_dbz[q];
}

// The left operand of a weight-gradient product, one row per k = t * B + b:
// a float stream f, or a stored residual stream r shifted by one step
// (its first `shift` rows come from `first`, rounded to R): h_{t-1} or
// hh_{t-1} gathered in place.
template <typename R>
struct LeftSrc {
  const float* f;
  const R* r;
  const float* first;
  int ld;     // row length of the source
  int shift;  // B
};

template <typename R>
__device__ __forceinline__ float load_left(const LeftSrc<R>& a, int k, int m) {
  if (a.r == nullptr) return a.f[(size_t)k * a.ld + m];
  return k < a.shift ? rnd<R>(a.first[(size_t)k * a.ld + m])
                     : to_f(a.r[(size_t)(k - a.shift) * a.ld + m]);
}

// C[z][m, n] = sum over k < K of A[k, z * za + m] * Bm[k, z * zb + n], K in
// chunks of 16 in a fixed order (deterministic); both operands rounded to W
// when round_ops. One 64 x 64 output tile per block, 256 threads of 4 x 4
// (strided) outputs; gridDim.z batches the four per-gate blocks of a zd
// gradient.
constexpr int kTM = 64, kTN = 64, kTK = 16, kGemmThreads = 256;

template <typename W, typename R>
__global__ void __launch_bounds__(kGemmThreads)
tn_gemm_kernel(LeftSrc<R> a, int za, int M, const float* __restrict__ bm,
               int ldb, int zb, int N, int K, int round_ops,
               float* __restrict__ c, int ldc, int zc) {
  __shared__ float sA[kTK][kTM];
  __shared__ float sB[kTK][kTN];
  const int z = blockIdx.z;
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
      const int k = k0 + kk, m = r0 + rr;
      float v = 0.0f;
      if (k < K && m < M) {
        v = load_left(a, k, z * za + m);
        if (round_ops) v = rnd<W>(v);
      }
      sA[kk][rr] = v;
    }
    for (int e = tid; e < kTK * kTN; e += kGemmThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.0f;
      if (k < K && n < N) {
        v = bm[(size_t)k * ldb + z * zb + n];
        if (round_ops) v = rnd<W>(v);
      }
      sB[kk][nn] = v;
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
    const int m = r0 + tr + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tc + 16 * q;
      if (n < N) c[(size_t)z * zc + (size_t)m * ldc + n] = acc[i][q];
    }
  }
}

template <typename W, typename R>
cudaError_t tn_gemm(const LeftSrc<R>& a, int za, int M, const float* bm,
                    int ldb, int zb, int N, int K, int round_ops, float* c,
                    int ldc, int zc, int batch, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM, batch);
  tn_gemm_kernel<W, R><<<grid, kGemmThreads, 0, stream>>>(
      a, za, M, bm, ldb, zb, N, K, round_ops, c, ldc, zc);
  return cudaGetLastError();
}

int hyper_threads(int H, int HH) { return threads_for(H > HH ? H : HH); }

bool hyper_sizes_ok(int D, int H, int HH, int E) {
  return D >= 1 && E >= 1 && H >= 1 && HH >= 1 && H <= kMaxThreads &&
         HH <= kMaxThreads;
}

// The float matrices' gradients, written by the weight-gradient products.
struct HyperMatGrads {
  float *wx, *wh, *wxh_x, *wxh_h, *whh, *w_hz[3], *zd[3];
};

template <typename W, typename R>
cudaError_t launch_hyper_bwd(const HyperBwd<W, R>& a, const HyperMatGrads& d,
                             float* dvec, cudaStream_t stream) {
  const HyperCell<W>& p = a.p;
  const int D = p.D, H = p.H, HH = p.HH, E = p.E, K = a.T * a.B;
  const int G = 4 * H, GH = 4 * HH, E4 = 4 * E;
  if (!hyper_sizes_ok(D, H, HH, E)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)bwd_smem_floats(D, H, HH, E) * sizeof(float);
  cudaError_t err = set_smem((const void*)hyper_bwd_kernel<W, R>, smem);
  if (err != cudaSuccess) return err;
  hyper_bwd_kernel<W, R><<<a.B, hyper_threads(H, HH), smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const LeftSrc<R> x = {a.xs, nullptr, nullptr, D, 0};
  const LeftSrc<R> hprev = {nullptr, a.hs, a.h0, H, a.B};
  const LeftSrc<R> hhprev = {nullptr, a.hyhs, a.hh0, HH, a.B};
  const LeftSrc<R> hhnew = {a.hhn, nullptr, nullptr, HH, 0};
#define SRT_GEMM(...)                                   \
  err = tn_gemm<W, R>(__VA_ARGS__, stream);             \
  if (err != cudaSuccess) return err
  SRT_GEMM(x, 0, D, a.dxp, G, 0, G, K, 1, d.wx, G, 0, 1);
  SRT_GEMM(hprev, 0, H, a.dhp, G, 0, G, K, 1, d.wh, G, 0, 1);
  SRT_GEMM(x, 0, D, a.dhpre, GH, 0, GH, K, 1, d.wxh_x, GH, 0, 1);
  SRT_GEMM(hprev, 0, H, a.dhpre, GH, 0, GH, K, 1, d.wxh_h, GH, 0, 1);
  SRT_GEMM(hhprev, 0, HH, a.dhpre, GH, 0, GH, K, 1, d.whh, GH, 0, 1);
  const float* ds[3] = {a.dsx, a.dsh, a.dpre};
  for (int path = 0; path < 3; ++path) {
    const size_t off = (size_t)path * K * E4;
    SRT_GEMM(hhnew, 0, HH, a.dzs + off, E4, 0, E4, K, 1, d.w_hz[path], E4, 0,
             1);
    const LeftSrc<R> z = {a.zs + off, nullptr, nullptr, E4, 0};
    SRT_GEMM(z, E, E, ds[path], G, H, H, K, 0, d.zd[path], H, E * H, 4);
  }
#undef SRT_GEMM
  const int P = 14 * H + 4 * HH + 8 * E;
  sum_rows_kernel<<<(P + 255) / 256, 256, 0, stream>>>(a.part, a.B, P, dvec);
  return cudaGetLastError();
}

template <typename W>
HyperCell<W> make_hyper_cell(const void* wx, const float* b, const void* wh,
                             const void* wxh_x, const void* wxh_h,
                             const float* bh, const void* whh,
                             const void* w_hz_x, const float* b_hz_x,
                             const void* w_hz_h, const float* b_hz_h,
                             const void* w_hz_b, const float* zd_x,
                             const float* zd_h, const float* zd_b,
                             const float* ln_gamma, const float* ln_beta,
                             const float* lnc_gamma, const float* lnc_beta,
                             const float* xb, const float* xbh, int D, int H,
                             int HH, int E, float forget_bias) {
  HyperCell<W> p;
  p.wx = static_cast<const W*>(wx);
  p.b = b;
  p.wh = static_cast<const W*>(wh);
  p.wxh_x = static_cast<const W*>(wxh_x);
  p.wxh_h = static_cast<const W*>(wxh_h);
  p.bh = bh;
  p.whh = static_cast<const W*>(whh);
  p.w_hz[0] = static_cast<const W*>(w_hz_x);
  p.w_hz[1] = static_cast<const W*>(w_hz_h);
  p.w_hz[2] = static_cast<const W*>(w_hz_b);
  p.b_hz[0] = b_hz_x;
  p.b_hz[1] = b_hz_h;
  p.zd[0] = zd_x;
  p.zd[1] = zd_h;
  p.zd[2] = zd_b;
  p.ln.ln_gamma = ln_gamma;
  p.ln.ln_beta = ln_beta;
  p.ln.lnc_gamma = lnc_gamma;
  p.ln.lnc_beta = lnc_beta;
  p.xb = xb;
  p.xbh = xbh;
  p.D = D;
  p.H = H;
  p.HH = HH;
  p.E = E;
  p.forget_bias = forget_bias;
  return p;
}

}  // namespace

extern "C" {

const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Pointers are device pointers of contiguous tensors. The eight matrices
// wx, wh, wxh_x, wxh_h, whh, w_hz_{x,h,b} are float32, or bfloat16 when
// w_bf16; the residual streams hs, cs, hycs, hyhs (and dhs) are float32, or
// bfloat16 when r_bf16; everything else is float32 unless named int32. xb
// and xbh are both null or both given; masks / seed may be null. Each
// returns the cudaError_t of its launches (0 when all were accepted).

int srt_hyper_fwd(const float* xs, const float* xb, const float* xbh,
                  const void* wx, const float* b, const void* wh,
                  const void* wxh_x, const void* wxh_h, const float* bh,
                  const void* whh, const void* w_hz_x, const float* b_hz_x,
                  const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
                  const float* zd_x, const float* zd_h, const float* zd_b,
                  const float* ln_gamma, const float* ln_beta,
                  const float* lnc_gamma, const float* lnc_beta,
                  const float* c0, const float* h0, const float* hc0,
                  const float* hh0, const float* masks, const int* seed,
                  int T, int B, int D, int H, int HH, int E, int w_bf16,
                  int r_bf16, float keep, float inv_keep, float forget_bias,
                  void* hs, void* cs, void* hycs, void* hyhs, float* cT,
                  float* hT, float* hcT, float* hhT, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    using W = decltype(w);
    using R = decltype(r);
    if (!hyper_sizes_ok(D, H, HH, E)) return cudaErrorInvalidValue;
    HyperFwd<W, R> a;
    a.p = make_hyper_cell<W>(wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
                             w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b,
                             ln_gamma, ln_beta, lnc_gamma, lnc_beta, xb, xbh,
                             D, H, HH, E, forget_bias);
    a.xs = xs;
    a.c0 = c0;
    a.h0 = h0;
    a.hc0 = hc0;
    a.hh0 = hh0;
    a.drop = make_dropout(masks, seed, keep, inv_keep);
    a.hs = static_cast<R*>(hs);
    a.cs = static_cast<R*>(cs);
    a.hycs = static_cast<R*>(hycs);
    a.hyhs = static_cast<R*>(hyhs);
    a.cT = cT;
    a.hT = hT;
    a.hcT = hcT;
    a.hhT = hhT;
    a.T = T;
    a.B = B;
    const size_t smem = (size_t)step_smem_floats(D, H, HH, E) * sizeof(float);
    cudaError_t err = set_smem((const void*)hyper_fwd_kernel<W, R>, smem);
    if (err != cudaSuccess) return err;
    hyper_fwd_kernel<W, R>
        <<<B, hyper_threads(H, HH), smem, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// Scratch (float32, any contents): s_dpre, s_dxp, s_dhp, s_dsx, s_dsh
// [T, B, 4H]; s_dhpre [T, B, 4HH]; s_zs, s_dzs [3, T, B, 4e]; s_hhn
// [T, B, HH]; s_part [B, 14H + 4HH + 8e]. Outputs: the matrices' gradients
// as float32 in the matrices' shapes; dvec [14H + 4HH + 8e] = dln_gamma 4H |
// dln_beta 4H | dlnc_gamma H | dlnc_beta H | db 4H | dbh 4HH | db_hz_x 4e |
// db_hz_h 4e; dxb / dxbh null when xb / xbh are.
int srt_hyper_bwd(const float* xs, const float* xb, const float* xbh,
                  const void* wx, const float* b, const void* wh,
                  const void* wxh_x, const void* wxh_h, const float* bh,
                  const void* whh, const void* w_hz_x, const float* b_hz_x,
                  const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
                  const float* zd_x, const float* zd_h, const float* zd_b,
                  const float* ln_gamma, const float* ln_beta,
                  const float* lnc_gamma, const float* lnc_beta,
                  const float* h0, const float* hh0, const void* hs,
                  const void* cs, const void* hycs, const void* hyhs,
                  const void* dhs, const float* dcT, const float* dhT,
                  const float* dhcT, const float* dhhT, const float* masks,
                  const int* seed, int T, int B, int D, int H, int HH, int E,
                  int w_bf16, int r_bf16, float keep, float inv_keep,
                  float forget_bias, float* s_dpre, float* s_dxp,
                  float* s_dhp, float* s_dsx, float* s_dsh, float* s_dhpre,
                  float* s_zs, float* s_dzs, float* s_hhn, float* s_part,
                  float* dxs, float* dxb, float* dxbh, float* dwx, float* dwh,
                  float* dwxh_x, float* dwxh_h, float* dwhh, float* dw_hz_x,
                  float* dw_hz_h, float* dw_hz_b, float* dzd_x, float* dzd_h,
                  float* dzd_b, float* dvec, float* dc0, float* dh0,
                  float* dhc0, float* dhh0, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    using W = decltype(w);
    using R = decltype(r);
    HyperBwd<W, R> a;
    a.p = make_hyper_cell<W>(wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
                             w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b,
                             ln_gamma, ln_beta, lnc_gamma, lnc_beta, xb, xbh,
                             D, H, HH, E, forget_bias);
    a.xs = xs;
    a.h0 = h0;
    a.hh0 = hh0;
    a.hs = static_cast<const R*>(hs);
    a.cs = static_cast<const R*>(cs);
    a.hycs = static_cast<const R*>(hycs);
    a.hyhs = static_cast<const R*>(hyhs);
    a.dhs = static_cast<const R*>(dhs);
    a.dcT = dcT;
    a.dhT = dhT;
    a.dhcT = dhcT;
    a.dhhT = dhhT;
    a.drop = make_dropout(masks, seed, keep, inv_keep);
    a.dpre = s_dpre;
    a.dxp = s_dxp;
    a.dhp = s_dhp;
    a.dsx = s_dsx;
    a.dsh = s_dsh;
    a.dhpre = s_dhpre;
    a.zs = s_zs;
    a.dzs = s_dzs;
    a.hhn = s_hhn;
    a.part = s_part;
    a.dxs = dxs;
    a.dxb = dxb;
    a.dxbh = dxbh;
    a.dc0 = dc0;
    a.dh0 = dh0;
    a.dhc0 = dhc0;
    a.dhh0 = dhh0;
    a.T = T;
    a.B = B;
    HyperMatGrads d;
    d.wx = dwx;
    d.wh = dwh;
    d.wxh_x = dwxh_x;
    d.wxh_h = dwxh_h;
    d.whh = dwhh;
    d.w_hz[0] = dw_hz_x;
    d.w_hz[1] = dw_hz_h;
    d.w_hz[2] = dw_hz_b;
    d.zd[0] = dzd_x;
    d.zd[1] = dzd_h;
    d.zd[2] = dzd_b;
    return launch_hyper_bwd(a, d, dvec, (cudaStream_t)stream);
  });
}

}  // extern "C"
