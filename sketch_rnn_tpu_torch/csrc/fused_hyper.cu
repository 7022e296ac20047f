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
// Design of the forward (srt_hyper_fwd): one persistent kernel launched
// cooperatively on a grid of slices x batch tiles (cuda_fused.hyper_fwd_
// plan: slices of U = 16 main units, or 8 where two tiles cannot be had,
// as many slices of the auxiliary units, at most one block per SM), refused,
// never replaced, when it cannot co-reside; a batch whose tiles do not fit
// runs in windows of rows (persist.cuh). Block (tile, slice) keeps its
// slice's LayerNorm phases for its tile's rows (row 5f's lanes, moments and
// Chan's rule) and, regrouped by the split F = U / 8, a product group of at
// most 8 main and 8 auxiliary units (all four gates of each) for the rows
// of F tiles, their weight columns resident in shared memory as float: at
// float the wh, wxh_h and whh columns of a whole slice (16 main, 8
// auxiliary units) need 229 KB, beside zd and the rows no room. Per step,
// five phases, each ended by a grid barrier:
//  (1) the products of the group's rows, h_{t-1} and hh_{t-1} staged from
//      the exchanges hx, hhx [2, B, H | HH] of the weight type
//      (cp.async.cg), a pass of rows at a time: hp = h @ wh of its main
//      units to a [B, 4H] exchange, ((x @ wxh_x + h @ wxh_h) + bh) + hh @
//      whh [+ xbh] of its auxiliary units, the auxiliary LSTM's gates (no
//      dropout), hh_t
//      rounded to W into hhx, hycs and hyhs; the auxiliary cell carries
//      stay in the block;
//  (2) z = hh_t @ w_hz (+ b_hz): each output summed by the block that owns
//      it (whole sectors of the row, as the backward's dz share) for its
//      tile's rows, into a [B, 12e] exchange; its w_hz columns and the rows
//      of hh_t staged (read through L1, the columns missed: at 227 KB of
//      shared memory the L1 left does not hold them);
//  (3) xp = x @ wx [+ x_bias], the block scales s_p[g] = z_p[g] . zd_p[g]
//      (zd columns resident, float x float at either W) and pre = ((s_x xp
//      + s_h hp) + s_b) + b of the block's (row, unit) pairs, the gates'
//      slice moments to an exchange [B, slices, 8];
//  (4) the gate norms (the slices' moments in slice order), the gate block
//      with the dropout mask on g, the new cell state's slice moments to an
//      exchange [B, slices, 2];
//  (5) the cell norm, h_t rounded to W into hx, hs and cs.
// The products of (1) at float weights: a task of 4 units x 16 rows a warp
// (two rows and one unit's four gates a lane, SIMT multiply-adds from the
// resident quads). At bf16 weights on the tensor cores (mma.sync m16n8k8 in
// tf32, which holds a bf16 value exactly: every product exact, float sums
// in the unit's order); 3xTF32 at float was slower than the multiply-adds
// and missed float's tolerance at H=512. Every other output, and every
// float product, is one in-order fmaf chain in hyper_step's k order; the
// sums are combined in hyper_step's order, each rounded on its own (_rn);
// no atomics: every run gives the same bits. The layer norms' row moments
// are summed in another order than block_sum's, so it meets the row-block
// design and the plain version within tolerance, not bit for bit. Sizing
// at the hyper preset (B=100, H=512, HH=256, e=32): 32 slices x 4 tiles =
// 128 blocks, product groups of 8 main and 4 auxiliary units x 50 rows in
// passes of 25, 229,504 bytes of shared memory a block (the weight columns
// 116,096, zd 27,648, the rows buffer 77,600); the work scratch 1,920,000
// bytes and the exchanges 614,400 bytes at float; 1,250 grid barriers a
// call.
// The design it replaced, one block per batch row (hyper_fwd_kernel,
// blockDim = max(H, HH) rounded up to a warp; the four phases of hyper_step
// behind __syncthreads(), the layer norms' statistics block-wide), stays
// reachable as srt_hyper_fwd_rowblock, to be held and timed beside it: each
// row's block re-read about 8 MiB of weights from L2 on every step, and only
// 100 of 132 SMs held a row. The backward ran the same design until it was
// redesigned below; it stays reachable as srt_hyper_bwd_rowblock (one
// block per row walking time backwards, the gradient streams to scratch,
// then tn_gemm_kernel's eleven products), to be held and timed beside the
// new one.
//
// Design of the backward (srt_hyper_bwd): six stages over a stream scratch
// (carve_streams), a work scratch (hyper_work_floats) and the products'
// partials, all float, the wrapper's (cuda_fused.hyper_scratch_bytes).
//  1. The hoisted recompute. The backward reads h_{t-1}, hh_{t-1} and the
//     pre-step auxiliary cell state from the stored hs, hyhs and hycs, so
//     everything before the gate block depends on nothing the loop
//     computes: tiled products over all M = T*B row-steps (recompute.cuh,
//     mma.sync at bf16 for the W-typed matrices, SIMT float at f32, no
//     TF32), in hyper_step's sum order: hyper_pre = ((x @ wxh_x + h @
//     wxh_h) + bh) + hh @ whh [+ xbh] (two products, the second adding to
//     the first's output), then the auxiliary gates into hhn = rnd_W(hh_new)
//     [M, HH], z_p = hhn @ w_hz_p (+ b_hz_p) into zs [M, 12e], xp = x @ wx
//     [+ x_bias] and hp = h @ wh into their streams, the block scales s_x,
//     s_h (float x float at either W, K = e) into sx, sh and pre = ((s_x *
//     xp + s_h * hp) + s_b) + b into pre [M, 4H].
//  2. The LN statistics of pre (ln_loop.cuh's ln_stats_kernel, row 5b's:
//     each row-step's gate and cell norms' mean and rsqrt in the row-block
//     design's sum order) into a [M, 10] scratch.
//  3. The serial loop: one persistent kernel launched cooperatively on a
//     grid of slices x batch tiles (cuda_fused.hyper_bwd_plan: U = 16 or 8
//     main units a slice, as many slices of the auxiliary units, at most
//     one block per SM), refused, never replaced, when it cannot
//     co-reside; a batch whose tiles do not fit runs in windows of rows
//     (persist.cuh). The LN phases and (d1), (d2) work on the block's
//     slice and tile; the transposed products (e) on the same blocks
//     regrouped by the plan's split F: block (tile, slice) takes U / F
//     units of its slice (main and auxiliary) for the rows of the F tiles
//     of its tile's group, so that their weight rows fit beside the rest
//     (at float the wh and wxh_h rows of 16 units alone are 192 KiB).
//     Each block keeps resident in shared memory, as float, the wh, wxh_h
//     and whh rows of its (e) units, the w_hz rows of its (d2) auxiliary
//     units and the zd columns of its LN units, and the dh, dhh, dhc and
//     dh_pre sums of its pairs. Per step s, six grid barriers:
//     (a)-(c) row 5b's LayerNorm gate backward (ln_loop.cuh, the same
//         exchanges and slice-order sums) gives d_pre; HyperEmit writes it
//         over pre and dxp = d_pre s_x over sx, dhp = d_pre s_h over sh,
//         dsx = d_pre xp over xp, dsh = d_pre hp over hp, adds d_pre to
//         the row's db partial and dxp to its x_bias sum, and per pass of
//         rows writes each row's 12e partials of dz over the block's units
//         (u in order) to an exchange exz [B, slices, 12e];
//     (d1) each output of dz summed over the slices in slice order, by
//         the block that owns it (dz_share: whole 8-float chunks), into
//         the dz stream [M, 12e] and the b_hz partials;
//     (d2) the auxiliary LSTM's backward of the block's (row, unit)
//         pairs: dhh = its carried dhh + rnd_W(dz) . w_hz[k] (the tile's dz
//         rows staged through shared memory, a warp a row), the gates
//         recomputed from hyper_pre and hycs, dh_pre written over
//         hyper_pre;
//     (e) the transposed products of the block's (e) units and rows
//         (hyper_dh): dh_{s-1} = rnd_W(dhp) @ wh^T + rnd_W(dh_pre) @
//         wxh_h^T over column parts, dhh_{s-1} = rnd_W(dh_pre) @ whh^T,
//         the parts added in part order into the exchanges dhx [B, H] and
//         dhhx [B, HH] (dh0, dhh0 after the last step), from which the
//         pairs' owners read them at the next step.
//     Streams and exchanges written by other blocks are read through L2
//     (ld.global.cg): an L1 line could be stale.
//  4. dxs = rnd_W(dxp) @ wx^T + rnd_W(dh_pre) @ wxh_x^T, one warp a
//     row-step: no recurrence, so a launch of its own over the whole card
//     (inside the loop it would run on the loop's 128 blocks and their
//     shared memory limits, and its time would not show in the split).
//  5. The eleven matrix gradients on weight_grad.cuh's split-K pass, one
//     after another over one partials scratch: [x]^T dxp, [h_prev]^T dhp,
//     [x; h_prev; hh_prev]^T dh_pre (h_prev, hh_prev gathered from the
//     stored residuals in place), hhn^T dz_p (three), rounded to W; z_p[g]^T
//     ds_p[g] (twelve blocks), float x float at either W.
//  6. The row sums of the [B, 14H + 4HH + 8e] partials (sum_rows_kernel).
// Every sum has a fixed order and no atomics, so every run gives the same
// bits; the order differs from the row-block design's and the plain
// version's, which it meets within tolerance. Sizing at the hyper preset
// (B=100, T=250, D=5, H=512, HH=256, e=32): 32 slices of 16 units x 4
// tiles = 128 blocks, split 2 (8 units x 50 rows for the products), each
// 194,624 bytes of shared memory (wh 65,536, wxh_h 32,768, whh 16,384,
// w_hz 12,288, zd 24,576, the exchange and ds staging 28,672, the pairs'
// sums 14,400); scratch 1,289,680,448 bytes (the streams 1.23 GB, the work
// 10.5 MB, the largest product's partials 50.3 MB); 1,499 grid barriers a
// call. L2 reads a loop step: the transposed products read each dhp and
// dh_pre row once per group of units, 78.6 MB at 64 groups; the
// exchanges and dz rows about 19 MB.
// Bound on the H100 at that shape: the forward's products are 4.29 MFLOP
// per row-step, 107.3 GFLOP in all, SIMT float multiply-adds at 67 TFLOP/s:
// 1.60 ms; the backward's about three times that (recompute, transposed
// products, weight gradients): 4.80 ms at float, 0.74 ms at bf16 (the W
// products on the tensor cores, the zd products float), by operations.
// PERF.md keeps the measured times and the split by stage.

#include <cooperative_groups.h>

#include "ln_loop.cuh"
#include "lstm_loops.cuh"
#include "persist.cuh"
#include "recompute.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

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
cudaError_t launch_hyper_bwd_rowblock(const HyperBwd<W, R>& a,
                                      const HyperMatGrads& d, float* dvec,
                                      cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// The backward of srt_hyper_bwd (header, "Design of the backward"): six
// stages over one stream scratch and one work scratch.

// The operands every stage reads, beside the main cell's Bwd view (wx, wh,
// the LN parameters, xs, h0, hs, cs, dhs, dcT, dhT, the dropout, the pre
// stream as Bwd::dpre, dxs, dxb, dc0, dh0, the row partials as Bwd::part).
template <typename W, typename R>
struct HyperArgs {
  const W* wxh_x;        // [D, 4HH]
  const W* wxh_h;        // [H, 4HH]
  const float* bh;       // [4HH]
  const W* whh;          // [HH, 4HH]
  const W* w_hz[3];      // [HH, 4e]
  const float* b_hz[2];  // [4e]
  const float* zd[3];    // [4, e, H]
  const float* b;        // [4H]
  const float* xb;       // [B, 4H] or null
  const float* xbh;      // [B, 4HH] or null
  const float* hh0;      // [B, HH]
  const R* hycs;         // [T, B, HH]
  const R* hyhs;         // [T, B, HH]
  const float* dhcT;     // [B, HH]
  const float* dhhT;     // [B, HH]
  // the streams, one row per row-step m = t * B + b (HyperStreams)
  float *pre, *xp, *hp, *sx, *sh;  // [M, 4H]; over them d_pre, dsx, dsh,
                                   // dxp, dhp
  float* hpre;                     // [M, 4HH]; over it dh_pre
  float* zs;                       // [M, 12e] z_x | z_h | z_b
  float* dz;                       // [M, 12e] their gradients
  float* hhn;                      // [M, HH] hyper_h, rounded to W
  float* exz;                      // [B, slices, 12e] dz's slice partials
  float *dhx, *dhhx;               // [B, H], [B, HH] the loop's dh, dhh
  float* dxbh;                     // [B, 4HH] or null
  float *dhc0, *dhh0;              // [B, HH]
  int HH, E, P;                    // P: the row partials' stride
};

// The stream scratch, carved in this order: pre, xp, hp, sx, sh [M, 4H];
// hpre [M, 4HH]; zs, dz [M, 12e]; hhn [M, HH] (cuda_fused.hyper_stream_
// floats). Every region starts 16-byte aligned.
size_t hyper_stream_floats(int T, int B, int H, int HH, int E) {
  return (size_t)T * B * (5 * 4 * H + 4 * HH + 2 * 12 * E + HH);
}

template <typename W, typename R>
void carve_streams(HyperArgs<W, R>& h, float* s, int T, int B, int H) {
  const size_t M = (size_t)T * B, G = 4 * (size_t)H;
  h.pre = s;
  h.xp = h.pre + M * G;
  h.hp = h.xp + M * G;
  h.sx = h.hp + M * G;
  h.sh = h.sx + M * G;
  h.hpre = h.sh + M * G;
  h.zs = h.hpre + M * 4 * h.HH;
  h.dz = h.zs + M * 12 * h.E;
  h.hhn = h.dz + M * 12 * h.E;
}

// The work scratch, carved in this order: the row partials [B, P] (padded
// to 16 bytes), the LN loop's work (ln_work: exb, exa, stats, dxh), exz
// [B, slices, 12e], dhx [B, H], dhhx [B, HH] (cuda_fused.hyper_work_
// floats).
size_t hyper_work_floats(int T, int B, int H, int HH, int E, int slices) {
  const size_t P = 14 * (size_t)H + 4 * HH + 8 * E;
  return ((size_t)B * P + 3) / 4 * 4 + (size_t)B * slices * 10 +
         (size_t)T * B * kLnStats + 4 * (size_t)B * H +
         (size_t)B * slices * 12 * E + (size_t)B * (H + HH);
}

// 1. The hoisted recompute (recompute.cuh's tiled products), in
// hyper_step's sum order: hyper_pre = ((x @ wxh_x + h @ wxh_h) + bh) + hh
// @ whh [+ xbh] as two products (AuxH, then AuxHH adding to it), the
// auxiliary gates (hyper_gates_kernel) giving hhn, z (ZOp, the three paths
// as the batch index), xp and hp (HpOp), then the block scales of the
// three paths (ScaleOp<P>, the four gates as the batch index; float x
// float at either W), the last giving pre = ((s_x * xp + s_h * hp) + s_b)
// + b.
template <typename W, typename R>
struct AuxHOp {
  Bwd<W, R> a;
  HyperArgs<W, R> h;
  __device__ int M() const { return a.T * a.B; }
  __device__ int K() const { return a.p.H; }
  __device__ int N() const { return 4 * h.HH; }
  __device__ int ldb() const { return 4 * h.HH; }
  __device__ const W* b(int) const { return h.wxh_h; }
  __device__ float val(int, int m, int k) const {
    return prev_row<W, R>(a.h0, a.hs, a.B, a.p.H, m, k);
  }
  __device__ bool a16_ok() const { return prev_row16_ok(a.hs, a.p.H); }
  __device__ const bf16* a16(int, int m, int k) const {
    return prev_row16(a.hs, a.B, a.p.H, M(), m, k);
  }
  __device__ void out(int, int m, int n, float ah) const {
    const int GH = 4 * h.HH, D = a.p.D;
    const float* x = a.xs + (size_t)m * D;
    float ax = 0.0f;
    for (int q = 0; q < D; ++q)
      ax = fmaf(rnd<W>(x[q]), to_f(h.wxh_x[(size_t)q * GH + n]), ax);
    h.hpre[(size_t)m * GH + n] = (ax + ah) + h.bh[n];
  }
};

template <typename W, typename R>
struct AuxHHOp {
  Bwd<W, R> a;
  HyperArgs<W, R> h;
  __device__ int M() const { return a.T * a.B; }
  __device__ int K() const { return h.HH; }
  __device__ int N() const { return 4 * h.HH; }
  __device__ int ldb() const { return 4 * h.HH; }
  __device__ const W* b(int) const { return h.whh; }
  __device__ float val(int, int m, int k) const {
    return prev_row<W, R>(h.hh0, h.hyhs, a.B, h.HH, m, k);
  }
  __device__ bool a16_ok() const { return prev_row16_ok(h.hyhs, h.HH); }
  __device__ const bf16* a16(int, int m, int k) const {
    return prev_row16(h.hyhs, a.B, h.HH, M(), m, k);
  }
  __device__ void out(int, int m, int n, float ar) const {
    const int GH = 4 * h.HH;
    float* o = h.hpre + (size_t)m * GH + n;
    float v = *o + ar;
    if (h.xbh != nullptr) v = v + h.xbh[(size_t)(m % a.B) * GH + n];
    *o = v;
  }
};

// hyper_h of every row-step from hyper_pre and the stored pre-step
// auxiliary cell state (no dropout), rounded to W: the left operand of z
// and of the w_hz gradients
template <typename W, typename R>
__global__ void hyper_gates_kernel(HyperArgs<W, R> h, int M, float fb) {
  const int HH = h.HH;
  const size_t n = (size_t)M * HH;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / HH, k = i % HH;
    const float* hp = h.hpre + m * 4 * HH + k;
    const float hi = sigmoidf_(hp[0]), hg = tanhf(hp[HH]);
    const float hf = sigmoidf_(hp[2 * HH] + fb), ho = sigmoidf_(hp[3 * HH]);
    const float nhc = to_f(h.hycs[i]) * hf + hi * hg;
    h.hhn[i] = rnd<W>(tanhf(nhc) * ho);
  }
}

template <typename W, typename R>
struct ZOp {
  Bwd<W, R> a;
  HyperArgs<W, R> h;
  __device__ int M() const { return a.T * a.B; }
  __device__ int K() const { return h.HH; }
  __device__ int N() const { return 4 * h.E; }
  __device__ int ldb() const { return 4 * h.E; }
  __device__ const W* b(int z) const { return h.w_hz[z]; }
  __device__ float val(int, int m, int k) const {
    return h.hhn[(size_t)m * h.HH + k];
  }
  __device__ bool a16_ok() const { return false; }
  __device__ const bf16* a16(int, int, int) const { return nullptr; }
  __device__ void out(int z, int m, int n, float acc) const {
    if (z < 2) acc = acc + h.b_hz[z][n];
    h.zs[(size_t)m * 12 * h.E + z * 4 * h.E + n] = acc;
  }
};

template <typename W, typename R>
struct HpOp {
  Bwd<W, R> a;
  HyperArgs<W, R> h;
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
  __device__ void out(int, int m, int n, float hp) const {
    const int G = 4 * a.p.H, D = a.p.D;
    const float* x = a.xs + (size_t)m * D;
    float xp = 0.0f;
    for (int q = 0; q < D; ++q)
      xp = fmaf(rnd<W>(x[q]), to_f(a.p.wx[(size_t)q * G + n]), xp);
    if (h.xb != nullptr) xp = xp + h.xb[(size_t)(m % a.B) * G + n];
    h.xp[(size_t)m * G + n] = xp;
    h.hp[(size_t)m * G + n] = hp;
  }
};

// path P's block scale s_P[m, g * H + j] = z_P[m, g * e : g * e + e] .
// zd_P[g][:, j], gate g the batch index
template <int P, typename W, typename R>
struct ScaleOp {
  Bwd<W, R> a;
  HyperArgs<W, R> h;
  __device__ int M() const { return a.T * a.B; }
  __device__ int K() const { return h.E; }
  __device__ int N() const { return a.p.H; }
  __device__ int ldb() const { return a.p.H; }
  __device__ const float* b(int g) const {
    return h.zd[P] + (size_t)g * h.E * a.p.H;
  }
  __device__ float val(int g, int m, int q) const {
    return h.zs[(size_t)m * 12 * h.E + (P * 4 + g) * h.E + q];
  }
  __device__ bool a16_ok() const { return false; }
  __device__ const bf16* a16(int, int, int) const { return nullptr; }
  __device__ void out(int g, int m, int j, float s) const {
    const size_t at = (size_t)m * 4 * a.p.H + g * a.p.H + j;
    if (P == 0) {
      h.sx[at] = s;
    } else if (P == 1) {
      h.sh[at] = s;
    } else {
      h.pre[at] = ((h.sx[at] * h.xp[at] + h.sh[at] * h.hp[at]) + s) +
                  h.b[g * a.p.H + j];
    }
  }
};

template <typename W, typename R>
cudaError_t launch_hyper_recompute(const Bwd<W, R>& a,
                                   const HyperArgs<W, R>& h,
                                   cudaStream_t stream) {
  const int M = a.T * a.B, H = a.p.H, HH = h.HH, E = h.E;
  if (M == 0) return cudaSuccess;
  cudaError_t err = launch_product_grid<W>(AuxHOp<W, R>{a, h}, M, 4 * HH, 1,
                                           stream);
  if (err == cudaSuccess)
    err = launch_product_grid<W>(AuxHHOp<W, R>{a, h}, M, 4 * HH, 1, stream);
  if (err == cudaSuccess) {
    const size_t n = (size_t)M * HH;
    const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
    hyper_gates_kernel<W, R><<<blocks, 256, 0, stream>>>(h, M,
                                                         a.p.forget_bias);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_product_grid<W>(ZOp<W, R>{a, h}, M, 4 * E, 3, stream);
  if (err == cudaSuccess)
    err = launch_product_grid<W>(HpOp<W, R>{a, h}, M, 4 * H, 1, stream);
  if (err == cudaSuccess)
    err = launch_product_grid<float>(ScaleOp<0, W, R>{a, h}, M, H, 4, stream);
  if (err == cudaSuccess)
    err = launch_product_grid<float>(ScaleOp<1, W, R>{a, h}, M, H, 4, stream);
  if (err == cudaSuccess)
    err = launch_product_grid<float>(ScaleOp<2, W, R>{a, h}, M, H, 4, stream);
  return err;
}

// 3. The serial loop's plan (cuda_fused.hyper_bwd_plan): U main units a
// slice of the LN phases (16 or 8; the auxiliary units in as many
// slices), at most `tiles` batch tiles a window, `windows` windows of
// rows, the transposed products' split F (each block's weight rows are
// those of U / F units, for the rows of F tiles), `parts` column parts of
// the main transposed product, `smem` bytes of shared memory a block.
struct HyperPlan {
  int units, split, slices, tiles, windows, parts, smem;
};

constexpr int kDzChunk = 64;  // (d1)'s slice partials in flight a thread
constexpr int kStage = 16;    // 16-byte loads in flight a thread (stage_rows)

// n float4 of rows written by other blocks of the kernel (from src on)
// into shared memory: one coalesced copy through L2 by the whole block,
// kStage loads in flight a thread. A __syncthreads must follow.
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src,
                                           int n) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kStage * kLoopThreads) {
    float4 v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i)
      if (e0 + i * kLoopThreads < n) v[i] = __ldcg(src + e0 + i * kLoopThreads);
#pragma unroll
    for (int i = 0; i < kStage; ++i)
      if (e0 + i * kLoopThreads < n) dst[e0 + i * kLoopThreads] = v[i];
  }
}

// The outputs of dz a slice owns in (d1): whole chunks of 8 floats (4
// where 12e is not a multiple of 8), so that every 32-byte sector of a dz
// row is written by one block (a sector written in parts by two SMs is
// filled from memory when it is read).
__host__ __device__ inline void dz_share(int Z, int slices, int sl, int& lo,
                                         int& hi) {
  const int zc = Z % 8 == 0 ? 8 : 4, nc = Z / zc;
  lo = sl * nc / slices * zc;
  hi = (sl + 1) * nc / slices * zc;
}
// The floats of a block's shared region that phases (b) and (c) use (a
// pass's rows of an exchange, its ds values) and (d2) reuses for dz rows.
__host__ __device__ inline int hyper_free_floats(int U, int slices) {
  const int rows = kLoopThreads / U;
  return rows * slices * 8 + rows * 12 * U;
}

// A block's shared memory in floats for LN tiles of nb rows
// (cuda_fused.hyper_bwd_smem, the same sum): the resident rows wh and
// wxh_h of its U / F transposed-product units [U/F][4H], [U/F][4HH], whh
// of its auxiliary ones [UAe][4HH], w_hz of its (d2) auxiliary units
// [UA][12e], the zd columns of its LN units [12][U][e], the free region,
// the LN pairs' dh and the (d2) pairs' dhh [nb][U] each, the transposed
// products' parts [parts][F nb][U/F] and auxiliary sums [F nb][U/F], the
// (d2) pairs' dhc, dh_pre sums and dz . w_hz [nb][UA][6].
__host__ __device__ inline size_t hyper_smem_floats(int U, int F, int slices,
                                                    int nb, int H, int HH,
                                                    int E, int parts) {
  const int UE = U / F, se = slices * F;
  const int UA = (HH + slices - 1) / slices, UAe = (HH + se - 1) / se;
  const size_t enb = (size_t)F * nb;
  return (size_t)UE * 4 * H + (size_t)UE * 4 * HH + (size_t)UAe * 4 * HH +
         (size_t)UA * 12 * E + (size_t)12 * U * E +
         hyper_free_floats(U, slices) + 2 * (size_t)nb * U +
         (size_t)parts * enb * UE + enb * UE + (size_t)nb * UA * 6;
}

// Phase (c)'s Emit for the HyperLSTM: pre = s_x * xp + s_h * hp + s_b + b,
// so beside d_pre (= ds_b, written over pre) the pair writes dxp = d_pre *
// s_x over sx, dhp = d_pre * s_h over sh, dsx = d_pre * xp over xp, dsh =
// d_pre * hp over hp; adds d_pre to its db partial and dxp to its x_bias
// sum; and stages dsx, dsh and d_pre in shared memory ([rows][path][gate]
// [U]). After each pass, each of the pass's rows gets its 12e partials of
// dz over the block's units (dz_p[g e + q] = sum_u ds_p[g][u] zd_p[g][q][j0
// + u], u in order) into exz[row][slice].
template <int U>
struct HyperEmit {
  float *sx, *sh, *xp, *hp, *dxb, *dbp0, *s_ds, *exz;
  const float* s_zd;
  int H, E, P, slices, sl, b0, u;
  size_t off = 0;
  float* xbp = nullptr;
  float* dbp = nullptr;
  float vsx[4], vsh[4], vxp[4], vhp[4], xbs[4], dbs[4];
  __device__ __forceinline__ void at(size_t m, int row, int j) {
    off = m * 4 * H + j;
    xbp = dxb != nullptr ? dxb + (size_t)row * 4 * H + j : nullptr;
    dbp = dbp0 + (size_t)row * P + j;
  }
  __device__ __forceinline__ void load(int g) {
    const size_t o = off + (size_t)g * H;
    vsx[g] = sx[o];
    vsh[g] = sh[o];
    vxp[g] = xp[o];
    vhp[g] = hp[o];
    xbs[g] = xbp != nullptr ? xbp[g * H] : 0.0f;
    dbs[g] = dbp[g * H];
  }
  __device__ __forceinline__ void put(int g, float dp, int lr) {
    const size_t o = off + (size_t)g * H;
    const float dxp = dp * vsx[g], dhp = dp * vsh[g];
    const float dsx = dp * vxp[g], dsh = dp * vhp[g];
    sx[o] = dxp;
    sh[o] = dhp;
    xp[o] = dsx;
    hp[o] = dsh;
    if (xbp != nullptr) xbp[g * H] = xbs[g] + dxp;
    dbp[g * H] = dbs[g] + dp;
    float* d = s_ds + (size_t)lr * 12 * U + g * U + u;
    d[0] = dsx;
    d[4 * U] = dsh;
    d[8 * U] = dp;
  }
  __device__ __forceinline__ void pass_done(int bl0, int nr) {
    const int Z = 12 * E;
    for (int c = threadIdx.x; c < Z; c += kLoopThreads) {
      const int pg = c / E, q = c - pg * E;
      float zr[U];
#pragma unroll
      for (int k = 0; k < U; ++k) zr[k] = s_zd[((size_t)pg * U + k) * E + q];
      for (int lr = 0; lr < nr; ++lr) {
        const float4* d =
            reinterpret_cast<const float4*>(s_ds + ((size_t)lr * 12 + pg) * U);
        float acc = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < U / 4; ++k4) {
          const float4 v = d[k4];
          acc = fmaf(v.x, zr[4 * k4], acc);
          acc = fmaf(v.y, zr[4 * k4 + 1], acc);
          acc = fmaf(v.z, zr[4 * k4 + 2], acc);
          acc = fmaf(v.w, zr[4 * k4 + 3], acc);
        }
        exz[((size_t)(b0 + bl0 + lr) * slices + sl) * Z + c] = acc;
      }
    }
    __syncthreads();  // s_ds read: the next pass may write it
  }
};

// The transposed products of a step for kLoopThreads / 32 warps: a warp
// task is RG = 32 / U rows x U units over one part of its columns, a quad
// (4 columns) at a time by the lanes in turn, the rows' values read
// through L2 (other blocks wrote them; the next quad's loads in flight
// while this one is multiplied) and rounded to W, the weight rows from
// shared memory; a shuffle reduce-scatter leaves lane l the sum of entry l
// (row l / U, unit l % U). Main tasks (groups x parts): dh_{s-1}[b][k] =
// sum over the quads of [dhp | dh_pre] with [wh | wxh_h] rows k, into
// s_part[part][b][k]; auxiliary tasks (groups): dhh_{s-1}[b][k] = sum over
// dh_pre's quads with whh rows k < UA, into s_pa[b][k].
template <typename W, int U>
__device__ __forceinline__ void hyper_dh(const float* dhp, const float* dhpre,
                                         const float* s_wh, const float* s_wa,
                                         const float* s_whh, float* s_part,
                                         float* s_pa, int H, int HH, int UA,
                                         int nb, int nb_max, int parts) {
  constexpr int RG = 32 / U;
  const int G = 4 * H, GH = 4 * HH, lane = threadIdx.x & 31;
  const int groups = (nb + RG - 1) / RG, nmain = groups * parts;
  for (int task = threadIdx.x >> 5; task < nmain + groups;
       task += kLoopWarps) {
    const bool aux = task >= nmain;
    const int grp = aux ? task - nmain : task / parts;
    const int part = aux ? 0 : task - grp * parts;
    const int nv = nb - grp * RG;  // the task's real rows (may exceed RG)
    float acc[RG * U];
#pragma unroll
    for (int e = 0; e < RG * U; ++e) acc[e] = 0.0f;
    // the quads [q_lo, q_hi) of the rows from rows (stride ld floats) with
    // the weight rows sw (stride ld, nk of them)
    auto quads = [&](const float* rows, const float* sw, int ld, int nk,
                     int q_lo, int q_hi) {
      const float4* r0 =
          reinterpret_cast<const float4*>(rows + (size_t)grp * RG * ld);
      const int ld4 = ld / 4;
      auto fetch = [&](float4 (&x)[RG], int q) {
#pragma unroll
        for (int r = 0; r < RG; ++r)
          x[r] = r < nv && q < q_hi ? __ldcg(r0 + (size_t)r * ld4 + q)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      };
      float4 d[RG];
      fetch(d, q_lo + lane);
      for (int qd = q_lo + lane; qd < q_hi; qd += 32) {
        float4 dn[RG];
        fetch(dn, qd + 32);
#pragma unroll
        for (int r = 0; r < RG; ++r) d[r] = rnd4<W>(d[r]);
#pragma unroll
        for (int k = 0; k < U; ++k) {
          if (k >= nk) break;
          const float4 w = quad(sw + (size_t)k * ld + 4 * qd);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            float v = acc[r * U + k];
            v = fmaf(d[r].x, w.x, v);
            v = fmaf(d[r].y, w.y, v);
            v = fmaf(d[r].z, w.z, v);
            acc[r * U + k] = fmaf(d[r].w, w.w, v);
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) d[r] = dn[r];
      }
    };
    if (aux) {
      quads(dhpre, s_whh, GH, UA, 0, HH);
    } else {
      const int nq = H + HH;  // [dhp quads | dh_pre quads]
      const int lo = part * nq / parts, hi = (part + 1) * nq / parts;
      if (lo < H) quads(dhp, s_wh, G, U, lo, hi < H ? hi : H);
      if (hi > H) quads(dhpre, s_wa, GH, U, (lo > H ? lo : H) - H, hi - H);
    }
    rs_stage<16, 16>(acc, lane);
    rs_stage<8, 8>(acc, lane);
    rs_stage<4, 4>(acc, lane);
    rs_stage<2, 2>(acc, lane);
    rs_stage<1, 1>(acc, lane);
    const int bl = grp * RG + lane / U, k = lane % U;
    if (bl < nb)
      (aux ? s_pa + (size_t)bl * U + k
           : s_part + ((size_t)part * nb_max + bl) * U + k)[0] = acc[0];
  }
}

// The loop, one persistent cooperative kernel on the plan's grid. Block
// (tile, slice) owns, for the LN phases and (d1), (d2), the main units
// j0 .. j0 + nu - 1 and the auxiliary units k0 .. k0 + na - 1 of its slice
// for the rows of its tile; for the transposed products (e) the units of
// group ge = slice * F + tile % F (U / F of them, main and auxiliary) for
// the rows of the F tiles from F (tile / F) on. Per step s (six grid
// barriers): the dh and dhh of its pairs from the exchanges dhx, dhhx
// (dhT, dhhT before the first step); (a), (b), (c) the LN gate block
// (ln_loop.cuh) with HyperEmit; (d1) dz of the tile's rows, the slices'
// partials summed in slice order by the block owning each output (a share
// of the 12e), into dz and the b_hz partials; (d2) the auxiliary LSTM's
// backward of the block's (row, auxiliary unit) pairs: dhh = its carried
// dhh + rnd_W(dz) . w_hz[k], dh_pre written over hyper_pre; (e) the
// transposed products of its group (hyper_dh), the parts added in part
// order into dhx and dhhx (dh0 and dhh0 after the last step). Streams and
// exchanges written by other blocks are read through L2.
template <typename W, typename R, int U, int F>
__global__ void __launch_bounds__(kLoopThreads)
hyper_bwd_loop_kernel(Bwd<W, R> a, HyperArgs<W, R> h, LnWork w, int slices,
                      int tiles, int parts, int r0, int nr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = kLoopThreads / U, UE = U / F;
  const Cell<W>& p = a.p;
  const int H = p.H, HH = h.HH, E = h.E, G = 4 * H, GH = 4 * HH;
  const int Z = 12 * E, E4 = 4 * E, B = a.B, P = h.P, tid = threadIdx.x;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int k0 = sl * HH / slices, na = (sl + 1) * HH / slices - k0;
  const int UA = (HH + slices - 1) / slices;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  const int nb_max = (nr + tiles - 1) / tiles;
  // the transposed products' group: units and rows
  const int se = slices * F, ge = sl * F + bt % F, te = bt / F;
  const int ej0 = ge * H / se, enu = (ge + 1) * H / se - ej0;
  const int ek0 = ge * HH / se, ena = (ge + 1) * HH / se - ek0;
  const int UAe = (HH + se - 1) / se;
  const int eb0 = r0 + te * F * nr / tiles;
  const int enb = (te * F + F) * nr / tiles - te * F * nr / tiles;
  const int enb_max = F * nb_max;
  int o_lo, o_hi;  // the dz outputs this block sums in (d1)
  dz_share(Z, slices, sl, o_lo, o_hi);
  const int nz = o_hi - o_lo;
  float* s_wh = reinterpret_cast<float*>(smem_raw);  // [UE][4H]
  float* s_wa = s_wh + UE * G;                       // [UE][4HH] wxh_h
  float* s_whh = s_wa + UE * GH;                     // [UAe][4HH]
  float* s_whz = s_whh + UAe * GH;                   // [UA][12e]
  float* s_zd = s_whz + UA * Z;                      // [12][U][e]
  float* s_ex = s_zd + 12 * U * E;                   // [kRows][slices][8]
  float* s_ds = s_ex + kRows * slices * 8;           // [kRows][12][U]
  float* s_part = s_ds + kRows * 12 * U;             // [nb_max][U] dh
  const int zrows = hyper_free_floats(U, slices) / Z;  // dz rows a chunk
  float* s_pa = s_part + nb_max * U;                 // [nb_max][U] dhh
  float* s_ep = s_pa + nb_max * U;                   // [parts][enb_max][UE]
  float* s_epa = s_ep + parts * enb_max * UE;        // [enb_max][UE]
  float* s_dhc = s_epa + enb_max * UE;               // [nb_max][UA]
  float* s_xbh = s_dhc + nb_max * UA;                // [nb_max][UA][4]
  float* s_dhz = s_xbh + nb_max * UA * 4;            // [nb_max][UA]
  const LnCtx<U> c = ln_ctx<U>(a, s_part, s_ex, slices, sl, j0, nu, b0,
                               nb, nb_max, 1, P);

  for (int e = tid; e < UE * G; e += kLoopThreads) {
    const int k = e / G, cc = e - k * G;
    s_wh[e] = k < enu ? to_f(p.wh[(size_t)(ej0 + k) * G + cc]) : 0.0f;
  }
  for (int e = tid; e < UE * GH; e += kLoopThreads) {
    const int k = e / GH, cc = e - k * GH;
    s_wa[e] = k < enu ? to_f(h.wxh_h[(size_t)(ej0 + k) * GH + cc]) : 0.0f;
  }
  for (int e = tid; e < UAe * GH; e += kLoopThreads) {
    const int k = e / GH, cc = e - k * GH;
    s_whh[e] = k < ena ? to_f(h.whh[(size_t)(ek0 + k) * GH + cc]) : 0.0f;
  }
  for (int e = tid; e < UA * Z; e += kLoopThreads) {
    const int k = e / Z, o = e - k * Z, path = o / E4;
    s_whz[e] = k < na ? to_f(h.w_hz[path][(size_t)(k0 + k) * E4 + o - path * E4])
                      : 0.0f;
  }
  for (int e = tid; e < 12 * U * E; e += kLoopThreads) {
    const int pg = e / (U * E), u = (e / E) % U, q = e % E;
    s_zd[e] = u < nu ? h.zd[pg / 4][((size_t)(pg % 4) * E + q) * H + j0 + u]
                     : 0.0f;
  }
  for (int e = tid; e < kRows * 12 * U; e += kLoopThreads) s_ds[e] = 0.0f;
  ln_init(a, c, nb_max);
  for (int q = tid; q < nb * U; q += kLoopThreads) {  // the db partials
    if (!c.unit) continue;
    float* pr = a.part + (size_t)(b0 + q / U) * P + 10 * H + c.j;
#pragma unroll
    for (int g = 0; g < 4; ++g) pr[g * H] = 0.0f;
  }
  for (int e = tid; e < nb_max * U; e += kLoopThreads) {
    const int bl = e / U, k = e % U;
    s_pa[e] = (bl < nb && k < na && h.dhhT != nullptr)
                  ? h.dhhT[(size_t)(b0 + bl) * HH + k0 + k]
                  : 0.0f;
  }
  for (int e = tid; e < nb_max * UA; e += kLoopThreads) {
    const int bl = e / UA, k = e % UA;
    s_dhc[e] = (bl < nb && k < na && h.dhcT != nullptr)
                   ? h.dhcT[(size_t)(b0 + bl) * HH + k0 + k]
                   : 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) s_xbh[4 * e + g] = 0.0f;
  }
  for (int e = tid; e < nb * nz; e += kLoopThreads) {
    const int bl = e / nz, o = o_lo + e % nz;
    if (o < 2 * E4) a.part[(size_t)(b0 + bl) * P + 14 * H + GH + o] = 0.0f;
  }
  __syncthreads();  // the resident state
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  HyperEmit<U> em;
  em.sx = h.sx;
  em.sh = h.sh;
  em.xp = h.xp;
  em.hp = h.hp;
  em.dxb = a.dxb;
  em.dbp0 = a.part + 10 * H;
  em.s_ds = s_ds;
  em.exz = h.exz;
  em.s_zd = s_zd;
  em.H = H;
  em.E = E;
  em.P = P;
  em.slices = slices;
  em.sl = sl;
  em.b0 = b0;
  em.u = c.u;

  for (int s = a.T - 1; s >= 0; --s) {
    const size_t ms = (size_t)s * B;
    if (s < a.T - 1) {  // the pairs' dh and dhh, from the step after
      for (int e = tid; e < nb * U; e += kLoopThreads) {
        const int bl = e / U, u = e % U;
        const size_t row = (size_t)(b0 + bl);
        s_part[e] = u < nu ? __ldcg(h.dhx + row * H + j0 + u) : 0.0f;
        s_pa[e] = u < na ? __ldcg(h.dhhx + row * HH + k0 + u) : 0.0f;
      }
      __syncthreads();  // s_part, s_pa
    }
    ln_phase_a(a, c, w, s);
    grid.sync();  // exa complete
    ln_phase_b(a, c, w, s);
    grid.sync();  // exb complete
    ln_phase_c(a, c, w, s, em);
    grid.sync();  // the four streams' step s and exz complete
    // (d1) dz of the tile's rows: this block's outputs, slices in order,
    // into dz and the b_hz partials
    for (int e = tid; e < nb * nz; e += kLoopThreads) {
      const int bl = e / nz, o = o_lo + e % nz;
      const int row = b0 + bl;
      const float* src = h.exz + (size_t)row * slices * Z + o;
      float* pz = a.part + (size_t)row * P + 14 * H + GH + o;  // o < 8e
      const float pv = o < 2 * E4 ? *pz : 0.0f;
      float acc = 0.0f;
      for (int q0 = 0; q0 < slices; q0 += kDzChunk) {  // loads in flight
        float v[kDzChunk];
#pragma unroll
        for (int q = 0; q < kDzChunk; ++q)
          v[q] = q0 + q < slices ? __ldcg(src + (size_t)(q0 + q) * Z) : 0.0f;
#pragma unroll
        for (int q = 0; q < kDzChunk; ++q)
          if (q0 + q < slices) acc += v[q];
      }
      h.dz[(ms + row) * Z + o] = acc;
      if (o < 2 * E4) *pz = pv + acc;
    }
    grid.sync();  // dz of step s complete
    // (d2) the auxiliary LSTM's backward: each row's rnd_W(dz) . w_hz[k]
    // for the block's units k (dz rows staged in chunks through the free
    // region, a warp a row, lanes over the 12e outputs), then a thread a
    // (row, unit) pair
    for (int c0 = 0; c0 < nb; c0 += zrows) {
      const int cr = nb - c0 < zrows ? nb - c0 : zrows;
      stage_rows(reinterpret_cast<float4*>(s_ex),
                 reinterpret_cast<const float4*>(h.dz + (ms + b0 + c0) * Z),
                 cr * Z / 4);
      __syncthreads();  // the chunk's dz rows in s_ex
      for (int bl = c0 + (tid >> 5); bl < c0 + cr; bl += kLoopWarps) {
        const float* dzr = s_ex + (size_t)(bl - c0) * Z;
        float acc[U];
#pragma unroll
        for (int k = 0; k < U; ++k) acc[k] = 0.0f;
        for (int o = tid & 31; o < Z; o += 32) {
          const float v = rnd<W>(dzr[o]);
#pragma unroll
          for (int k = 0; k < U; ++k)
            if (k < na) acc[k] = fmaf(v, s_whz[(size_t)k * Z + o], acc[k]);
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          if (k >= na) break;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
          if ((tid & 31) == 0) s_dhz[bl * UA + k] = acc[k];
        }
      }
      __syncthreads();  // s_ex read
    }
    for (int e = tid; e < nb * na; e += kLoopThreads) {
      const int bl = e / na, k = e - bl * na, row = b0 + bl;
      const size_t m = ms + row;
      float* hp = h.hpre + m * GH + k0 + k;
      const float hp4[4] = {hp[0], hp[HH], hp[2 * HH], hp[3 * HH]};
      const float hc_prev = to_f(h.hycs[m * HH + k0 + k]);
      const float hi = sigmoidf_(hp4[0]), hg = tanhf(hp4[1]);
      const float hf = sigmoidf_(hp4[2] + p.forget_bias);
      const float ho = sigmoidf_(hp4[3]);
      const float nhc = hc_prev * hf + hi * hg;
      const float dhh_tot = s_pa[bl * U + k] + s_dhz[bl * UA + k];
      const float tanh_hc = tanhf(nhc);
      float* dhc = s_dhc + bl * UA + k;
      const float dhcv = *dhc + dhh_tot * ho * (1.0f - tanh_hc * tanh_hc);
      const float dho = dhh_tot * tanh_hc;
      const float dhf = dhcv * hc_prev, dhi = dhcv * hg, dhg = dhcv * hi;
      const float da[4] = {dhi * hi * (1.0f - hi), dhg * (1.0f - hg * hg),
                           dhf * hf * (1.0f - hf), dho * ho * (1.0f - ho)};
      float* xs4 = s_xbh + (bl * UA + k) * 4;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        hp[g * HH] = da[g];
        xs4[g] += da[g];
      }
      *dhc = dhcv * hf;
    }
    grid.sync();  // dh_pre of step s complete
    // (e) dh_{s-1}, dhh_{s-1} of the group's units and rows
    hyper_dh<W, UE>(h.sh + (ms + eb0) * G, h.hpre + (ms + eb0) * GH, s_wh,
                    s_wa, s_whh, s_ep, s_epa, H, HH, UAe, enb, enb_max,
                    parts);
    __syncthreads();  // every part of this step's dh and dhh written
    float* dh_out = s == 0 ? a.dh0 : h.dhx;
    float* dhh_out = s == 0 ? h.dhh0 : h.dhhx;
    for (int e = tid; e < enb * UE; e += kLoopThreads) {
      const int bl = e / UE, u = e % UE;
      const size_t row = (size_t)(eb0 + bl);
      if (u < enu) {
        float v = 0.0f;
        for (int pt = 0; pt < parts; ++pt)
          v += s_ep[((size_t)pt * enb_max + bl) * UE + u];
        dh_out[row * H + ej0 + u] = v;
      }
      if (u < ena) dhh_out[row * HH + ek0 + u] = s_epa[bl * UE + u];
    }
    if (s > 0) grid.sync();  // dhx and dhhx complete
  }
  if (a.T == 0) {  // no step: the carries' gradients are the final ones
    ln_dh0(a, c);
    for (int e = tid; e < nb * na; e += kLoopThreads) {
      const int bl = e / na, k = e - bl * na;
      h.dhh0[(size_t)(b0 + bl) * HH + k0 + k] = s_pa[bl * U + k];
    }
  }
  for (int e = tid; e < nb * na; e += kLoopThreads) {
    const int bl = e / na, k = e - bl * na, row = b0 + bl;
    h.dhc0[(size_t)row * HH + k0 + k] = s_dhc[bl * UA + k];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float v = s_xbh[(bl * UA + k) * 4 + g];
      a.part[(size_t)row * P + 14 * H + g * HH + k0 + k] = v;
      if (h.dxbh != nullptr)
        h.dxbh[(size_t)row * GH + g * HH + k0 + k] = v;
    }
  }
}

// The plan checked against the shape before any launch: an error, never a
// fallback (cudaErrorInvalidValue where the plan does not hold the shape;
// persist.cuh's checks where its blocks cannot co-reside).
template <typename W, typename R>
const void* hyper_loop_fn(int units, int split) {
  if (units == 16)
    return split == 2 ? (const void*)hyper_bwd_loop_kernel<W, R, 16, 2>
                      : (const void*)hyper_bwd_loop_kernel<W, R, 16, 1>;
  return (const void*)hyper_bwd_loop_kernel<W, R, 8, 1>;
}

template <typename W, typename R>
cudaError_t hyper_plan_check(const Bwd<W, R>& a, const HyperArgs<W, R>& h,
                             const HyperPlan& pl, Windows& win) {
  const int H = a.p.H, HH = h.HH;
  if (!((pl.units == 16 && (pl.split == 1 || pl.split == 2)) ||
        (pl.units == 8 && pl.split == 1)) ||
      pl.slices < 1 || (H + pl.slices - 1) / pl.slices > pl.units ||
      (HH + pl.slices - 1) / pl.slices > pl.units || pl.tiles < 1 ||
      pl.tiles % pl.split != 0 ||
      hyper_free_floats(pl.units, pl.slices) < 12 * h.E || pl.windows < 1 || pl.windows > a.B || pl.parts < 1 || pl.smem < 0)
    return cudaErrorInvalidValue;
  win.n = pl.windows;
  win.smem = (size_t)pl.smem;
  int sms = 0, smem_max = 0, tiles0 = 0;
  for (int i = 0; i < win.n; ++i) {  // every window's tiles split evenly
    const int nr = win.rows(i, a.B);
    const int tiles = nr < pl.tiles ? nr : pl.tiles;
    if (tiles % pl.split != 0) return cudaErrorInvalidValue;
    if (tiles > tiles0) tiles0 = tiles;
    if (hyper_smem_floats(pl.units, pl.split, pl.slices,
                          (nr + tiles - 1) / tiles, H, HH, h.E, pl.parts) *
            sizeof(float) > win.smem)
      return cudaErrorInvalidValue;
  }
  cudaError_t err = device_limits(sms, smem_max);
  if (err == cudaSuccess)
    err = ready_loop(hyper_loop_fn<W, R>(pl.units, pl.split), kLoopThreads,
                     win, pl.slices * tiles0, sms);
  return err;
}

template <typename W, typename R>
cudaError_t launch_hyper_loop(const Bwd<W, R>& a, const HyperArgs<W, R>& h,
                              LnWork w, const HyperPlan& pl, const Windows& win,
                              cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const void* fn = hyper_loop_fn<W, R>(pl.units, pl.split);
  for (int i = 0; i < win.n && err == cudaSuccess; ++i) {
    int r0 = win.first(i, a.B), nr = win.rows(i, a.B);
    int slices = pl.slices, parts = pl.parts;
    int tiles = nr < pl.tiles ? nr : pl.tiles;
    Bwd<W, R> args = a;
    HyperArgs<W, R> hy = h;
    LnWork wk = w;
    void* params[] = {&args, &hy, &wk, &slices, &tiles, &parts, &r0, &nr};
    err = cudaLaunchCooperativeKernel(fn, dim3(slices * tiles),
                                      dim3(kLoopThreads), params, win.smem,
                                      stream);
  }
  return err;
}

// 4. dxs = rnd_W(dxp) @ wx^T + rnd_W(dh_pre) @ wxh_x^T of every row-step,
// one warp a row-step (no recurrence)
template <typename W, typename R>
__global__ void hyper_dxs_kernel(Bwd<W, R> a, HyperArgs<W, R> h) {
  const int H = a.p.H, G = 4 * H, GH = 4 * h.HH, D = a.p.D;
  const int lane = threadIdx.x & 31;
  const size_t M = (size_t)a.T * a.B, nw = (size_t)gridDim.x * blockDim.x / 32;
  for (size_t m = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32; m < M;
       m += nw) {
    const float4* dv = reinterpret_cast<const float4*>(h.sx + m * G);
    const float4* da = reinterpret_cast<const float4*>(h.hpre + m * GH);
    for (int q = 0; q < D; ++q) {
      const W* wr = a.p.wx + (size_t)q * G;
      const W* wa = h.wxh_x + (size_t)q * GH;
      float acc = 0.0f, acc2 = 0.0f;
      for (int qd = lane; qd < H; qd += 32) {
        const float4 d = rnd4<W>(dv[qd]);
        const W* wq = wr + 4 * qd;
        acc = fmaf(d.x, to_f(wq[0]), acc);
        acc = fmaf(d.y, to_f(wq[1]), acc);
        acc = fmaf(d.z, to_f(wq[2]), acc);
        acc = fmaf(d.w, to_f(wq[3]), acc);
      }
      for (int qd = lane; qd < h.HH; qd += 32) {
        const float4 d = rnd4<W>(da[qd]);
        const W* wq = wa + 4 * qd;
        acc2 = fmaf(d.x, to_f(wq[0]), acc2);
        acc2 = fmaf(d.y, to_f(wq[1]), acc2);
        acc2 = fmaf(d.z, to_f(wq[2]), acc2);
        acc2 = fmaf(d.w, to_f(wq[3]), acc2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
      }
      if (lane == 0) a.dxs[m * D + q] = acc + acc2;
    }
  }
}

// 5. The eleven matrix gradients on weight_grad.cuh's split-K pass, one
// after another over one partials scratch (wg_part, wg_floats floats):
// [x]^T dxp, [h_prev]^T dhp, [x; h_prev; hh_prev]^T dh_pre, hhn^T dz_p
// (three), rounded to W; z_p[g]^T ds_p[g] (twelve), float x float.
template <typename RT>
WgSrc<RT> wg_stream(const float* f, int ld, int rows) {
  return {f, nullptr, nullptr, ld, 0, rows};
}

template <typename W, typename R>
cudaError_t launch_hyper_products(const Bwd<W, R>& a, const HyperArgs<W, R>& h,
                                  const HyperMatGrads& d, float* wg_part,
                                  int wg_floats, cudaStream_t stream) {
  const int K = a.T * a.B, D = a.p.D, H = a.p.H, HH = h.HH, E = h.E;
  const int G = 4 * H, GH = 4 * HH, Z = 12 * E;
  const WgSrc<R> none = {nullptr, nullptr, nullptr, 0, 0, 0};
  const WgSrc<R> hprev = {nullptr, a.hs, a.h0, H, a.B, H};
  const WgSrc<R> hhprev = {nullptr, h.hyhs, h.hh0, HH, a.B, HH};
  cudaError_t err = cudaSuccess;
  // one product: rows [xs (dx rows); s0; s1] x the stream b (n columns of
  // stride ldb) into dx, d0, d1, rounded to W when round
  auto product = [&](const float* xs, int dx_rows, WgSrc<R> s0, WgSrc<R> s1,
                     const float* b, int ldb, int n, bool round, float* dx,
                     float* d0, float* d1) {
    if (err != cudaSuccess) return;
    WgArgs<R> w;
    w.xs = xs;
    w.src[0] = s0;
    w.src[1] = s1;
    w.dpre = b;
    w.K = K;
    w.D = dx_rows;
    w.ones = 0;
    w.ldb = ldb;
    w.N = n;
    w.dwx = dx;
    w.dwh[0] = d0;
    w.dwh[1] = d1;
    w.db = nullptr;
    const int M = s0.rows + s1.rows;
    w.plan = round && sizeof(W) == 2
                 ? wg_plan<bf16>(K, dx_rows, M, n, 0, wg_part)
                 : wg_plan<float>(K, dx_rows, M, n, 0, wg_part);
    if (wg_part_floats(w) > (size_t)wg_floats) {
      err = cudaErrorInvalidValue;
      return;
    }
    err = round ? launch_weight_grad_pass<W, true>(w, stream)
                : launch_weight_grad_pass<float, true>(w, stream);
  };
  product(a.xs, D, none, none, h.sx, G, G, true, d.wx, nullptr, nullptr);
  product(nullptr, 0, hprev, none, h.sh, G, G, true, nullptr, d.wh, nullptr);
  product(a.xs, D, hprev, hhprev, h.hpre, GH, GH, true, d.wxh_x, d.wxh_h,
          d.whh);
  for (int path = 0; path < 3; ++path)
    product(nullptr, 0, wg_stream<R>(h.hhn, HH, HH), none, h.dz + path * 4 * E,
            Z, 4 * E, true, nullptr, d.w_hz[path], nullptr);
  const float* ds[3] = {h.xp, h.hp, h.pre};  // dsx, dsh, d_pre
  for (int path = 0; path < 3; ++path)
    for (int g = 0; g < 4; ++g)
      product(nullptr, 0, wg_stream<R>(h.zs + (path * 4 + g) * E, Z, E), none,
              ds[path] + g * H, G, H, false, nullptr,
              d.zd[path] + (size_t)g * E * H, nullptr);
  return err;
}

// The six stages in order (stage 0), or one of them: 1 the recompute, 2
// the statistics, 3 the loop, 4 dxs, 5 the products, 6 the row sums.
template <typename W, typename R>
cudaError_t launch_hyper_bwd(const Bwd<W, R>& a, const HyperArgs<W, R>& h,
                             const HyperPlan& pl, const LnWork& w,
                             float* wg_part, int wg_floats,
                             const HyperMatGrads& d, float* dvec, int stage,
                             cudaStream_t stream) {
  const int D = a.p.D, H = a.p.H, HH = h.HH, E = h.E, M = a.T * a.B;
  if (stage < 0 || stage > 6 || a.B < 1 || a.T < 0 || D < 1 || H < 1 ||
      HH < 1 || E < 1 || H > kMaxThreads || HH > kMaxThreads)
    return cudaErrorInvalidValue;
  Windows win;
  const bool loop = stage == 0 || stage == 3;
  cudaError_t err = loop ? hyper_plan_check(a, h, pl, win) : cudaSuccess;
  if (err == cudaSuccess && (stage == 0 || stage == 1))
    err = launch_hyper_recompute(a, h, stream);
  if (err == cudaSuccess && (stage == 0 || stage == 2) && M > 0) {
    ln_stats_kernel<W, R><<<M, threads_for(H), 0, stream>>>(a, w.stats);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && loop)
    err = launch_hyper_loop(a, h, w, pl, win, stream);
  if (err == cudaSuccess && (stage == 0 || stage == 4) && M > 0) {
    const int blocks = (M + 7) / 8 < 4096 ? (M + 7) / 8 : 4096;
    hyper_dxs_kernel<W, R><<<blocks, 256, 0, stream>>>(a, h);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && (stage == 0 || stage == 5))
    err = launch_hyper_products(a, h, d, wg_part, wg_floats, stream);
  if (err == cudaSuccess && (stage == 0 || stage == 6)) {
    sum_rows_kernel<<<(h.P + 255) / 256, 256, 0, stream>>>(a.part, a.B, h.P,
                                                           dvec);
    err = cudaGetLastError();
  }
  return err;
}

// ---------------------------------------------------------------------------
// The forward of srt_hyper_fwd (header, "Design of the forward"): one
// persistent cooperative kernel on the plan's grid, five phases a step.

// The plan (cuda_fused.hyper_fwd_plan): U main units a slice of the
// LayerNorm phases and the split F = U / 8 of the products ((16, 2) or (8,
// 1): a product group holds at most 8 main and 8 auxiliary units),
// `slices` slices, at most `tiles` batch tiles a window (a multiple of F),
// `windows` windows of rows, `pchunk` rows a pass of the products, `chunk`
// rows a pass of the LayerNorm phases, `smem` bytes of shared memory a
// block.
struct HyperFwdPlan {
  int units, split, slices, tiles, windows, pchunk, chunk, smem;
};

constexpr int kPMainCols = 32;  // a product group's main columns (8 units)
// float weights, a product task: 4 units (all four gates) x 16 rows, lane
// l taking unit l % 4 and rows l / 4 + 8 i
constexpr int kPUnits = 4, kPRowLanes = 32 / kPUnits, kPRows = 2;
constexpr int kPTaskRows = kPRows * kPRowLanes;
constexpr int kHfRows = 2;  // LayerNorm phases: rows a lane and row lane
constexpr int kHfStage = 8;  // 16-byte loads in flight a thread, staging

// A product group's auxiliary units, rounded up to a multiple of 4
__host__ __device__ inline int hf_aux4(int HH, int slices, int F) {
  const int se = slices * F, n = (HH + se - 1) / se;
  return (n + 3) / 4 * 4;
}

// A resident weight column's floats: K rounded up to whole k-steps of 8
// (zeros past K), and 4 more, so that the 8 columns of an mma fragment's
// loads fall in distinct banks
__host__ __device__ inline int hf_col(int K) { return (K + 7) / 8 * 8 + 4; }

// A zd column's stride in shared memory: e rounded up to whole quads, and
// one quad more, so that the 16 units' quads of one read fall in distinct
// banks
__host__ __device__ inline int hf_zd_stride(int E) {
  return (E + 3) / 4 * 4 + 4;
}

// The most outputs of z a slice sums (dz_share's whole chunks)
__host__ __device__ inline int hf_z_share(int E, int slices) {
  const int Z = 12 * E, zc = Z % 8 == 0 ? 8 : 4;
  return (Z / zc + slices - 1) / slices * zc;
}

// The floats of the rows buffer, the most of: a products pass's h and hh
// rows (at float's row strides, so that the plan is the same at both weight
// types), a LayerNorm pass's rows of z (stride 12e + 4) or of the gate
// exchange, the w_hz columns of a z share with one row of hh_t (padded by
// 16 bytes).
__host__ __device__ inline size_t hf_buf_floats(int H, int HH, int E,
                                                int slices, int pchunk,
                                                int chunk) {
  const size_t rows = (size_t)pchunk * (fwd_row_stride<float>(H) +
                                        fwd_row_stride<float>(HH));
  const size_t wide =
      12 * E + 4 > 8 * slices ? 12 * (size_t)E + 4 : 8 * (size_t)slices;
  const size_t zs = (size_t)HH * (hf_z_share(E, slices) + 1) + 4;
  size_t n = rows > (size_t)chunk * wide ? rows : (size_t)chunk * wide;
  return n > zs ? n : zs;
}

// A block's shared memory in floats for LayerNorm tiles of nb rows
// (cuda_fused.hyper_fwd_smem, the same sum): the resident columns of the
// product group (wh of 8 main units, wxh_h and whh of its auxiliary units,
// four gates each, at the tensor cores' padded column stride, which the
// float tasks' quads fit in; wxh_x and bh), of the LayerNorm slice (wx, the
// zd columns), the slices' unit counts, its units' LayerNorm parameters
// and bias, the main and auxiliary cell carries, a products pass's
// auxiliary sums, the rows buffer.
__host__ __device__ inline size_t hyper_fwd_smem_floats(int U, int F,
                                                        int slices, int nb,
                                                        int D, int H, int HH,
                                                        int E, int pchunk,
                                                        int chunk) {
  const size_t a4 = hf_aux4(HH, slices, F);
  return (kPMainCols + a4 * 4) * hf_col(H) + a4 * 4 * (hf_col(HH) + D + 1) +
         (size_t)4 * U * D + (size_t)12 * U * hf_zd_stride(E) + 64 +
         (size_t)16 * U + (size_t)nb * U + (size_t)F * nb * a4 +
         2 * (size_t)pchunk * a4 * 4 +
         hf_buf_floats(H, HH, E, slices, pchunk, chunk);
}

// The float work scratch of srt_hyper_fwd, carved in this order: z [B,
// 12e], the gate norms' slice partials [B, slices, 8], the cell norm's [B,
// slices, 2], hp = h @ wh [B, 4H], the stash [4, B, H] (each pair's
// pre-activations, then its new cell state and o, from one phase to the
// next where a tile's rows take several passes) (cuda_fused.hyper_fwd_
// work_floats).
struct HyperFwdWork {
  float *z, *exg, *exc, *hp, *stash;
};

HyperFwdWork hyper_fwd_work(float* work, int B, int H, int E, int slices) {
  HyperFwdWork w;
  w.z = work;
  w.exg = w.z + (size_t)B * 12 * E;
  w.exc = w.exg + (size_t)B * slices * 8;
  w.hp = w.exc + (size_t)B * slices * 2;
  w.stash = w.hp + (size_t)B * 4 * H;
  return w;
}

// The moments of N values per lane over the U lanes of one row's units (a
// lane past the slice's n units contributes nothing): mean = sum / n, then
// m2 = sum of (v - mean)^2. Every lane gets them; all 32 lanes call it.
// fused_rnn.cu's slice_moments for slices of U units. Copied, not shared:
// moving a loop's LayerNorm phases into a shared header cost row 5b's loop
// time (PERF.md), and row 5f keeps its code as it was.
template <int U, int N>
__device__ __forceinline__ void hf_moments(const float (&v)[N], bool real,
                                           float n, float (&mean)[N],
                                           float (&m2)[N]) {
#pragma unroll
  for (int g = 0; g < N; ++g) mean[g] = real ? v[g] : 0.0f;
  unit_sum<U>(mean);
#pragma unroll
  for (int g = 0; g < N; ++g) {
    mean[g] = mean[g] / n;
    const float d = v[g] - mean[g];
    m2[g] = real ? d * d : 0.0f;
  }
  unit_sum<U>(m2);
}

// fused_rnn.cu's chan_stats, copied for the same reason: the layer-norm
// statistics of N rows from their slices' (mean, M2) partials m[n][k *
// stride] and m[n][k * stride + off], combined in slice order by Chan's
// rule (s_n: each slice's unit count).
template <int N>
__device__ __forceinline__ void hf_chan(const float* const (&m)[N],
                                        int stride, int off, const float* s_n,
                                        int slices, float fh,
                                        float (&mean)[N], float (&rs)[N]) {
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

// The units k_lo .. k_hi - 1 (k_lo a multiple of 8) of the cr rows of a
// products pass (from row0 on) of x_{t-1} (K units) into s (row stride rs,
// type W): rnd_W(x0) at t = 0 (xin null), after it the exchange plane of
// the step before, written by other blocks of the kernel (by 16-byte
// cp.async.cg where the rows allow it, else element by element through
// L2). The caller commits the group.
template <typename W>
__device__ __forceinline__ void hf_load_rows(W* s, int rs, const float* x0,
                                             const W* xin, bool async,
                                             size_t row0, int cr, int K,
                                             int k_lo, int k_hi) {
  constexpr int kE = 16 / sizeof(W);
  if (xin != nullptr && async) {
    const int n = (k_hi - k_lo) / kE;  // k_hi - k_lo a multiple of kE
    for (int e = threadIdx.x; e < cr * n; e += kFwdThreads) {
      const int r = e / n, k = k_lo + (e - r * n) * kE;
      cp_async16(s + r * rs + k, xin + (row0 + r) * K + k);
    }
  } else {
    const int n = k_hi - k_lo;
#pragma unroll 4
    for (int e = threadIdx.x; e < cr * n; e += kFwdThreads) {
      const int r = e / n, k = k_lo + e - r * n;
      const size_t at = (row0 + r) * K + k;
      s[r * rs + k] = xin == nullptr ? from_f<W>(x0[at]) : ldcg_raw(xin + at);
    }
  }
}

// cr rows of n floats (n a multiple of 4) from src, written by other blocks
// of the kernel, into dst at row stride ld (a multiple of 4): one copy
// through L2 by the whole block, kHfStage loads in flight a thread. A
// __syncthreads must follow.
__device__ __forceinline__ void stage_rows_ld(float* dst, int ld,
                                              const float* src, int cr,
                                              int n) {
  const int n4 = n / 4, tot = cr * n4;
  for (int e0 = threadIdx.x; e0 < tot; e0 += kHfStage * kFwdThreads) {
    float4 v[kHfStage];
#pragma unroll
    for (int i = 0; i < kHfStage; ++i) {
      const int e = e0 + i * kFwdThreads;
      if (e < tot) v[i] = __ldcg(reinterpret_cast<const float4*>(src) + e);
    }
#pragma unroll
    for (int i = 0; i < kHfStage; ++i) {
      const int e = e0 + i * kFwdThreads;
      if (e < tot) {
        const int r = e / n4;
        reinterpret_cast<float4*>(dst + (size_t)r * ld)[e - r * n4] = v[i];
      }
    }
  }
}

// Float weights: a product task's sums over k in [k_lo, k_hi) (k_lo a
// multiple of 4): the rows r[i] of rows (stride rs) times the task's
// resident weight quads w (four gates of one unit, 16 floats a k), each
// output one in-order fmaf chain over k (hyper_step's).
__device__ __forceinline__ void hf_task_part(const float* rows, int rs,
                                             const float* w,
                                             const int (&r)[kPRows],
                                             int k_lo, int k_hi,
                                             float (&acc)[kPRows][4]) {
  const float* x[kPRows];
#pragma unroll
  for (int i = 0; i < kPRows; ++i) x[i] = rows + (size_t)r[i] * rs;
  int k = k_lo;
#pragma unroll 2
  for (; k + 4 <= k_hi; k += 4) {
    float v[kPRows][4];
#pragma unroll
    for (int i = 0; i < kPRows; ++i) {
      const float4 h = quad(x[i] + k);
      v[i][0] = h.x;
      v[i][1] = h.y;
      v[i][2] = h.z;
      v[i][3] = h.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 q = quad(w + (size_t)(k + kk) * 16);
#pragma unroll
      for (int i = 0; i < kPRows; ++i) {
        acc[i][0] = fmaf(v[i][kk], q.x, acc[i][0]);
        acc[i][1] = fmaf(v[i][kk], q.y, acc[i][1]);
        acc[i][2] = fmaf(v[i][kk], q.z, acc[i][2]);
        acc[i][3] = fmaf(v[i][kk], q.w, acc[i][3]);
      }
    }
  }
  for (; k < k_hi; ++k) {
    const float4 q = quad(w + (size_t)k * 16);
#pragma unroll
    for (int i = 0; i < kPRows; ++i) {
      const float a = x[i][k];
      acc[i][0] = fmaf(a, q.x, acc[i][0]);
      acc[i][1] = fmaf(a, q.y, acc[i][1]);
      acc[i][2] = fmaf(a, q.z, acc[i][2]);
      acc[i][3] = fmaf(a, q.w, acc[i][3]);
    }
  }
}

// c += a (16 x 8, row-major fragment) * b (8 x 8, column-major), tf32
// operands, float sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bf16 weights: a product task's k-steps of 8 in [k_lo, k_hi) (k_lo a
// multiple of 8): acc[j] += rows m0 .. m0 + 15 of rows (stride rs, bf16;
// rows past cr read row cr - 1, k past K read 0) times the columns n0 + 8
// j .. + 7 (j < 2) of w (the bf16 weights widened, stride kc = hf_col(K),
// zeros past K), on the tensor cores (mma.sync m16n8k8, tf32 operands,
// float sums): a bf16 value is exact in tf32, so every product is exact,
// as in the float multiply-adds of the row-block design. (3xTF32 at float
// weights was slower than the multiply-adds and missed 1e-4 at H=512.)
__device__ __forceinline__ void hf_mma_part(const bf16* rows, int rs, int m0,
                                            int cr, const float* w, int kc,
                                            int n0, int K, int k_lo, int k_hi,
                                            float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* xa = rows + (size_t)(m0 + g < cr ? m0 + g : cr - 1) * rs;
  const bf16* xb = rows + (size_t)(m0 + g + 8 < cr ? m0 + g + 8 : cr - 1) * rs;
  const float* w0 = w + (size_t)(n0 + g) * kc;
  const float* w1 = w0 + (size_t)8 * kc;
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {  // warp-uniform: mma.sync
    const int k = k0 + t;
    const bool in0 = k < K, in1 = k + 4 < K;
    const float a[4] = {in0 ? to_f(xa[k]) : 0.0f, in0 ? to_f(xb[k]) : 0.0f,
                        in1 ? to_f(xa[k + 4]) : 0.0f,
                        in1 ? to_f(xb[k + 4]) : 0.0f};
    const uint32_t ab[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]),
                            __float_as_uint(a[2]), __float_as_uint(a[3])};
    mma_tf32(acc[0], ab, __float_as_uint(w0[k]), __float_as_uint(w0[k + 4]));
    mma_tf32(acc[1], ab, __float_as_uint(w1[k]), __float_as_uint(w1[k + 4]));
  }
}

// Four outputs of z (the quad oq of row bl of the pass; nz a multiple of
// 4, o_lo too, so one path), each one in-order fmaf chain over the HH
// units of hh_t (row bl of s_z, stride zs, type W) with the staged w_hz
// columns s_whz ([HH][zm]), b_hz added on the paths x and h, into z (row
// stride Z, zrow0: the pass's first row).
template <typename W>
__device__ __forceinline__ void hf_z_quad(const W* s_z, int zs,
                                          const float* s_whz, int zm, int bl,
                                          int oq, int HH, int o_lo, int E4,
                                          const float* bzx, const float* bzh,
                                          float* zrow0, int Z) {
  const W* hr = s_z + (size_t)bl * zs;
  const float* wz = s_whz + 4 * oq;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
  for (int k = 0; k < HH; ++k) {
    const float hk = to_f(hr[k]);
    const float4 w = quad(wz + (size_t)k * zm);
    acc[0] = fmaf(hk, w.x, acc[0]);
    acc[1] = fmaf(hk, w.y, acc[1]);
    acc[2] = fmaf(hk, w.z, acc[2]);
    acc[3] = fmaf(hk, w.w, acc[3]);
  }
  const int o = o_lo + 4 * oq, path = o / E4, q = o - path * E4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = acc[i];
    if (path < 2) v = __fadd_rn(v, (path == 0 ? bzx : bzh)[q + i]);
    zrow0[(size_t)bl * Z + o + i] = v;
  }
}

// The loop, one persistent cooperative kernel on the plan's grid. Block
// (tile, slice) owns, for the LayerNorm phases, the main units j0 .. j0 +
// nu - 1 of its slice for the rows of its tile (their cell carries in
// shared memory) and the z outputs o_lo .. o_hi - 1 of those rows; for the
// products, the main units ej0 .. and auxiliary units ek0 .. of group ge =
// slice * F + tile % F (at most 8 of each) for the rows of the F tiles from
// F (tile / F) on (their auxiliary cell carries in shared memory). Per
// step t (five grid barriers):
//  (1) the products, a pass of at most pchunk rows at a time (h_{t-1} and
//      hh_{t-1} rows staged by parts of k, each part's products while the
//      later parts land): hp = h @ wh of its main units to the exchange
//      wk.hp; the auxiliary pre-activations ((x @ wxh_x + h @ wxh_h) + bh)
//      + hh @ whh [+ xbh] of its auxiliary units, their gates, hh_t to hhx
//      (rounded to W), hycs and hyhs;
//  (2) its share of z = hh_t @ w_hz (+ b_hz) for its tile's rows;
//  (3) xp = x @ wx [+ xb], the block scales s_p = z_p . zd_p and pre =
//      ((s_x xp + s_h hp) + s_b) + b of its pairs, the gates' slice moments
//      to wk.exg (pre kept in registers, or in the stash where a tile's
//      rows take several passes);
//  (4) the gate norms in slice order (Chan's rule), the gate block, the new
//      cell state's slice moments to wk.exc;
//  (5) the cell norm, h_t to hx (rounded to W), hs and cs.
// A task of (1) at float weights is 4 units (all four gates) x 16 rows of
// one product (h @ wh, h @ wxh_h or hh @ whh), a warp each, its outputs
// in-order fmaf chains over k; at bf16 weights 16 rows x 16 columns on the
// tensor cores (hf_mma_part). The LayerNorm phases take row 5f's lane
// layout: a warp task is the U units of the slice x (32 / U) x 2 rows.
// Exchanges written by other blocks are read through L2.
template <typename W, typename R, int U>
__global__ void __launch_bounds__(kFwdThreads)
hyper_fwd_loop_kernel(HyperFwd<W, R> a, W* hx, HyperFwdWork wk, int slices,
                      int tiles, int pchunk, int chunk, int r0, int nr) {
  constexpr int F = U / 8, RL = 32 / U, TR = RL * kHfRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HyperCell<W>& p = a.p;
  const int H = p.H, HH = p.HH, D = p.D, E = p.E, B = a.B;
  const int G = 4 * H, GH = 4 * HH, E4 = 4 * E, Z = 12 * E, ZS = Z + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  // the LayerNorm phases' units and rows
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  const int nb_max = (nr + tiles - 1) / tiles;
  // the products' group: its units and the rows of F tiles
  const int se = slices * F, ge = sl * F + bt % F, te = bt / F;
  const int ej0 = ge * H / se, enu = (ge + 1) * H / se - ej0;
  const int ek0 = ge * HH / se, ena = (ge + 1) * HH / se - ek0;
  const int a4 = hf_aux4(HH, slices, F);
  const int hc_ = hf_col(H), hhc = hf_col(HH);  // resident column strides
  const int NH = kPMainCols + 4 * a4;  // the h products' columns
  const int eb0 = r0 + te * F * nr / tiles;
  const int enb = (te * F + F) * nr / tiles - te * F * nr / tiles;
  int o_lo, o_hi;  // the outputs of z this block sums
  dz_share(Z, slices, sl, o_lo, o_hi);
  const int nz = o_hi - o_lo, ez = hf_zd_stride(E);
  float* s_wph = reinterpret_cast<float*>(smem_raw);  // [NH][hc_]
  float* s_wphh = s_wph + NH * hc_;                   // [4 a4][hhc]
  float* s_wax = s_wphh + 4 * a4 * hhc;               // [D][a4][4]
  float* s_bh = s_wax + a4 * 4 * D;                  // [a4][4]
  float* s_wx = s_bh + a4 * 4;                       // [D][U][4]
  float* s_zd = s_wx + 4 * U * D;                    // [12][U][ez]
  float* s_n = s_zd + 12 * U * ez;                   // [64]
  float* s_lnp = s_n + 64;  // [U][16]: gamma[4], beta[4], b[4], gc, bc
  float* s_c = s_lnp + 16 * U;                       // [nb_max][U]
  float* s_hc = s_c + nb_max * U;                    // [F nb_max][a4]
  float* s_ah = s_hc + F * nb_max * a4;              // [pchunk][a4][4]
  float* s_ar = s_ah + pchunk * a4 * 4;              // [pchunk][a4][4]
  unsigned char* s_buf =
      reinterpret_cast<unsigned char*>(s_ar + pchunk * a4 * 4);
  float* s_ex = reinterpret_cast<float*>(s_buf);
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  // the resident columns, as float, zero past the units. Float weights:
  // the SIMT tasks' quads, [group of 4 units][k][unit][gate], over h the 2
  // main groups then the auxiliary ones, over hh the auxiliary ones. Bf16
  // (the tensor cores): column c, unit c / 4 (main units, then from
  // kPMainCols on the auxiliary ones), gate c % 4, k contiguous at stride
  // hf_col(K), which sizes both.
  if constexpr (sizeof(W) == 4) {
    for (int e = tid; e < NH * H; e += kFwdThreads) {  // NH / 16 groups
      const int grp = e / (H * 16), r = e - grp * H * 16, k = r / 16;
      const int u = grp * kPUnits + (r / 4) % 4, g = r % 4;
      float v = 0.0f;
      if (u < 8 && u < enu)
        v = p.wh[(size_t)k * G + g * H + ej0 + u];
      else if (u >= 8 && u - 8 < ena)
        v = p.wxh_h[(size_t)k * GH + g * HH + ek0 + u - 8];
      s_wph[e] = v;
    }
    for (int e = tid; e < a4 * HH * 4; e += kFwdThreads) {
      const int grp = e / (HH * 16), r = e - grp * HH * 16, k = r / 16;
      const int u = grp * kPUnits + (r / 4) % 4, g = r % 4;
      s_wphh[e] =
          u < ena ? p.whh[(size_t)k * GH + g * HH + ek0 + u] : 0.0f;
    }
  } else {
    for (int e = tid; e < hc_ * NH; e += kFwdThreads) {
      const int k = e / NH, c = e - k * NH, u = c / 4, g = c % 4;
      float v = 0.0f;
      if (k < H && u < 8 && u < enu)
        v = to_f(p.wh[(size_t)k * G + g * H + ej0 + u]);
      else if (k < H && u >= 8 && u - 8 < ena)
        v = to_f(p.wxh_h[(size_t)k * GH + g * HH + ek0 + u - 8]);
      s_wph[c * hc_ + k] = v;
    }
    for (int e = tid; e < hhc * 4 * a4; e += kFwdThreads) {
      const int k = e / (4 * a4), c = e - k * 4 * a4, u = c / 4, g = c % 4;
      s_wphh[c * hhc + k] =
          k < HH && u < ena ? to_f(p.whh[(size_t)k * GH + g * HH + ek0 + u])
                            : 0.0f;
    }
  }
  for (int e = tid; e < (D + 1) * a4 * 4; e += kFwdThreads) {  // + s_bh
    const int q = e / (a4 * 4), kl = (e / 4) % a4;
    const int col = (e % 4) * HH + ek0 + kl;
    float v = 0.0f;
    if (kl < ena) v = q < D ? to_f(p.wxh_x[(size_t)q * GH + col]) : p.bh[col];
    s_wax[e] = v;
  }
  for (int e = tid; e < D * U * 4; e += kFwdThreads) {
    const int q = e / (U * 4), uu = (e / 4) % U, g = e % 4;
    s_wx[e] = uu < nu ? to_f(p.wx[(size_t)q * G + g * H + j0 + uu]) : 0.0f;
  }
  for (int e = tid; e < 12 * U * ez; e += kFwdThreads) {
    const int pg = e / (U * ez), uu = (e / ez) % U, q = e % ez;
    const float* zd = pg < 4 ? p.zd[0] : pg < 8 ? p.zd[1] : p.zd[2];
    s_zd[e] = uu < nu && q < E ? zd[((size_t)(pg % 4) * E + q) * H + j0 + uu]
                               : 0.0f;
  }
  if (tid < slices)
    s_n[tid] = (float)((tid + 1) * H / slices - tid * H / slices);
  for (int e = tid; e < 16 * U; e += kFwdThreads) {
    const int uu = e / 16, q = e % 16, g = q % 4, jj = j0 + uu;
    float v = 0.0f;
    if (uu < nu && q < 14)
      v = q < 4    ? p.ln.ln_gamma[g * H + jj]
          : q < 8  ? p.ln.ln_beta[g * H + jj]
          : q < 12 ? p.b[g * H + jj]
          : q == 12 ? p.ln.lnc_gamma[jj]
                    : p.ln.lnc_beta[jj];
    s_lnp[e] = v;
  }
  for (int q = tid; q < nb * U; q += kFwdThreads) {
    const int uu = q % U;
    s_c[q] = uu < nu ? a.c0[(size_t)(b0 + q / U) * H + j0 + uu] : 0.0f;
  }
  for (int q = tid; q < enb * a4; q += kFwdThreads) {
    const int kl = q % a4;
    s_hc[q] = kl < ena ? a.hc0[(size_t)(eb0 + q / a4) * HH + ek0 + kl] : 0.0f;
  }
  __syncthreads();  // the resident state, before any phase reads it
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  W* const hhx = hx + 2 * (size_t)B * H;
  float* const stash = wk.stash;
  const size_t plane = (size_t)B * H, hplane = (size_t)B * HH;
  const int rs_h = fwd_row_stride<W>(H), rs_hh = fwd_row_stride<W>(HH);
  constexpr int kV = 16 / (int)sizeof(W);
  const bool async_h =
      H % kV == 0 && (reinterpret_cast<uintptr_t>(hx) & 15) == 0;
  const bool async_hh =
      HH % kV == 0 && (reinterpret_cast<uintptr_t>(hhx) & 15) == 0;
  // (2)'s w_hz columns [HH][zm] at the buffer's start, and the rows of
  // hh_t that the rest holds
  const int zm = hf_z_share(E, slices);
  const int zs = HH + 16 / (int)sizeof(W);  // a staged row, 16 bytes more
  const int zr = (int)((hf_buf_floats(H, HH, E, slices, pchunk, chunk) -
                        (size_t)HH * zm) *
                       sizeof(float) / ((size_t)zs * sizeof(W)));
  // the k of a part of h and of hh
  const int kp = ((H + kParts - 1) / kParts + 7) / 8 * 8;
  const int kph = ((HH + kParts - 1) / kParts + 7) / 8 * 8;
  // bf16, a product task: an m-tile of 16 rows x two n-tiles of 8 columns,
  // over h (main, then auxiliary columns) or over hh
  const int nph = NH / 16, nphh = a4 / 4;
  // float, the warp's task: main (2 groups of 4 units), auxiliary over h,
  // auxiliary over hh (a4 / 4 groups each), for rows prt * 16 ..; lane:
  // unit pu of the task's four, rows prl + 8 i
  const int ag = a4 / kPUnits, per = 2 + 2 * ag;
  const int prt = warp / per, kind = warp - prt * per;
  const bool is_hh = kind >= 2 + ag;
  const int grp = kind < 2 ? kind : is_hh ? kind - 2 - ag : kind - 2;
  const float* wt = (kind < 2    ? s_wph + (size_t)grp * H * 16
                     : is_hh     ? s_wphh + (size_t)grp * HH * 16
                                 : s_wph + (size_t)(2 + grp) * H * 16) +
                    (lane % kPUnits) * 4;
  const int pk = is_hh ? HH : H, pkq = is_hh ? kph : kp;
  const int pu = lane % kPUnits, prl = lane / kPUnits;
  // the LayerNorm phases' lane: unit u of the slice, rows lr0 + RL i
  const int u = lane % U, half = lane & ~(U - 1);
  const bool unit = u < nu;
  const int j = j0 + (unit ? u : 0);
  const int lr0 = warp * TR + lane / U;
  const float fh = (float)H, fn = nu > 0 ? (float)nu : 1.0f;
  const float* lnp = s_lnp + u * 16;  // this lane's unit's parameters
  const bool multi = nb > chunk;  // else the pairs stay in registers
  float pre[kHfRows][4], keep_c[kHfRows], keep_o[kHfRows];

  for (int t = 0; t < a.T; ++t) {
    const W* hin = t == 0 ? nullptr : hx + ((t + 1) & 1) * plane;
    const W* hhin = t == 0 ? nullptr : hhx + ((t + 1) & 1) * hplane;
    W* hout = hx + (t & 1) * plane;
    W* hhout = hhx + (t & 1) * hplane;
    // (1) the products of the group's rows, a pass at a time
    for (int pc = 0; pc < enb; pc += pchunk) {
      const int cr = enb - pc < pchunk ? enb - pc : pchunk;
      W* s_h = reinterpret_cast<W*>(s_buf);
      W* s_hh = s_h + (size_t)pchunk * rs_h;
      if constexpr (sizeof(W) == 4) {
        // float: the hh rows in one cp.async group, then h in kParts groups
        // over k, each part's sums while the later parts land; a warp a
        // task, each output one in-order fmaf chain over k
        hf_load_rows<W>(s_hh, rs_hh, a.hh0, hhin, async_hh,
                        (size_t)(eb0 + pc), cr, HH, 0, HH);
        cp_async_commit();
        for (int part = 0; part < kParts; ++part) {
          const int lo = part * kp, hi = lo + kp < H ? lo + kp : H;
          hf_load_rows<W>(s_h, rs_h, a.h0, hin, async_h, (size_t)(eb0 + pc),
                          cr, H, lo < H ? lo : H, lo < H ? hi : H);
          cp_async_commit();
        }
        const bool busy = prt * kPTaskRows < cr;
        int l[kPRows], ra[kPRows];  // the lane's rows in the pass, and read
        float acc[kPRows][4];
#pragma unroll
        for (int i = 0; i < kPRows; ++i) {
          l[i] = prt * kPTaskRows + prl + i * kPRowLanes;
          ra[i] = l[i] < cr ? l[i] : cr - 1;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
        }
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          cp_async_wait(kParts - 1 - part);
          __syncthreads();  // the hh rows and this part of h, every thread
          if (!busy) continue;
          const int lo = part * pkq, hi = lo + pkq < pk ? lo + pkq : pk;
          if (lo < hi)
            hf_task_part(reinterpret_cast<const float*>(is_hh ? s_hh : s_h),
                         is_hh ? rs_hh : rs_h, wt, ra, lo, hi, acc);
        }
        if (busy && kind < 2) {  // hp of the main units, to the exchange
          const int jl = grp * kPUnits + pu;
#pragma unroll
          for (int r = 0; r < kPRows; ++r) {
            if (jl >= enu || l[r] >= cr) continue;
            float* dst = wk.hp + (size_t)(eb0 + pc + l[r]) * G + ej0 + jl;
#pragma unroll
            for (int g = 0; g < 4; ++g) dst[g * H] = acc[r][g];
          }
        } else if (busy) {  // the auxiliary sums, by (row, unit)
          float* dst = (is_hh ? s_ar : s_ah) + (grp * kPUnits + pu) * 4;
#pragma unroll
          for (int r = 0; r < kPRows; ++r)
            if (l[r] < cr)
              *reinterpret_cast<float4*>(dst + (size_t)l[r] * a4 * 4) =
                  make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      } else {
        // bf16: the pass's rows of h and hh in kParts cp.async groups over
        // k, each part's products while the later parts land; a warp takes
        // the tasks warp and warp + kFwdWarps (at most two: the plan holds
        // a pass to 32 rows)
        for (int part = 0; part < kParts; ++part) {
          const int lo = part * kp, hi = lo + kp < H ? lo + kp : H;
          const int llo = part * kph, lhi = llo + kph < HH ? llo + kph : HH;
          hf_load_rows<W>(s_h, rs_h, a.h0, hin, async_h, (size_t)(eb0 + pc),
                          cr, H, lo, hi);
          hf_load_rows<W>(s_hh, rs_hh, a.hh0, hhin, async_hh,
                          (size_t)(eb0 + pc), cr, HH, llo, lhi);
          cp_async_commit();
        }
        const int ntask = (cr + 15) / 16 * (nph + nphh);
        float acc[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          cp_async_wait(kParts - 1 - part);
          __syncthreads();  // this part's rows, for every thread
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int task = warp + i * kFwdWarps;
            if (task >= ntask) break;
            const int mt = task / (nph + nphh), ct = task - mt * (nph + nphh);
            if (ct < nph)
              hf_mma_part(s_h, rs_h, 16 * mt, cr, s_wph, hc_, 16 * ct, H,
                          part * kp, (part + 1) * kp < H ? (part + 1) * kp : H,
                          acc[i]);
            else
              hf_mma_part(s_hh, rs_hh, 16 * mt, cr, s_wphh, hhc,
                          16 * (ct - nph), HH, part * kph,
                          (part + 1) * kph < HH ? (part + 1) * kph : HH,
                          acc[i]);
          }
        }
        // the tasks' sums: lane (g, t) holds rows g, g + 8 x columns 2 t,
        // 2 t + 1 of each n-tile
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int task = warp + i * kFwdWarps;
          if (task >= ntask) break;
          const int mt = task / (nph + nphh), ct = task - mt * (nph + nphh);
          const bool hh = ct >= nph;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int l = 16 * mt + lane / 4 + (q >= 2 ? 8 : 0);
              const int c = 16 * (hh ? ct - nph : ct) + 8 * j + 2 * (lane % 4) +
                            (q & 1);
              const int uc = c / 4, g = c % 4;
              if (l >= cr) continue;
              if (hh)  // hh @ whh of an auxiliary unit
                s_ar[((size_t)l * a4 + uc) * 4 + g] = acc[i][j][q];
              else if (uc >= 8)  // h @ wxh_h of an auxiliary unit
                s_ah[((size_t)l * a4 + uc - 8) * 4 + g] = acc[i][j][q];
              else if (uc < enu)  // hp of a main unit, to the exchange
                wk.hp[(size_t)(eb0 + pc + l) * G + g * H + ej0 + uc] =
                    acc[i][j][q];
            }
        }
      }
      __syncthreads();  // the auxiliary sums complete, the rows read
      // the auxiliary LSTM's gates of the pass's (row, unit) pairs, no
      // dropout: hyper_step's sums in its order, each rounded on its own
      for (int e = tid; e < cr * ena; e += kFwdThreads) {
        const int bl = e / ena, kl = e - bl * ena;
        const int row = eb0 + pc + bl, col = ek0 + kl;
        const float* x = a.xs + ((size_t)t * B + row) * D;
        float ax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = 0; q < D; ++q) {
          const float xq = rnd<W>(x[q]);
          const float4 w = quad(s_wax + ((size_t)q * a4 + kl) * 4);
          ax[0] = fmaf(xq, w.x, ax[0]);
          ax[1] = fmaf(xq, w.y, ax[1]);
          ax[2] = fmaf(xq, w.z, ax[2]);
          ax[3] = fmaf(xq, w.w, ax[3]);
        }
        const float4 ah4 = quad(s_ah + ((size_t)bl * a4 + kl) * 4);
        const float4 ar4 = quad(s_ar + ((size_t)bl * a4 + kl) * 4);
        const float4 bh4 = quad(s_bh + kl * 4);
        const float ah[4] = {ah4.x, ah4.y, ah4.z, ah4.w};
        const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
        const float bh[4] = {bh4.x, bh4.y, bh4.z, bh4.w};
        float v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          v[g] = __fadd_rn(__fadd_rn(__fadd_rn(ax[g], ah[g]), bh[g]), ar[g]);
          if (p.xbh != nullptr)
            v[g] = __fadd_rn(v[g], p.xbh[(size_t)row * GH + g * HH + col]);
        }
        const float hi = sigmoidf_(v[0]), hg = tanhf(v[1]);
        const float hf = sigmoidf_(__fadd_rn(v[2], p.forget_bias));
        const float ho = sigmoidf_(v[3]);
        float* hcp = s_hc + (size_t)(pc + bl) * a4 + kl;
        const float hc = *hcp;
        const float nhc = __fadd_rn(__fmul_rn(hc, hf), __fmul_rn(hi, hg));
        const float nhh = __fmul_rn(tanhf(nhc), ho);
        const size_t at = ((size_t)t * B + row) * HH + col;
        a.hycs[at] = from_f<R>(hc);
        a.hyhs[at] = from_f<R>(nhh);
        hhout[(size_t)row * HH + col] = from_f<W>(nhh);
        *hcp = nhc;
        if (t == a.T - 1) {
          a.hcT[(size_t)row * HH + col] = nhc;
          a.hhT[(size_t)row * HH + col] = nhh;
        }
      }  // the pass's auxiliary gates
    }
    grid.sync();  // hp and hh_t complete
    // (2) this block's outputs of z for its tile's rows, each one in-order
    // fmaf chain over the HH units of hh_t (hyper_step's), two at a time,
    // from its w_hz columns and the rows of hh_t, both staged
    float* s_whz = reinterpret_cast<float*>(s_buf);
    W* s_z = reinterpret_cast<W*>(s_whz + (size_t)HH * zm);
    for (int zc = 0; zc < nb; zc += zr) {
      const int zcr = nb - zc < zr ? nb - zc : zr;
      // w_hz's columns (the first pass): kStage loads a thread in flight
      // while the pass's rows of hh_t are staged
      float wv[kStage];
      for (int e0 = tid; zc == 0 && e0 < HH * nz;
           e0 += kStage * kFwdThreads) {
#pragma unroll
        for (int i = 0; i < kStage; ++i) {
          const int e = e0 + i * kFwdThreads;
          if (e >= HH * nz) break;
          const int k = e / nz, o = o_lo + e - k * nz, path = o / E4;
          const W* w =
              path == 0 ? p.w_hz[0] : path == 1 ? p.w_hz[1] : p.w_hz[2];
          wv[i] = to_f(__ldg(w + (size_t)k * E4 + o - path * E4));
        }
        if (e0 == tid) {  // the rows, behind the first loads
          const W* src = hhout + (size_t)(b0 + zc) * HH;
          if (async_hh)
            stage_rows_ld(reinterpret_cast<float*>(s_z),
                          zs * (int)sizeof(W) / 4,
                          reinterpret_cast<const float*>(src), zcr,
                          HH * (int)sizeof(W) / 4);
          else
            for (int e = tid; e < zcr * HH; e += kFwdThreads)
              s_z[e / HH * zs + e % HH] = ldcg_raw(src + e);
        }
#pragma unroll
        for (int i = 0; i < kStage; ++i) {
          const int e = e0 + i * kFwdThreads;
          if (e >= HH * nz) break;
          const int k = e / nz;
          s_whz[k * zm + e - k * nz] = wv[i];
        }
      }
      if (zc > 0 || HH * nz <= tid) {  // rows the loop above did not stage
        const W* src = hhout + (size_t)(b0 + zc) * HH;
        if (async_hh)
          stage_rows_ld(reinterpret_cast<float*>(s_z),
                        zs * (int)sizeof(W) / 4,
                        reinterpret_cast<const float*>(src), zcr,
                        HH * (int)sizeof(W) / 4);
        else
          for (int e = tid; e < zcr * HH; e += kFwdThreads)
            s_z[e / HH * zs + e % HH] = ldcg_raw(src + e);
      }
      __syncthreads();  // w_hz's columns and the pass's rows of hh_t
      for (int e = tid; e < zcr * (nz / 4); e += kFwdThreads)
        hf_z_quad<W>(s_z, zs, s_whz, zm, e / (nz / 4), e % (nz / 4), HH, o_lo,
                     E4, p.b_hz[0], p.b_hz[1], wk.z + (size_t)(b0 + zc) * Z,
                     Z);
      __syncthreads();  // s_z read: the next pass may write it
    }
    grid.sync();  // z complete
    // (3) xp, the block scales, pre and the gates' slice moments
    for (int ch = 0; ch < nb; ch += chunk) {
      const int cr = nb - ch < chunk ? nb - ch : chunk;
      const bool busy = warp < (cr + TR - 1) / TR;
      stage_rows_ld(s_ex, ZS, wk.z + (size_t)(b0 + ch) * Z, cr, Z);
      __syncthreads();  // this pass's rows of z in s_ex
      if (busy) {
        float xp[kHfRows][4], hp[kHfRows][4], sc[kHfRows][12];
        const float* zrow[kHfRows];
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
          const int lrc = lr < cr ? lr : 0;
          const int row = b0 + ch + lrc;
          zrow[rr] = s_ex + (size_t)lrc * ZS;
          const float* x = a.xs + ((size_t)t * B + row) * D;
#pragma unroll
          for (int g = 0; g < 4; ++g) xp[rr][g] = 0.0f;
          for (int q = 0; q < D; ++q) {  // x @ wx, one in-order chain
            const float xq = rnd<W>(x[q]);
            const float4 w = quad(s_wx + ((size_t)q * U + u) * 4);
            xp[rr][0] = fmaf(xq, w.x, xp[rr][0]);
            xp[rr][1] = fmaf(xq, w.y, xp[rr][1]);
            xp[rr][2] = fmaf(xq, w.z, xp[rr][2]);
            xp[rr][3] = fmaf(xq, w.w, xp[rr][3]);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const size_t at = (size_t)row * G + g * H + j;
            if (p.xb != nullptr) xp[rr][g] = __fadd_rn(xp[rr][g], p.xb[at]);
            hp[rr][g] = __ldcg(wk.hp + at);
          }
#pragma unroll
          for (int c = 0; c < 12; ++c) sc[rr][c] = 0.0f;
        }
        // s_p[g] = z_p[g e : g e + e] . zd_p[g][:, j], one in-order chain a
        // (path, gate)
        const float* zdu = s_zd + (size_t)u * ez;
        if (E % 4 == 0) {
          for (int q = 0; q < E; q += 4) {
#pragma unroll
            for (int c0 = 0; c0 < 12; c0 += 4) {  // one path's four gates
              float4 w[4], z[kHfRows][4];
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                w[cc] = quad(zdu + (size_t)(c0 + cc) * U * ez + q);
#pragma unroll
                for (int rr = 0; rr < kHfRows; ++rr)
                  z[rr][cc] = quad(zrow[rr] + (c0 / 4) * E4 + cc * E + q);
              }
              // q's four values in order, each step 8 independent chains
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int rr = 0; rr < kHfRows; ++rr)
                  sc[rr][c0 + cc] = fmaf(z[rr][cc].x, w[cc].x, sc[rr][c0 + cc]);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int rr = 0; rr < kHfRows; ++rr)
                  sc[rr][c0 + cc] = fmaf(z[rr][cc].y, w[cc].y, sc[rr][c0 + cc]);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int rr = 0; rr < kHfRows; ++rr)
                  sc[rr][c0 + cc] = fmaf(z[rr][cc].z, w[cc].z, sc[rr][c0 + cc]);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
#pragma unroll
                for (int rr = 0; rr < kHfRows; ++rr)
                  sc[rr][c0 + cc] = fmaf(z[rr][cc].w, w[cc].w, sc[rr][c0 + cc]);
            }
          }
        } else {
          for (int q = 0; q < E; ++q) {
#pragma unroll
            for (int c = 0; c < 12; ++c) {
              const float w = zdu[(size_t)c * U * ez + q];
              const int off = (c / 4) * E4 + (c % 4) * E + q;
#pragma unroll
              for (int rr = 0; rr < kHfRows; ++rr)
                sc[rr][c] = fmaf(zrow[rr][off], w, sc[rr][c]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[rr][g] = __fadd_rn(
                __fadd_rn(__fadd_rn(__fmul_rn(sc[rr][g], xp[rr][g]),
                                    __fmul_rn(sc[rr][4 + g], hp[rr][g])),
                          sc[rr][8 + g]),
                lnp[8 + g]);
          float mean[4], m2[4];
          hf_moments<U>(pre[rr], unit, fn, mean, m2);
          if (lr >= cr) continue;
          const int row = b0 + ch + lr;
          if (u == 0) {
            float4* dst = reinterpret_cast<float4*>(
                wk.exg + ((size_t)row * slices + sl) * 8);
            dst[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
            dst[1] = make_float4(m2[0], m2[1], m2[2], m2[3]);
          }
          if (multi && unit) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              stash[((size_t)g * B + row) * H + j] = pre[rr][g];
          }
        }
      }
      __syncthreads();  // s_ex read: next pass
    }
    grid.sync();  // the gates' slice moments complete
    // (4) the gates' row statistics, the gate block, the cell's moments
    for (int ch = 0; ch < nb; ch += chunk) {
      const int cr = nb - ch < chunk ? nb - ch : chunk;
      const bool busy = warp < (cr + TR - 1) / TR;
      stage_ex<float4>(s_ex, wk.exg, (size_t)(b0 + ch) * slices * 8,
                       cr * slices * 2);
      __syncthreads();  // this pass's rows of the exchange in s_ex
      if (busy) {
        // lane u combines gate u % 4 of each of its rows; the unit group
        // shares them
        const float* ex[kHfRows];
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
          ex[rr] = s_ex + (size_t)(lr < cr ? lr : 0) * slices * 8 + (u & 3);
        }
        float gm[kHfRows], gr[kHfRows];
        hf_chan(ex, 8, 4, s_n, slices, fh, gm, gr);
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
          const bool ok = lr < cr;
          const int row = b0 + ch + (ok ? lr : 0);
          float mean[4], rsg[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            mean[g] = __shfl_sync(0xffffffffu, gm[rr], half | g);
            rsg[g] = __shfl_sync(0xffffffffu, gr[rr], half | g);
          }
          if (multi && ok && unit) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              pre[rr][g] = stash[((size_t)g * B + row) * H + j];
          }
          const float c = s_c[(size_t)(ch + (ok ? lr : 0)) * U + u];
          const float m = dropout_mask(a.drop, seed, t, B, row, H, j);
          float y[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            y[g] = (pre[rr][g] - mean[g]) * rsg[g] * lnp[g] + lnp[4 + g];
          const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
          const float f = sigmoidf_(y[2] + p.forget_bias);
          keep_o[rr] = sigmoidf_(y[3]);
          keep_c[rr] = c * f + i * (gu * m);
          float cm[1], cq[1];
          const float nc[1] = {keep_c[rr]};
          hf_moments<U>(nc, unit, fn, cm, cq);
          if (!ok) continue;
          if (u == 0)
            reinterpret_cast<float2*>(wk.exc)[(size_t)row * slices + sl] =
                make_float2(cm[0], cq[0]);
          if (multi && unit) {
            stash[(size_t)row * H + j] = keep_c[rr];
            stash[((size_t)B + row) * H + j] = keep_o[rr];
          }
        }
      }
      __syncthreads();  // s_ex read: next pass
    }
    grid.sync();  // the cell's slice moments complete
    // (5) the cell norm, h and the stores
    for (int ch = 0; ch < nb; ch += chunk) {
      const int cr = nb - ch < chunk ? nb - ch : chunk;
      const bool busy = warp < (cr + TR - 1) / TR;
      stage_ex<float2>(s_ex, wk.exc, (size_t)(b0 + ch) * slices * 2,
                       cr * slices);
      __syncthreads();  // this pass's rows of the exchange in s_ex
      if (busy) {
        const float* ex[kHfRows];
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
          ex[rr] = s_ex + (size_t)(lr < cr ? lr : 0) * slices * 2;
        }
        float cmean[kHfRows], crs[kHfRows];
        hf_chan(ex, 2, 1, s_n, slices, fh, cmean, crs);
#pragma unroll
        for (int rr = 0; rr < kHfRows; ++rr) {
          const int lr = lr0 + rr * RL;
          if (lr >= cr || !unit) continue;
          const int row = b0 + ch + lr;
          float nc = keep_c[rr], o = keep_o[rr];
          if (multi) {
            nc = stash[(size_t)row * H + j];
            o = stash[((size_t)B + row) * H + j];
          }
          const float yc = (nc - cmean[rr]) * crs[rr] * lnp[12] + lnp[13];
          const float nh = tanhf(yc) * o;
          float* cp = s_c + (size_t)(ch + lr) * U + u;
          const size_t at = ((size_t)t * B + row) * H + j;
          a.cs[at] = from_f<R>(*cp);
          a.hs[at] = from_f<R>(nh);
          hout[(size_t)row * H + j] = from_f<W>(nh);
          *cp = nc;
          if (t == a.T - 1) {
            a.cT[(size_t)row * H + j] = nc;
            a.hT[(size_t)row * H + j] = nh;
          }
        }
      }
      __syncthreads();  // s_ex read: next pass
    }
    grid.sync();  // hx and h_t complete
  }
  if (a.T == 0) {  // no step: the final carries are the first
    for (int q = tid; q < nb * U; q += kFwdThreads) {
      if (q % U >= nu) continue;
      const size_t at = (size_t)(b0 + q / U) * H + j0 + q % U;
      a.cT[at] = a.c0[at];
      a.hT[at] = a.h0[at];
    }
    for (int q = tid; q < enb * a4; q += kFwdThreads) {
      if (q % a4 >= ena) continue;
      const size_t at = (size_t)(eb0 + q / a4) * HH + ek0 + q % a4;
      a.hcT[at] = a.hc0[at];
      a.hhT[at] = a.hh0[at];
    }
  }
}

template <typename W, typename R>
const void* hyper_fwd_fn(int units) {
  return units == 16 ? (const void*)hyper_fwd_loop_kernel<W, R, 16>
                     : (const void*)hyper_fwd_loop_kernel<W, R, 8>;
}

// The plan checked against the shape before any launch: an error, never a
// fallback (cudaErrorInvalidValue where the plan does not hold the shape;
// persist.cuh's checks where its blocks cannot co-reside).
template <typename W, typename R>
cudaError_t hyper_fwd_check(const HyperFwd<W, R>& a, const HyperFwdPlan& pl,
                            Windows& win) {
  const int H = a.p.H, HH = a.p.HH, B = a.B, U = pl.units, F = pl.split;
  if (!((U == 16 && F == 2) || (U == 8 && F == 1)) || pl.slices < 1 ||
      pl.slices > 64 || (H + pl.slices - 1) / pl.slices > U ||
      (HH + pl.slices - 1) / pl.slices > U || pl.tiles < F ||
      pl.tiles % F != 0 || pl.windows < 1 || pl.windows > B ||
      pl.pchunk < 1 || pl.smem < 0)
    return cudaErrorInvalidValue;
  const int tr = 32 / U * kHfRows;
  // float: a warp a products task (per of each 16 rows); bf16: at most
  // two a warp, so the same bound holds both
  const int per = 2 + 2 * (hf_aux4(HH, pl.slices, F) / kPUnits);
  if (pl.chunk < tr || pl.chunk % tr != 0 || pl.chunk > kFwdWarps * tr ||
      (pl.pchunk + kPTaskRows - 1) / kPTaskRows * per > kFwdWarps)
    return cudaErrorInvalidValue;
  win.n = pl.windows;
  win.smem = (size_t)pl.smem;
  int tiles0 = 0;
  for (int i = 0; i < win.n; ++i) {  // every window's tiles, a multiple of F
    const int nr = win.rows(i, B);
    const int tiles = (nr < pl.tiles ? nr : pl.tiles) / F * F;
    if (tiles < F) return cudaErrorInvalidValue;
    if (tiles > tiles0) tiles0 = tiles;
    if (hyper_fwd_smem_floats(U, F, pl.slices, (nr + tiles - 1) / tiles,
                              a.p.D, H, HH, a.p.E, pl.pchunk, pl.chunk) *
            sizeof(float) > win.smem)
      return cudaErrorInvalidValue;
  }
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(sms, smem_max);
  if (err == cudaSuccess)
    err = ready_loop(hyper_fwd_fn<W, R>(U), kFwdThreads, win,
                     pl.slices * tiles0, sms);
  return err;
}

// srt_hyper_fwd: the plan checked, then one cooperative launch a window.
template <typename W, typename R>
cudaError_t launch_hyper_fwd(const HyperFwd<W, R>& a, W* hx, float* work,
                             const HyperFwdPlan& pl, cudaStream_t stream) {
  if (a.B < 1 || a.T < 0 || hx == nullptr || work == nullptr)
    return cudaErrorInvalidValue;
  Windows win;
  cudaError_t err = hyper_fwd_check(a, pl, win);
  const HyperFwdWork wk0 = hyper_fwd_work(work, a.B, a.p.H, a.p.E, pl.slices);
  const void* fn = hyper_fwd_fn<W, R>(pl.units);
  for (int i = 0; i < win.n && err == cudaSuccess; ++i) {
    int r0 = win.first(i, a.B), nr = win.rows(i, a.B);
    int slices = pl.slices, pchunk = pl.pchunk, chunk = pl.chunk;
    int tiles = (nr < pl.tiles ? nr : pl.tiles) / pl.split * pl.split;
    HyperFwd<W, R> args = a;
    W* hxp = hx;
    HyperFwdWork wk = wk0;
    void* params[] = {&args,   &hxp,   &wk, &slices, &tiles,
                      &pchunk, &chunk, &r0, &nr};
    err = cudaLaunchCooperativeKernel(fn, dim3(slices * tiles),
                                      dim3(kFwdThreads), params, win.smem,
                                      stream);
  }
  return err;
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


// srt_hyper_fwd's and srt_hyper_fwd_rowblock's arguments as a HyperFwd
template <typename W, typename R>
HyperFwd<W, R> make_hyper_fwd(
    const float* xs, const float* xb, const float* xbh, const void* wx,
    const float* b, const void* wh, const void* wxh_x, const void* wxh_h,
    const float* bh, const void* whh, const void* w_hz_x, const float* b_hz_x,
    const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
    const float* zd_x, const float* zd_h, const float* zd_b,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* c0, const float* h0, const float* hc0,
    const float* hh0, const float* masks, const int* seed, int T, int B,
    int D, int H, int HH, int E, float keep, float inv_keep,
    float forget_bias, void* hs, void* cs, void* hycs, void* hyhs, float* cT,
    float* hT, float* hcT, float* hhT) {
  HyperFwd<W, R> a;
  a.p = make_hyper_cell<W>(wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
                           w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma,
                           ln_beta, lnc_gamma, lnc_beta, xb, xbh, D, H, HH, E,
                           forget_bias);
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
  return a;
}

// The new design's entries (header, "Design of the backward"): the Bwd
// view of the main cell and the HyperLSTM's own operands, the streams and
// the work carved from their scratch, the plan, then launch_hyper_bwd.
template <typename W, typename R>
cudaError_t hyper_bwd_any(
    int stage, const float* xs, const float* xb, const float* xbh,
    const void* wx, const float* b, const void* wh, const void* wxh_x,
    const void* wxh_h, const float* bh, const void* whh, const void* w_hz_x,
    const float* b_hz_x, const void* w_hz_h, const float* b_hz_h,
    const void* w_hz_b, const float* zd_x, const float* zd_h,
    const float* zd_b, const float* ln_gamma, const float* ln_beta,
    const float* lnc_gamma, const float* lnc_beta, const float* h0,
    const float* hh0, const void* hs, const void* cs, const void* hycs,
    const void* hyhs, const void* dhs, const float* dcT, const float* dhT,
    const float* dhcT, const float* dhhT, const float* masks, const int* seed,
    int T, int B, int D, int H, int HH, int E, float keep, float inv_keep,
    float forget_bias, const HyperPlan& pl, float* streams, float* work,
    float* wg_part, int wg_floats, float* dxs, float* dxb, float* dxbh,
    const HyperMatGrads& d, float* dvec, float* dc0, float* dh0,
    float* dhc0, float* dhh0, cudaStream_t stream) {
  if (!hyper_sizes_ok(D, H, HH, E) || B < 1 || T < 0 || streams == nullptr ||
      work == nullptr || wg_part == nullptr || (xb == nullptr) != (xbh == nullptr))
    return cudaErrorInvalidValue;
  Bwd<W, R> a;
  a.p = make_cell<W>(wx, wh, nullptr, nullptr, ln_gamma, ln_beta, lnc_gamma,
                     lnc_beta, D, H, forget_bias);
  a.xs = xs;
  a.h0 = h0;
  a.hs = static_cast<const R*>(hs);
  a.cs = static_cast<const R*>(cs);
  a.dhs = static_cast<const R*>(dhs);
  a.dcT = dcT;
  a.dhT = dhT;
  a.drop = make_dropout(masks, seed, keep, inv_keep);
  a.dxs = dxs;
  a.dxb = dxb;
  a.dc0 = dc0;
  a.dh0 = dh0;
  a.part = work;
  a.wg = {0, 0, nullptr};
  a.T = T;
  a.B = B;
  HyperArgs<W, R> h;
  h.wxh_x = static_cast<const W*>(wxh_x);
  h.wxh_h = static_cast<const W*>(wxh_h);
  h.bh = bh;
  h.whh = static_cast<const W*>(whh);
  h.w_hz[0] = static_cast<const W*>(w_hz_x);
  h.w_hz[1] = static_cast<const W*>(w_hz_h);
  h.w_hz[2] = static_cast<const W*>(w_hz_b);
  h.b_hz[0] = b_hz_x;
  h.b_hz[1] = b_hz_h;
  h.zd[0] = zd_x;
  h.zd[1] = zd_h;
  h.zd[2] = zd_b;
  h.b = b;
  h.xb = xb;
  h.xbh = xbh;
  h.hh0 = hh0;
  h.hycs = static_cast<const R*>(hycs);
  h.hyhs = static_cast<const R*>(hyhs);
  h.dhcT = dhcT;
  h.dhhT = dhhT;
  h.HH = HH;
  h.E = E;
  h.P = 14 * H + 4 * HH + 8 * E;
  carve_streams(h, streams, T, B, H);
  a.dpre = h.pre;
  const LnWork w = ln_work(work + ((size_t)B * h.P + 3) / 4 * 4, T, B, H,
                           pl.slices);
  h.exz = w.dxh + 4 * (size_t)B * H;
  h.dhx = h.exz + (size_t)B * pl.slices * 12 * E;
  h.dhhx = h.dhx + (size_t)B * H;
  h.dxbh = dxbh;
  h.dhc0 = dhc0;
  h.dhh0 = dhh0;
  return launch_hyper_bwd(a, h, pl, w, wg_part, wg_floats, d, dvec, stage,
                          stream);
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

// The forward (header, "Design of the forward"): the persistent loop on
// the plan (units, split, slices, tiles, windows, pchunk, chunk, smem) of
// cuda_fused.hyper_fwd_plan. Scratch: hx (2 B (H + HH) elements of the
// weight type: the h and hh exchanges) and work (float32,
// cuda_fused.hyper_fwd_work_floats), any contents. A plan that does not
// hold the shape is cudaErrorInvalidValue, blocks that cannot co-reside
// cudaErrorCooperativeLaunchTooLarge: never another design.
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
                  int units, int split, int slices, int tiles, int windows,
                  int pchunk, int chunk, int smem, void* hx, float* work,
                  void* hs, void* cs, void* hycs, void* hyhs, float* cT,
                  float* hT, float* hcT, float* hhT, void* stream) {
  const HyperFwdPlan pl = {units, split, slices, tiles,
                           windows, pchunk, chunk, smem};
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    using W = decltype(w);
    using R = decltype(r);
    if (!hyper_sizes_ok(D, H, HH, E) || (xb == nullptr) != (xbh == nullptr))
      return cudaErrorInvalidValue;
    const HyperFwd<W, R> a = make_hyper_fwd<W, R>(
        xs, xb, xbh, wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x, w_hz_h,
        b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma, ln_beta, lnc_gamma,
        lnc_beta, c0, h0, hc0, hh0, masks, seed, T, B, D, H, HH, E, keep,
        inv_keep, forget_bias, hs, cs, hycs, hyhs, cT, hT, hcT, hhT);
    return launch_hyper_fwd(a, static_cast<W*>(hx), work, pl,
                            (cudaStream_t)stream);
  });
}

// The row-block design srt_hyper_fwd replaced (hyper_fwd_kernel, one block
// per batch row), kept to hold and time the new design beside it: the
// arguments of srt_hyper_fwd without the plan and the scratch.
int srt_hyper_fwd_rowblock(
    const float* xs, const float* xb, const float* xbh, const void* wx,
    const float* b, const void* wh, const void* wxh_x, const void* wxh_h,
    const float* bh, const void* whh, const void* w_hz_x, const float* b_hz_x,
    const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
    const float* zd_x, const float* zd_h, const float* zd_b,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* c0, const float* h0, const float* hc0,
    const float* hh0, const float* masks, const int* seed, int T, int B,
    int D, int H, int HH, int E, int w_bf16, int r_bf16, float keep,
    float inv_keep, float forget_bias, void* hs, void* cs, void* hycs,
    void* hyhs, float* cT, float* hT, float* hcT, float* hhT, void* stream) {
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    using W = decltype(w);
    using R = decltype(r);
    if (!hyper_sizes_ok(D, H, HH, E)) return cudaErrorInvalidValue;
    const HyperFwd<W, R> a = make_hyper_fwd<W, R>(
        xs, xb, xbh, wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x, w_hz_h,
        b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma, ln_beta, lnc_gamma,
        lnc_beta, c0, h0, hc0, hh0, masks, seed, T, B, D, H, HH, E, keep,
        inv_keep, forget_bias, hs, cs, hycs, hyhs, cT, hT, hcT, hhT);
    const size_t smem = (size_t)step_smem_floats(D, H, HH, E) * sizeof(float);
    cudaError_t err = set_smem((const void*)hyper_fwd_kernel<W, R>, smem);
    if (err != cudaSuccess) return err;
    hyper_fwd_kernel<W, R>
        <<<B, hyper_threads(H, HH), smem, (cudaStream_t)stream>>>(a);
    return cudaGetLastError();
  });
}

// The backward (header, "Design of the backward"): the six stages on the
// plan (units, split, slices, tiles, windows, parts, smem) of
// cuda_fused.hyper_bwd_plan. Scratch (float32, any contents): streams
// (cuda_fused.hyper_stream_floats), work (hyper_work_floats), wg_part of
// wg_floats floats (the largest product's partials). Outputs as
// srt_hyper_bwd_rowblock's. A plan that does not hold the shape, or
// partials that do not fit, is cudaErrorInvalidValue; blocks that cannot
// co-reside cudaErrorCooperativeLaunchTooLarge: never another design.
int srt_hyper_bwd(
    const float* xs, const float* xb, const float* xbh, const void* wx,
    const float* b, const void* wh, const void* wxh_x, const void* wxh_h,
    const float* bh, const void* whh, const void* w_hz_x, const float* b_hz_x,
    const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
    const float* zd_x, const float* zd_h, const float* zd_b,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* h0, const float* hh0, const void* hs,
    const void* cs, const void* hycs, const void* hyhs, const void* dhs,
    const float* dcT, const float* dhT, const float* dhcT, const float* dhhT,
    const float* masks, const int* seed, int T, int B, int D, int H, int HH,
    int E, int w_bf16, int r_bf16, float keep, float inv_keep,
    float forget_bias, int units, int split, int slices, int tiles,
    int windows, int parts, int smem, float* streams, float* work,
    float* wg_part,
    int wg_floats, float* dxs, float* dxb, float* dxbh, float* dwx,
    float* dwh, float* dwxh_x, float* dwxh_h, float* dwhh, float* dw_hz_x,
    float* dw_hz_h, float* dw_hz_b, float* dzd_x, float* dzd_h, float* dzd_b,
    float* dvec, float* dc0, float* dh0, float* dhc0, float* dhh0,
    void* stream) {
  const HyperPlan pl = {units, split, slices, tiles, windows, parts, smem};
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
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    return hyper_bwd_any<decltype(w), decltype(r)>(
        0, xs, xb, xbh, wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
        w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma, ln_beta,
        lnc_gamma, lnc_beta, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT,
        dhhT, masks, seed, T, B, D, H, HH, E, keep, inv_keep, forget_bias, pl,
        streams, work, wg_part, wg_floats, dxs, dxb, dxbh, d, dvec, dc0, dh0,
        dhc0, dhh0, (cudaStream_t)stream);
  });
}

// One stage of srt_hyper_bwd alone (1 the recompute, 2 the statistics, 3
// the loop, 4 dxs, 5 the products, 6 the row sums), on the buffers the
// stages before it left, to time the split.
int srt_hyper_bwd_stage(
    int stage, const float* xs, const float* xb, const float* xbh,
    const void* wx, const float* b, const void* wh, const void* wxh_x, const void* wxh_h,
    const float* bh, const void* whh, const void* w_hz_x, const float* b_hz_x,
    const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
    const float* zd_x, const float* zd_h, const float* zd_b,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* h0, const float* hh0, const void* hs,
    const void* cs, const void* hycs, const void* hyhs, const void* dhs,
    const float* dcT, const float* dhT, const float* dhcT, const float* dhhT,
    const float* masks, const int* seed, int T, int B, int D, int H, int HH,
    int E, int w_bf16, int r_bf16, float keep, float inv_keep,
    float forget_bias, int units, int split, int slices, int tiles,
    int windows, int parts, int smem, float* streams, float* work,
    float* wg_part,
    int wg_floats, float* dxs, float* dxb, float* dxbh, float* dwx,
    float* dwh, float* dwxh_x, float* dwxh_h, float* dwhh, float* dw_hz_x,
    float* dw_hz_h, float* dw_hz_b, float* dzd_x, float* dzd_h, float* dzd_b,
    float* dvec, float* dc0, float* dh0, float* dhc0, float* dhh0,
    void* stream) {
  const HyperPlan pl = {units, split, slices, tiles, windows, parts, smem};
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
  if (stage < 1 || stage > 6) return (int)cudaErrorInvalidValue;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) -> cudaError_t {
    return hyper_bwd_any<decltype(w), decltype(r)>(
        stage, xs, xb, xbh, wx, b, wh, wxh_x, wxh_h, bh, whh, w_hz_x, b_hz_x,
        w_hz_h, b_hz_h, w_hz_b, zd_x, zd_h, zd_b, ln_gamma, ln_beta,
        lnc_gamma, lnc_beta, h0, hh0, hs, cs, hycs, hyhs, dhs, dcT, dhT, dhcT,
        dhhT, masks, seed, T, B, D, H, HH, E, keep, inv_keep, forget_bias, pl,
        streams, work, wg_part, wg_floats, dxs, dxb, dxbh, d, dvec, dc0, dh0,
        dhc0, dhh0, (cudaStream_t)stream);
  });
}

// The row-block design the backward replaced (one block per batch row,
// then tn_gemm_kernel's eleven products), kept to hold and time the new
// design beside it. Scratch (float32, any contents): s_dpre, s_dxp, s_dhp,
// s_dsx, s_dsh
// [T, B, 4H]; s_dhpre [T, B, 4HH]; s_zs, s_dzs [3, T, B, 4e]; s_hhn
// [T, B, HH]; s_part [B, 14H + 4HH + 8e]. Outputs: the matrices' gradients
// as float32 in the matrices' shapes; dvec [14H + 4HH + 8e] = dln_gamma 4H |
// dln_beta 4H | dlnc_gamma H | dlnc_beta H | db 4H | dbh 4HH | db_hz_x 4e |
// db_hz_h 4e; dxb / dxbh null when xb / xbh are.
int srt_hyper_bwd_rowblock(
    const float* xs, const float* xb, const float* xbh, const void* wx,
    const float* b, const void* wh, const void* wxh_x, const void* wxh_h,
    const float* bh, const void* whh, const void* w_hz_x, const float* b_hz_x,
    const void* w_hz_h, const float* b_hz_h, const void* w_hz_b,
    const float* zd_x, const float* zd_h, const float* zd_b,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* h0, const float* hh0, const void* hs,
    const void* cs, const void* hycs, const void* hyhs, const void* dhs,
    const float* dcT, const float* dhT, const float* dhcT, const float* dhhT,
    const float* masks, const int* seed, int T, int B, int D, int H, int HH,
    int E, int w_bf16, int r_bf16, float keep, float inv_keep,
    float forget_bias, float* s_dpre, float* s_dxp, float* s_dhp,
    float* s_dsx, float* s_dsh, float* s_dhpre, float* s_zs, float* s_dzs,
    float* s_hhn, float* s_part, float* dxs, float* dxb, float* dxbh,
    float* dwx, float* dwh, float* dwxh_x, float* dwxh_h, float* dwhh,
    float* dw_hz_x, float* dw_hz_h, float* dw_hz_b, float* dzd_x,
    float* dzd_h, float* dzd_b, float* dvec, float* dc0, float* dh0,
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
    return launch_hyper_bwd_rowblock(a, d, dvec, (cudaStream_t)stream);
  });
}

}  // extern "C"
