// The LayerNorm-LSTM gate block's backward inside a persistent cooperative
// loop of the PyTorch port, shared by two users: fused_rnn.cu's
// LayerNorm-LSTM backward (srt_ln_lstm_bwd's loop, row 5b, slices of
// kUnits = 16 units) and fused_hyper.cu's HyperLSTM backward
// (srt_hyper_bwd's loop, row 6b, slices of 16 or 8 units). fused_rnn.cu's
// header has the design ("Design of the LayerNorm-LSTM backward"): the
// hoisted statistics (ln_stats_kernel, one block per row-step), then per
// step three phases each ended by a grid barrier, (a) the cell norm's
// partials, (b) its row sums in slice order, the LN-parameter sums and
// the gate norms' partials, (c) their row sums in slice order and d_pre.
// Phase (c) hands each pair's d_pre to an Emit policy: LnDpre (row 5b)
// writes it over pre and adds the dx_bias sums; the HyperLSTM's writes
// d_pre and its four products with the scales and projections. The
// statistics come from a second policy: the hoisted launch's (rows 5b and
// 6b) or, for two arms of the LayerNorm ladder (probe_ln.cu), stand-ins.
// Everything sits in an unnamed namespace: each translation unit gets its
// own copy.

#pragma once

#include "lstm_loops.cuh"
#include "rnn_common.cuh"

namespace {

constexpr int kLnStats = 10;  // per row-step: mean[4], rs[4], cmean, crs

// The scratch of the launches after the recompute, carved from one float
// buffer in this order (16-byte aligned first): the per-slice partials of
// the gate norms' row sums (exchange (b), [B][slices][8]) and of the cell
// norm's (exchange (a), [B][slices][2]), the hoisted statistics
// ([T * B][kLnStats]) and each pair's dxh = dy * gamma from (b) to (c)
// ([4][B][H]).
struct LnWork {
  float* exb;
  float* exa;
  float* stats;
  float* dxh;
};

LnWork ln_work(float* work, int T, int B, int H, int slices) {
  LnWork w;
  w.exb = work;
  w.exa = w.exb + (size_t)B * slices * 8;
  w.stats = w.exa + (size_t)B * slices * 2;
  w.dxh = w.stats + (size_t)T * B * kLnStats;
  return w;
}

// 2. The statistics of every row-step, which depend on nothing the loop
// computes: one block per row-step (threads_for(H) threads, one per
// unit), gate_stats of the recomputed pre, the gate block up to the new
// cell state, row_stats of it: the row-block design's sums in its order.
template <typename W, typename R>
__global__ void __launch_bounds__(kMaxThreads)
ln_stats_kernel(Bwd<W, R> a, float* stats) {
  __shared__ float s_red[33 * kRedMax];
  const Cell<W>& p = a.p;
  const int H = p.H, B = a.B, j = threadIdx.x;
  const int m = blockIdx.x, s = m / B, row = m - s * B;
  const bool own = j < H;
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;
  float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c_prev = 0.0f, mk = 1.0f;
  if (own) {
    const float* pr = a.dpre + (size_t)m * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = pr[g * H + j];
    c_prev = to_f(a.cs[(size_t)m * H + j]);
    mk = dropout_mask(a.drop, seed, s, B, row, H, j);
  }
  float mean[4], rs[4], y[4];
  gate_stats(pre, own, H, s_red, mean, rs);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float xhat = (pre[g] - mean[g]) * rs[g];
    y[g] = own ? xhat * p.ln_gamma[g * H + j] + p.ln_beta[g * H + j] : 0.0f;
  }
  const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
  const float f = sigmoidf_(y[2] + p.forget_bias);
  const float nc = c_prev * f + i * (gu * mk);
  float cmean, crs;
  row_stats(nc, own, H, s_red, cmean, crs);
  if (j == 0) {
    float* st = stats + (size_t)m * kLnStats;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      st[g] = mean[g];
      st[4 + g] = rs[g];
    }
    st[8] = cmean;
    st[9] = crs;
  }
}

// Where the loop's layer-norm statistics come from, a compile-time policy.
// LnStatsHoisted (rows 5b, 6b): the statistics launch's [T * B][kLnStats]
// scratch. LnStatsStandIn (the ladder's no_ln and fake arms, probe_ln.cu):
// the reference probes' stand-ins, built from the row's stored pre-step cell
// state, mean = cs[s, row, 0] * 1e-3 and rs = 1 + cs[s, row, 1] * 1e-3 for
// the four gates and the cell, whose new state is then built without the
// mask and hands on g_u * m (masked again by the backward).
struct LnStatsHoisted {
  static constexpr bool kStandIn = false;
};
struct LnStatsStandIn {
  static constexpr bool kStandIn = true;
};

// Sum N values over the U lanes of one row's units (a half warp at U =
// kUnits); every lane gets the same sums. All 32 lanes must call it.
template <int U, int N>
__device__ __forceinline__ void unit_sum(float (&v)[N]) {
#pragma unroll
  for (int off = U / 2; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < N; ++g)
      v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
}

template <int N>
__device__ __forceinline__ void half_warp_sum(float (&v)[N]) {
  unit_sum<kUnits>(v);
}

constexpr int kLnRows = kLoopThreads / kUnits;  // rows per pass over pairs

// n elements of type V (float, or float4 where 16-byte aligned) of an
// exchange, from ex + first (in floats) on, written by other blocks of
// the kernel, into s_ex: one coalesced copy through L2 by the whole block,
// four loads in flight per thread, so that the half warps' in-order sums
// over the slices read shared memory instead of waiting on one L2 load
// after another. A __syncthreads must follow.
template <typename V>
__device__ __forceinline__ void stage_ex(float* s_ex, const float* ex,
                                         size_t first, int n) {
  const V* src = reinterpret_cast<const V*>(ex + first);
  V* dst = reinterpret_cast<V*>(s_ex);
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * kLoopThreads) {
    V v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i * kLoopThreads < n)
        v[i] = __ldcg(src + e0 + i * kLoopThreads);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + i * kLoopThreads < n) dst[e0 + i * kLoopThreads] = v[i];
  }
}

// The gate block of one (row, unit) pair up to the cell norm's input
// gradient, from the hoisted pre, the row's statistics st and the pair's
// c_prev, mask m and dh_tot: ln_gates_bwd before its first block sum (with
// STANDIN, the stand-in forward's: the new cell state without the mask, gu
// handed on masked).
struct LnPair {
  float xhat[4], i, gu, f, o, xhat_c, crs, do_, dyc, c_prev, m;
};

template <bool STANDIN = false>
__device__ __forceinline__ LnPair ln_pair(const float (&pre)[4],
                                          const float (&st)[kLnStats],
                                          float c_prev, float m,
                                          float dh_tot, const float (&gam)[4],
                                          const float (&bet)[4], float gc,
                                          float bc, float forget_bias) {
  LnPair r;
  r.c_prev = c_prev;
  r.m = m;
  r.crs = st[9];
  float y[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    r.xhat[g] = (pre[g] - st[g]) * st[4 + g];
    y[g] = r.xhat[g] * gam[g] + bet[g];
  }
  r.i = sigmoidf_(y[0]);
  r.gu = tanhf(y[1]);
  r.f = sigmoidf_(y[2] + forget_bias);
  r.o = sigmoidf_(y[3]);
  float nc;
  if constexpr (STANDIN) {
    nc = c_prev * r.f + r.i * r.gu;
    r.gu = r.gu * m;
  } else {
    nc = c_prev * r.f + r.i * (r.gu * m);
  }
  r.xhat_c = (nc - st[8]) * st[9];
  const float yc = r.xhat_c * gc + bc;
  const float tanh_yc = tanhf(yc);
  r.do_ = dh_tot * tanh_yc;
  r.dyc = dh_tot * r.o * (1.0f - tanh_yc * tanh_yc);
  return r;
}


// A block's share of the LN phases: its slice (units j0 .. j0 + nu - 1 of
// U lanes a row) and batch tile (rows b0 .. b0 + nb - 1), the dh parts of
// its pairs (s_part, [parts][nb_max][U]), an exchange staging buffer
// (s_ex, a pass's rows), the row stride of the LN-parameter partials in
// Bwd::part, and the unit's LN parameters. Thread tid owns the pairs q =
// tid + k * kLoopThreads, all of unit j0 + tid % U.
template <int U>
struct LnCtx {
  float* s_part;
  float* s_ex;
  int slices, sl, j0, nu, b0, nb, plane, parts, pstride, u, j;
  bool unit;
  uint32_t seed;
  float fh, gam[4], bet[4], gc, bc;
};

template <int U, typename W, typename R>
__device__ __forceinline__ LnCtx<U> ln_ctx(const Bwd<W, R>& a,
                                           float* s_part, float* s_ex,
                                           int slices, int sl, int j0, int nu,
                                           int b0, int nb, int nb_max,
                                           int parts, int pstride) {
  const Cell<W>& p = a.p;
  const int H = p.H;
  LnCtx<U> c;
  c.s_part = s_part;
  c.s_ex = s_ex;
  c.slices = slices;
  c.sl = sl;
  c.j0 = j0;
  c.nu = nu;
  c.b0 = b0;
  c.nb = nb;
  c.plane = nb_max * U;
  c.parts = parts;
  c.pstride = pstride;
  c.u = threadIdx.x % U;
  c.unit = c.u < nu;
  c.j = j0 + (c.unit ? c.u : 0);
  c.seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;
  c.fh = (float)H;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    c.gam[g] = c.unit ? p.ln_gamma[g * H + c.j] : 0.0f;
    c.bet[g] = c.unit ? p.ln_beta[g * H + c.j] : 0.0f;
  }
  c.gc = c.unit ? p.lnc_gamma[c.j] : 0.0f;
  c.bc = c.unit ? p.lnc_beta[c.j] : 0.0f;
  return c;
}

// The phases take the block's share by value: passed by reference, row
// 5b's loop at bf16 compiled to a slower schedule (timed on an H100 against
// the same loop before the phases moved here; scripts/compare_builds.py).

// Before the first step: the dh parts hold dhT (part 0) and zeros, and
// each pair's running dc (dc0), LN sums (part) and dx_bias sums (dxb)
// start from dcT and zeros. A __syncthreads must follow.
// Without SUMS (the ladder's arms that keep no LN sums) part is not
// touched.
template <int U, bool SUMS = true, typename W, typename R>
__device__ __forceinline__ void ln_init(const Bwd<W, R>& a, const LnCtx<U> c,
                                        int nb_max) {
  const int H = a.p.H, G = 4 * H, tid = threadIdx.x;
  const int npairs = c.nb * U;
  for (int e = tid; e < c.parts * c.plane; e += kLoopThreads) {
    const int q = e % c.plane, bl = q / U, uu = q % U;
    c.s_part[e] = (e < c.plane && bl < c.nb && uu < c.nu && a.dhT != nullptr)
                      ? a.dhT[(size_t)(c.b0 + bl) * H + c.j0 + uu]
                      : 0.0f;
  }
  for (int q = tid; q < npairs; q += kLoopThreads) {
    if (!c.unit) continue;
    const size_t at = (size_t)(c.b0 + q / U) * H + c.j;
    a.dc0[at] = a.dcT != nullptr ? a.dcT[at] : 0.0f;
    if constexpr (SUMS) {
      float* pr = a.part + (size_t)(c.b0 + q / U) * c.pstride + c.j;
#pragma unroll
      for (int e = 0; e < 10; ++e) pr[e * H] = 0.0f;
    }
    if (a.dxb != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a.dxb[(size_t)(c.b0 + q / U) * G + g * H + c.j] = 0.0f;
    }
  }
}

// row-step m's stand-in statistics (LnStatsStandIn): mean and rs
template <typename W, typename R>
__device__ __forceinline__ void ln_stand_in(const Bwd<W, R>& a, size_t m,
                                            float& mean, float& rs) {
  const R* cr = a.cs + m * a.p.H;
  mean = to_f(cr[0]) * 1e-3f;
  rs = 1.0f + to_f(cr[1]) * 1e-3f;
}

// the inputs of pair q's gate block at step s (a real pair only)
template <int U, typename W, typename R, typename S = LnStatsHoisted>
__device__ __forceinline__ LnPair ln_pair_at(const Bwd<W, R>& a,
                                             const LnCtx<U> c,
                                             const LnWork& w, int s, int q) {
  const int H = a.p.H, G = 4 * H, B = a.B, j = c.j;
  const int row = c.b0 + q / U;
  const size_t m = (size_t)s * B + row, at = m * H + j;
  float pre[4], st[kLnStats];
#pragma unroll
  for (int g = 0; g < 4; ++g) pre[g] = __ldcg(a.dpre + m * G + g * H + j);
  if constexpr (S::kStandIn) {
    float mean, rs;
    ln_stand_in(a, m, mean, rs);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      st[g] = mean;
      st[4 + g] = rs;
    }
    st[8] = mean;
    st[9] = rs;
  } else {
    const float2* sp = reinterpret_cast<const float2*>(w.stats +
                                                       m * kLnStats);
#pragma unroll
    for (int e = 0; e < kLnStats / 2; ++e) {
      const float2 v = sp[e];
      st[2 * e] = v.x;
      st[2 * e + 1] = v.y;
    }
  }
  float dh = 0.0f;
  for (int pt = 0; pt < c.parts; ++pt) dh += c.s_part[pt * c.plane + q];
  const float c_prev = to_f(a.cs[at]);
  const float mk = dropout_mask(a.drop, c.seed, s, B, row, H, j);
  return ln_pair<S::kStandIn>(pre, st, c_prev, mk, dh + to_f(a.dhs[at]),
                              c.gam, c.bet, c.gc, c.bc, a.p.forget_bias);
}

// (a) the cell norm's partials of every row into exa [B][slices][2]
template <int U, typename W, typename R, typename S = LnStatsHoisted>
__device__ __forceinline__ void ln_phase_a(const Bwd<W, R>& a,
                                           const LnCtx<U> c, const LnWork& w,
                                           int s) {
  const int tid = threadIdx.x, npairs = c.nb * U;
  for (int q0 = 0; q0 < npairs; q0 += kLoopThreads) {
    const int q = q0 + tid, bl = q / U;
    float v[2] = {0.0f, 0.0f};
    if (c.unit && bl < c.nb) {
      const LnPair r = ln_pair_at<U, W, R, S>(a, c, w, s, q);
      v[0] = r.dyc * c.gc;
      v[1] = v[0] * r.xhat_c;
    }
    unit_sum<U>(v);
    if (c.u == 0 && bl < c.nb)
      reinterpret_cast<float2*>(w.exa)[(size_t)(c.b0 + bl) * c.slices +
                                         c.sl] = make_float2(v[0], v[1]);
  }
}

// (b) dcv, dy, the LN sums and the gate norms' partials into exb
// [B][slices][8]; dxh stashed
template <int U, typename W, typename R, typename S = LnStatsHoisted>
__device__ __forceinline__ void ln_phase_b(const Bwd<W, R>& a,
                                           const LnCtx<U> c, const LnWork& w,
                                           int s) {
  constexpr int kRows = kLoopThreads / U;
  const int H = a.p.H, B = a.B, j = c.j, tid = threadIdx.x;
  const int npairs = c.nb * U, slices = c.slices;
  for (int q0 = 0; q0 < npairs; q0 += kLoopThreads) {
    const int q = q0 + tid, bl = q / U, row = c.b0 + bl;
    const int bl0 = q0 / U, nr = c.nb - bl0 < kRows ? c.nb - bl0 : kRows;
    stage_ex<float>(c.s_ex, w.exa, (size_t)(c.b0 + bl0) * slices * 2,
                    nr * slices * 2);
    __syncthreads();  // this pass's rows of exa in s_ex
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (c.unit && bl < c.nb) {
      const float2* ex =
          reinterpret_cast<const float2*>(c.s_ex) + (bl - bl0) * slices;
      float s0 = 0.0f, s1 = 0.0f;
      for (int k = 0; k < slices; ++k) {
        const float2 e = ex[k];
        s0 += e.x;
        s1 += e.y;
      }
      // every load before the first store: the compiler cannot move a
      // load above a store through another float pointer, and each
      // would wait out its own L2 round trip
      float* pr = a.part + (size_t)row * c.pstride + j;
      float ln[10];
#pragma unroll
      for (int e = 0; e < 10; ++e) ln[e] = pr[e * H];
      const float dc = a.dc0[(size_t)row * H + j];
      const LnPair r = ln_pair_at<U, W, R, S>(a, c, w, s, q);
      const float dxh_c = r.dyc * c.gc;
      const float dcv =
          dc + r.crs * (dxh_c - s0 / c.fh - r.xhat_c * (s1 / c.fh));
      const float df = dcv * r.c_prev;
      const float di = dcv * (r.gu * r.m);
      const float dgu = dcv * r.i * r.m;
      const float dy[4] = {di * r.i * (1.0f - r.i),
                           dgu * (1.0f - r.gu * r.gu),
                           df * r.f * (1.0f - r.f),
                           r.do_ * r.o * (1.0f - r.o)};
      ln[8] += r.dyc * r.xhat_c;
      ln[9] += r.dyc;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        ln[g] += dy[g] * r.xhat[g];
        ln[4 + g] += dy[g];
        v[g] = dy[g] * c.gam[g];
        v[4 + g] = v[g] * r.xhat[g];
      }
#pragma unroll
      for (int e = 0; e < 10; ++e) pr[e * H] = ln[e];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w.dxh[((size_t)g * B + row) * H + j] = v[g];
      a.dc0[(size_t)row * H + j] = dcv * r.f;
    }
    unit_sum<U>(v);
    if (c.u == 0 && bl < c.nb) {
      float4* dst = reinterpret_cast<float4*>(w.exb) +
                    ((size_t)row * slices + c.sl) * 2;
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();  // s_ex read
  }
}

// (c) the gate norms' row sums in slice order give each pair's d_pre,
// written over pre in place; the Emit policy e takes it: e.at(m, row, j)
// once a pair, e.load(g) among the pair's loads, e.put(g, dp, lr) after
// each gate's store (lr the row within the pass), e.pass_done(bl0, nr)
// after each pass of kLoopThreads / U rows (all its puts visible).
template <int U, typename W, typename R, typename Emit,
          typename S = LnStatsHoisted>
__device__ __forceinline__ void ln_phase_c(const Bwd<W, R>& a,
                                           const LnCtx<U> c, const LnWork& w,
                                           int s, Emit& e) {
  constexpr int kRows = kLoopThreads / U;
  const int H = a.p.H, G = 4 * H, B = a.B, j = c.j, tid = threadIdx.x;
  const int npairs = c.nb * U, slices = c.slices;
  for (int q0 = 0; q0 < npairs; q0 += kLoopThreads) {
    const int q = q0 + tid, bl = q / U, row = c.b0 + bl;
    const int bl0 = q0 / U, nr = c.nb - bl0 < kRows ? c.nb - bl0 : kRows;
    stage_ex<float4>(c.s_ex, w.exb, (size_t)(c.b0 + bl0) * slices * 8,
                     nr * slices * 2);
    __syncthreads();  // this pass's rows of exb in s_ex
    if (c.unit && bl < c.nb) {
      const float4* ex =
          reinterpret_cast<const float4*>(c.s_ex) + (bl - bl0) * slices * 2;
      float sum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < slices; ++k) {
        const float4 e0 = ex[2 * k], e1 = ex[2 * k + 1];
        sum[0] += e0.x;
        sum[1] += e0.y;
        sum[2] += e0.z;
        sum[3] += e0.w;
        sum[4] += e1.x;
        sum[5] += e1.y;
        sum[6] += e1.z;
        sum[7] += e1.w;
      }
      const size_t m = (size_t)s * B + row;
      const float* st = w.stats + m * kLnStats;
      float* dpr = a.dpre + m * G + j;
      e.at(m, row, j);
      float pre[4], dxh[4], mean[4], rs[4];
      if constexpr (S::kStandIn) {
        ln_stand_in(a, m, mean[0], rs[0]);
#pragma unroll
        for (int g = 1; g < 4; ++g) {
          mean[g] = mean[0];
          rs[g] = rs[0];
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {  // every load before the first store
        pre[g] = __ldcg(dpr + g * H);
        dxh[g] = w.dxh[((size_t)g * B + row) * H + j];
        e.load(g);
        if constexpr (!S::kStandIn) {
          mean[g] = st[g];
          rs[g] = st[4 + g];
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float xhat = (pre[g] - mean[g]) * rs[g];
        const float dp =
            rs[g] * (dxh[g] - sum[g] / c.fh - xhat * (sum[4 + g] / c.fh));
        dpr[g * H] = dp;
        e.put(g, dp, bl - bl0);
      }
    }
    __syncthreads();  // s_ex read
    e.pass_done(bl0, nr);
  }
}

// row 5b's Emit: the dx_bias sums beside d_pre, read and written by the
// pair's owner only
struct LnDpre {
  float* dxb;  // Bwd::dxb, [B, 4H], or null
  int H;
  float* xb = nullptr;
  float xbs[4];
  __device__ LnDpre(float* dxb_, int H_) : dxb(dxb_), H(H_) {}
  __device__ __forceinline__ void at(size_t, int row, int j) {
    xb = dxb != nullptr ? dxb + (size_t)row * 4 * H + j : nullptr;
  }
  __device__ __forceinline__ void load(int g) {
    xbs[g] = xb != nullptr ? xb[g * H] : 0.0f;
  }
  __device__ __forceinline__ void put(int g, float dp, int) {
    if (xb != nullptr) xb[g * H] = xbs[g] + dp;
  }
  __device__ __forceinline__ void pass_done(int, int) {}
};

// After the last step: dh0 of each pair, the sum of its parts.
template <int U, typename W, typename R>
__device__ __forceinline__ void ln_dh0(const Bwd<W, R>& a, const LnCtx<U> c) {
  for (int q = threadIdx.x; q < c.nb * U; q += kLoopThreads) {
    if (!c.unit) continue;
    float dh = 0.0f;
    for (int pt = 0; pt < c.parts; ++pt) dh += c.s_part[pt * c.plane + q];
    a.dh0[(size_t)(c.b0 + q / U) * a.p.H + c.j] = dh;
  }
}

}  // namespace
