// The LayerNorm-LSTM's two persistent cooperative loops of the PyTorch port,
// shared by two users: fused_rnn.cu (srt_ln_lstm_fwd and srt_ln_lstm_bwd,
// rows 5f and 5b: fused_ln_lstm) and probe_ln.cu (srt_ln_probe_fwd and
// srt_ln_probe_bwd, rows 8f, 8b and 9: the LayerNorm ladder). fused_rnn.cu's
// header has the design ("Design of the LayerNorm-LSTM forward", "... the
// LayerNorm-LSTM backward", "Row windows"); probe_ln.cu's says what each
// arm takes out.
//
// The arm is a compile-time policy of each loop and of its launches; its
// default is production, so that the ladder's prod arms are the production
// instantiations themselves, and every other arm is production with one
// term of work taken out (a phase, an exchange with its grid barrier, a
// launch). Everything sits in an unnamed namespace: each translation unit
// gets its own copy.

#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "ln_loop.cuh"
#include "lstm_loops.cuh"
#include "persist.cuh"
#include "recompute.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

// The arms, by the ids of srt_ln_probe_fwd and srt_ln_probe_bwd.
enum LnFwdArm { kLnFwdProd = 0, kLnFwdNoLn, kLnFwdNoGates, kLnFwdFloor };
enum LnBwdArm {
  kLnBwdProd = 0,
  kLnBwdNoLnBwd,
  kLnBwdNoLn,
  kLnBwdNoGates,
  kLnBwdNoGradmm,
  kLnBwdFloor,
  kLnBwdFake
};

// What a backward arm runs (probe_ln.cu's header has the arms).
template <int ARM>
struct LnBwdPolicy {
  static constexpr bool kFloor = ARM == kLnBwdFloor;
  static constexpr bool kRecompute = !kFloor;
  // the statistics launch (real statistics), or the stand-ins from cs
  static constexpr bool kStats = ARM == kLnBwdProd || ARM == kLnBwdNoLnBwd;
  static constexpr bool kStandIn = ARM == kLnBwdNoLn || ARM == kLnBwdFake;
  // the gate block (real or stand-in statistics) and its LN sums
  static constexpr bool kGates = kStats || kStandIn;
  // the layer norms' two corrections: exchanges (a) and (b), three barriers
  static constexpr bool kExchanges = ARM == kLnBwdProd || ARM == kLnBwdFake;
  // dwx/dwh (the weight pass) and the dx product
  static constexpr bool kWeightPass = kGates || ARM == kLnBwdNoGates;
  using Stats = typename std::conditional<kStandIn, LnStatsStandIn,
                                          LnStatsHoisted>::type;
};

// ---------------------------------------------------------------------------
// The LayerNorm-LSTM forward of srt_ln_lstm_fwd: one persistent cooperative
// kernel (fused_rnn.cu's header, "Design of the LayerNorm-LSTM forward"), on
// the LSTM forward's grid with its resident columns and its h exchange. A
// warp task is the kUnits units of the slice x (kLnRowLanes * ROWS) rows
// (ROWS = kLnFwdRows): lane l takes unit l % 16 and the rows l / 16 + 2 i
// (i < ROWS), all four gates of each, so a half warp holds the units of one
// row and a row's sums over the slice are half-warp shuffles. Per step: (a)
// the products, each gate's slice mean and M2 to an exchange; grid barrier;
// (b) the gates' row statistics, the gate block, the new cell state's slice
// mean and M2 to a second exchange; grid barrier; (c) the cell norm's row
// statistics, h and the stores; grid barrier.
constexpr int kLnRowLanes = 32 / kUnits;  // row groups per warp task
constexpr int kLnFwdRows = 2;             // rows per thread and row group
constexpr int kLnGateEx = 8;              // per row and slice: mean[4], M2[4]

// The scratch of srt_ln_lstm_fwd beside hx, carved from one float buffer in
// this order (16-byte aligned first): the gate norms' slice partials
// ([B][slices][kLnGateEx]), the cell norm's ([B][slices][2]) and, only
// where a tile's rows pass in several chunks, each pair's pre-activations
// from (a) to (b), then its new cell state and o from (b) to (c)
// ([4][B][H]). The ladder's arms carve their own (ln_arm_fwd_work): no_ln
// holds its stand-ins' exchange [2][B][2] in exc, no_gates its float h
// carry [B][H] in stash and, in exg, the null target of the store that
// keeps gates 2 and 3's products alive.
struct LnFwdWork {
  float* exg;
  float* exc;
  float* stash;
};

LnFwdWork ln_fwd_work(float* work, int B, int H) {
  const size_t slices = (size_t)(H + kUnits - 1) / kUnits;
  LnFwdWork w;
  w.exg = work;
  w.exc = w.exg + (size_t)B * slices * kLnGateEx;
  w.stash = w.exc + (size_t)B * slices * 2;
  return w;
}

template <int ARM>
LnFwdWork ln_arm_fwd_work(float* work, int B, int H) {
  if constexpr (ARM == kLnFwdProd) {
    return ln_fwd_work(work, B, H);
  } else {
    LnFwdWork w = {nullptr, nullptr, nullptr};
    if (ARM == kLnFwdNoLn) w.exc = work;
    if (ARM == kLnFwdNoGates) w.stash = work;
    return w;
  }
}

// The slice-local moments of N values per lane over the 16 lanes of a half
// warp (one row's units; a lane past the slice's n units contributes
// nothing): mean[g] = sum / n, then m2[g] = sum of (v - mean)^2 (two
// passes). Every lane gets them. All 32 lanes must call it.
template <int N>
__device__ __forceinline__ void slice_moments(const float (&v)[N], bool real,
                                              float n, float (&mean)[N],
                                              float (&m2)[N]) {
#pragma unroll
  for (int g = 0; g < N; ++g) mean[g] = real ? v[g] : 0.0f;
  half_warp_sum(mean);
#pragma unroll
  for (int g = 0; g < N; ++g) {
    mean[g] = mean[g] / n;
    const float d = v[g] - mean[g];
    m2[g] = real ? d * d : 0.0f;
  }
  half_warp_sum(m2);
}

// The layer-norm statistics of N rows from their slices' (mean, M2)
// partials, m[n][k * stride] and m[n][k * stride + off], each row's
// combined in slice order by Chan's rule: mean = sum_k n_k m_k / H, M2 =
// sum_k (M2_k + n_k (m_k - mean)^2), rs = rsqrt(M2 / H + 1e-6). s_n holds
// each slice's unit count. The rows' sums advance together, so N
// independent chains are in flight.
template <int N>
__device__ __forceinline__ void chan_stats(const float* const (&m)[N],
                                           int stride, int off,
                                           const float* s_n, int slices,
                                           float fh, float (&mean)[N],
                                           float (&rs)[N]) {
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

// The floor arms' pairs a thread walks side by side, so that their loads
// are in flight together: one pair's chain alone waits out an L2 round
// trip every step.
constexpr int kFloorPairs = 4;

// The forward's floor arm: no product, no exchange, no grid barrier. Each
// thread walks its pairs' whole sequences, kFloorPairs at a time, with the
// carries in registers: c' = 0.9 c + rnd_W(x[t, 0] * rnd_W(1e-3)), h' =
// 0.5 h + 1e-3 x_bias[row, j] (1e-3 c without x_bias), the stores of cs
// (the pre-step c), hs and the final carry.
template <typename W, typename R>
__device__ __forceinline__ void ln_fwd_floor(const Fwd<W, R>& a, int b0,
                                             int nb, int j0, int nu) {
  constexpr int P = kFloorPairs;
  const Cell<W>& p = a.p;
  const int H = p.H, B = a.B, D = p.D;
  const float milli = rnd<W>(1e-3f);
  const bool xb = p.xb != nullptr;
  for (int q0 = threadIdx.x; q0 < nb * kUnits; q0 += P * kFwdThreads) {
    bool ok[P];
    int row[P], j[P];
    float c[P], h[P], xbv[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int q = q0 + i * kFwdThreads;
      ok[i] = q < nb * kUnits && q % kUnits < nu;
      row[i] = b0 + (ok[i] ? q / kUnits : 0);
      j[i] = j0 + (ok[i] ? q % kUnits : 0);
      const size_t at = (size_t)row[i] * H + j[i];
      c[i] = ok[i] ? a.c0[at] : 0.0f;
      h[i] = ok[i] ? a.h0[at] : 0.0f;
      xbv[i] = ok[i] && xb ? p.xb[(size_t)row[i] * 4 * H + j[i]] * 1e-3f
                           : 0.0f;
    }
    for (int t = 0; t < a.T; ++t) {
      float x0[P];
#pragma unroll
      for (int i = 0; i < P; ++i)
        x0[i] = rnd<W>(a.xs[((size_t)t * B + row[i]) * D]);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float nc = c[i] * 0.9f + rnd<W>(x0[i] * milli);
        const float nh = h[i] * 0.5f + (xb ? xbv[i] : c[i] * 1e-3f);
        if (ok[i]) {
          const size_t at = ((size_t)t * B + row[i]) * H + j[i];
          a.cs[at] = from_f<R>(c[i]);
          a.hs[at] = from_f<R>(nh);
        }
        c[i] = nc;
        h[i] = nh;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (ok[i] && a.cT != nullptr) {
        a.cT[(size_t)row[i] * H + j[i]] = c[i];
        a.hT[(size_t)row[i] * H + j[i]] = h[i];
      }
    }
  }
}

// The loop. ARM other than production (the ladder's): no_ln and no_gates
// run the gate block on each chunk's rows right after their products, one
// grid barrier a step (the h exchange); floor is ln_fwd_floor.
template <typename W, typename R, int ARM = kLnFwdProd>
__global__ void __launch_bounds__(kFwdThreads)
ln_lstm_fwd_loop_kernel(Fwd<W, R> a, W* hx, LnFwdWork wk, int slices,
                        int tiles, int chunk, int r0, int nr) {
  constexpr int ROWS = kLnFwdRows, kTaskRows = kLnRowLanes * ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Cell<W>& p = a.p;
  const int H = p.H, G = 4 * H, B = a.B, D = p.D;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  if constexpr (ARM == kLnFwdFloor) {
    ln_fwd_floor(a, b0, nb, j0, nu);
    return;
  }
  const int nb_max = (nr + tiles - 1) / tiles;
  const int rs = fwd_row_stride<W>(H);
  const int kp = ((H + kParts - 1) / kParts + 7) / 8 * 8;  // k per part
  // [H + D][kUnits][4]: the wh rows, then the wx rows; zero past nu
  float* s_w = reinterpret_cast<float*>(smem_raw);
  const float* s_wx = s_w + (size_t)H * kUnits * 4;
  float* s_n = s_w + (size_t)(H + D) * kUnits * 4;  // [32] units per slice
  float* s_c = s_n + 32;                             // [nb_max][kUnits]
  // a chunk's h rows (W, row stride rs) in (a), its rows of an exchange in
  // (b) and (c)
  unsigned char* s_buf =
      reinterpret_cast<unsigned char*>(s_c + (size_t)nb_max * kUnits);
  W* s_h = reinterpret_cast<W*>(s_buf);
  float* s_ex = reinterpret_cast<float*>(s_buf);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = lane % kUnits, half = lane & ~(kUnits - 1);
  const bool unit = u < nu;
  const int j = j0 + (unit ? u : 0);
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;
  const bool async = H % (16 / (int)sizeof(W)) == 0 &&
                     (reinterpret_cast<uintptr_t>(hx) & 15) == 0;
  const float fh = (float)H, fn = (float)nu;
  float gam[4], bet[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    gam[g] = unit ? p.ln_gamma[g * H + j] : 0.0f;
    bet[g] = unit ? p.ln_beta[g * H + j] : 0.0f;
  }
  const float gc = unit ? p.lnc_gamma[j] : 0.0f;
  const float bc = unit ? p.lnc_beta[j] : 0.0f;

  for (int e = tid; e < (H + D) * kUnits * 4; e += kFwdThreads) {
    const int k = e / (kUnits * 4), uu = (e / 4) % kUnits;
    const int col = (e % 4) * H + j0 + uu;
    float v = 0.0f;
    if (uu < nu)
      v = to_f(k < H ? p.wh[(size_t)k * G + col]
                     : p.wx[(size_t)(k - H) * G + col]);
    s_w[e] = v;
  }
  if (tid < slices)
    s_n[tid] = (float)((tid + 1) * H / slices - tid * H / slices);
  for (int q = tid; q < nb * kUnits; q += kFwdThreads) {
    const int uu = q % kUnits;
    s_c[q] = uu < nu ? a.c0[(size_t)(b0 + q / kUnits) * H + j0 + uu] : 0.0f;
  }
  __syncthreads();  // the resident state, before any phase reads it
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const size_t plane = (size_t)B * H;
  const float* wc = s_w + u * 4;
  const bool multi = nb > chunk;  // else the pairs stay in registers
  const int lr0 = warp * kTaskRows + lane / kUnits;  // rows lr0 + 2 i
  float pre[ROWS][4], keep_c[ROWS], keep_o[ROWS];
  // the stash of pair (row, j), slot g
  auto stash = [&](int g, int row) -> float& {
    return wk.stash[((size_t)g * B + row) * H + j];
  };

  for (int t = 0; t < a.T; ++t) {
    const W* hin = t == 0 ? nullptr : hx + ((t + 1) & 1) * plane;
    W* hout = hx + (t & 1) * plane;
    // (a) the products and the gates' slice moments
    for (int ch = 0; ch < nb; ch += chunk) {
      const int cr = nb - ch < chunk ? nb - ch : chunk;
      const bool busy = warp < (cr + kTaskRows - 1) / kTaskRows;
      float acc[ROWS][4], xbv[ROWS][4];
      float xq[ROWS][kMaxXd];
      float sm[ROWS], sr[ROWS];  // no_ln: the rows' stand-in statistics
      if (busy) {  // x and x_bias, asked for ahead of the h copies
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int lr = lr0 + rr * kLnRowLanes;
          const bool ok = lr < cr && unit;
          const int row = b0 + ch + (ok ? lr : 0);
          const float* x = a.xs + ((size_t)t * B + row) * D;
#pragma unroll
          for (int q = 0; q < kMaxXd; ++q)
            xq[rr][q] = q < D ? rnd<W>(x[q]) : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xbv[rr][g] = (ok && p.xb != nullptr)
                             ? p.xb[(size_t)row * G + g * H + j]
                             : 0.0f;
          if constexpr (ARM == kLnFwdNoLn) {
            // c_prev[0], c_prev[1] of the row: c0, or what slice 0 left
            // in the exchange at step t - 1
            float c01[2];
            if (t == 0) {
              c01[0] = a.c0[(size_t)row * H];
              c01[1] = a.c0[(size_t)row * H + 1];
            } else {
              const float* cx = wk.exc + ((t + 1) & 1) * 2 * (size_t)B;
              c01[0] = __ldcg(cx + (size_t)row * 2);
              c01[1] = __ldcg(cx + (size_t)row * 2 + 1);
            }
            sm[rr] = c01[0] * 1e-3f;
            sr[rr] = 1.0f + c01[1] * 1e-3f;
          }
        }
      }
      load_h_chunk<W>(s_h, rs, a.h0, hin, async, (size_t)(b0 + ch), cr,
                      H, kp);
      if (busy) {
        // while h is in flight: x @ wx, gate_pre's first sum (one in-order
        // fmaf chain over the D inputs per gate)
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          float sx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int q = 0; q < kMaxXd; ++q) {
            if (q >= D) break;
            const float4 w = quad(s_wx + (q * kUnits + u) * 4);
            sx[0] = fmaf(xq[rr][q], w.x, sx[0]);
            sx[1] = fmaf(xq[rr][q], w.y, sx[1]);
            sx[2] = fmaf(xq[rr][q], w.z, sx[2]);
            sx[3] = fmaf(xq[rr][q], w.w, sx[3]);
          }
          if (D > kMaxXd) {
            const int lr = lr0 + rr * kLnRowLanes;
            const int row = b0 + ch + (lr < cr && unit ? lr : 0);
            const float* x = a.xs + ((size_t)t * B + row) * D;
            for (int q = kMaxXd; q < D; ++q) {
              const float xv = rnd<W>(x[q]);
              const float4 w = quad(s_wx + (q * kUnits + u) * 4);
              sx[0] = fmaf(xv, w.x, sx[0]);
              sx[1] = fmaf(xv, w.y, sx[1]);
              sx[2] = fmaf(xv, w.z, sx[2]);
              sx[3] = fmaf(xv, w.w, sx[3]);
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            pre[rr][g] = sx[g];
            acc[rr][g] = 0.0f;
          }
        }
      }
      // h @ wh, part by part: one in-order fmaf chain over k per output
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        cp_async_wait(kParts - 1 - part);  // this part's copies landed
        __syncthreads();  // ... for every thread: this part of k in s_h
        if (!busy) continue;
        const int k1 = (part + 1) * kp < H ? (part + 1) * kp : H;
        int k = part * kp;
#pragma unroll 2
        for (; k + 4 <= k1; k += 4) {
          float4 hv[ROWS];
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            hv[rr] = quad(s_h + (size_t)(lr0 + rr * kLnRowLanes) * rs + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = quad(wc + (size_t)(k + kk) * kUnits * 4);
#pragma unroll
            for (int rr = 0; rr < ROWS; ++rr) {
              const float h = kk == 0   ? hv[rr].x
                              : kk == 1 ? hv[rr].y
                              : kk == 2 ? hv[rr].z
                                        : hv[rr].w;
              acc[rr][0] = fmaf(h, w.x, acc[rr][0]);
              acc[rr][1] = fmaf(h, w.y, acc[rr][1]);
              acc[rr][2] = fmaf(h, w.z, acc[rr][2]);
              acc[rr][3] = fmaf(h, w.w, acc[rr][3]);
            }
          }
        }
        for (; k < k1; ++k) {
          const float4 w = quad(wc + (size_t)k * kUnits * 4);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const float h =
                to_f(s_h[(size_t)(lr0 + rr * kLnRowLanes) * rs + k]);
            acc[rr][0] = fmaf(h, w.x, acc[rr][0]);
            acc[rr][1] = fmaf(h, w.y, acc[rr][1]);
            acc[rr][2] = fmaf(h, w.z, acc[rr][2]);
            acc[rr][3] = fmaf(h, w.w, acc[rr][3]);
          }
        }
      }
      if (busy) {
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int lr = lr0 + rr * kLnRowLanes;
          const int row = b0 + ch + lr;
#pragma unroll
          for (int g = 0; g < 4; ++g) {  // (x @ wx + h @ wh) [+ x_bias]
            pre[rr][g] = pre[rr][g] + acc[rr][g];
            if (p.xb != nullptr) pre[rr][g] = pre[rr][g] + xbv[rr][g];
          }
          if constexpr (ARM == kLnFwdProd) {
            float mean[4], m2[4];
            slice_moments(pre[rr], unit, fn, mean, m2);
            if (lr >= cr) continue;
            if (u == 0) {
              float4* dst = reinterpret_cast<float4*>(
                  wk.exg + ((size_t)row * slices + sl) * kLnGateEx);
              dst[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
              dst[1] = make_float4(m2[0], m2[1], m2[2], m2[3]);
            }
            if (multi && unit) {
#pragma unroll
              for (int g = 0; g < 4; ++g) stash(g, row) = pre[rr][g];
            }
          } else {
            // no_ln / no_gates: the gate block now, h and the stores
            if (lr >= cr || !unit) continue;
            float* cp = s_c + (size_t)(ch + lr) * kUnits + u;
            const float c = *cp;
            float nc, nh;
            if constexpr (ARM == kLnFwdNoLn) {
              const float m = dropout_mask(a.drop, seed, t, B, row, H, j);
              float y[4];
#pragma unroll
              for (int g = 0; g < 4; ++g)
                y[g] = (pre[rr][g] - sm[rr]) * sr[rr] * gam[g] + bet[g];
              const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
              const float f = sigmoidf_(y[2] + p.forget_bias);
              const float o = sigmoidf_(y[3]);
              nc = c * f + i * (gu * m);
              const float yc = (nc - sm[rr]) * sr[rr] * gc + bc;
              nh = tanhf(yc) * o;
              if (sl == 0 && u < 2)  // step t + 1's stand-ins
                wk.exc[(t & 1) * 2 * (size_t)B + (size_t)row * 2 + u] = nc;
            } else {  // kLnFwdNoGates
              float* hp = wk.stash + (size_t)row * H + j;
              const float h = t == 0 ? a.h0[(size_t)row * H + j] : *hp;
              nc = c * 0.9f + pre[rr][0] * 0.1f;
              nh = h * 0.5f + pre[rr][1] * 0.1f;
              if (wk.exg != nullptr) wk.exg[j] = pre[rr][2] + pre[rr][3];
              *hp = nh;
            }
            const size_t at = ((size_t)t * B + row) * H + j;
            a.cs[at] = from_f<R>(c);
            a.hs[at] = from_f<R>(nh);
            hout[(size_t)row * H + j] = from_f<W>(nh);
            *cp = nc;
            if (a.cT != nullptr && t == a.T - 1) {
              a.cT[(size_t)row * H + j] = nc;
              a.hT[(size_t)row * H + j] = nh;
            }
          }
        }
      }
      __syncthreads();  // every read of s_h done: next chunk
    }
    if constexpr (ARM == kLnFwdProd) {
      grid.sync();  // the gates' slice moments complete across the grid
      // (b) the gates' row statistics, the gate block, the cell's moments
      for (int ch = 0; ch < nb; ch += chunk) {
        const int cr = nb - ch < chunk ? nb - ch : chunk;
        const bool busy = warp < (cr + kTaskRows - 1) / kTaskRows;
        stage_ex<float4>(s_ex, wk.exg, (size_t)(b0 + ch) * slices * kLnGateEx,
                         cr * slices * kLnGateEx / 4);
        __syncthreads();  // this chunk's rows of the exchange in s_ex
        if (busy) {
          // lane u combines gate u % 4 of each of its rows; the half warp
          // shares them
          const float* ex[ROWS];
  #pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int lr = lr0 + rr * kLnRowLanes;
            ex[rr] = s_ex + (size_t)(lr < cr ? lr : 0) * slices * kLnGateEx +
                     (u & 3);
          }
          float gm[ROWS], gr[ROWS];
          chan_stats(ex, kLnGateEx, 4, s_n, slices, fh, gm, gr);
  #pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int lr = lr0 + rr * kLnRowLanes;
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
              for (int g = 0; g < 4; ++g) pre[rr][g] = stash(g, row);
            }
            const float c = s_c[(size_t)(ch + (ok ? lr : 0)) * kUnits + u];
            const float m = dropout_mask(a.drop, seed, t, B, row, H, j);
            float y[4];
  #pragma unroll
            for (int g = 0; g < 4; ++g)
              y[g] = (pre[rr][g] - mean[g]) * rsg[g] * gam[g] + bet[g];
            const float i = sigmoidf_(y[0]), gu = tanhf(y[1]);
            const float f = sigmoidf_(y[2] + p.forget_bias);
            keep_o[rr] = sigmoidf_(y[3]);
            keep_c[rr] = c * f + i * (gu * m);
            float cm[1], cq[1];
            const float nc[1] = {keep_c[rr]};
            slice_moments(nc, unit, fn, cm, cq);
            if (!ok) continue;
            if (u == 0)
              reinterpret_cast<float2*>(wk.exc)[(size_t)row * slices + sl] =
                  make_float2(cm[0], cq[0]);
            if (multi && unit) {
              stash(0, row) = keep_c[rr];
              stash(1, row) = keep_o[rr];
            }
          }
        }
        __syncthreads();  // s_ex read: next chunk
      }
      grid.sync();  // the cell's slice moments complete across the grid
      // (c) the cell norm, h and the stores
      for (int ch = 0; ch < nb; ch += chunk) {
        const int cr = nb - ch < chunk ? nb - ch : chunk;
        const bool busy = warp < (cr + kTaskRows - 1) / kTaskRows;
        stage_ex<float2>(s_ex, wk.exc, (size_t)(b0 + ch) * slices * 2,
                         cr * slices);
        __syncthreads();  // this chunk's rows of the exchange in s_ex
        if (busy) {
          const float* ex[ROWS];
  #pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int lr = lr0 + rr * kLnRowLanes;
            ex[rr] = s_ex + (size_t)(lr < cr ? lr : 0) * slices * 2;
          }
          float cmean[ROWS], crs[ROWS];
          chan_stats(ex, 2, 1, s_n, slices, fh, cmean, crs);
  #pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int lr = lr0 + rr * kLnRowLanes;
            if (lr >= cr || !unit) continue;
            const int row = b0 + ch + lr;
            float nc = keep_c[rr], o = keep_o[rr];
            if (multi) {
              nc = stash(0, row);
              o = stash(1, row);
            }
            const float yc = (nc - cmean[rr]) * crs[rr] * gc + bc;
            const float nh = tanhf(yc) * o;
            float* cp = s_c + (size_t)(ch + lr) * kUnits + u;
            const size_t at = ((size_t)t * B + row) * H + j;
            a.cs[at] = from_f<R>(*cp);
            a.hs[at] = from_f<R>(nh);
            hout[(size_t)row * H + j] = from_f<W>(nh);
            *cp = nc;
            if (a.cT != nullptr && t == a.T - 1) {
              a.cT[(size_t)row * H + j] = nc;
              a.hT[(size_t)row * H + j] = nh;
            }
          }
        }
        __syncthreads();  // s_ex read: next chunk
      }
    }
    grid.sync();  // hx[t & 1] complete: step t + 1 may read it
  }
  if (a.T == 0 && a.cT != nullptr) {  // no step: the final carry is the first
    for (int q = tid; q < nb * kUnits; q += kFwdThreads) {
      if (q % kUnits >= nu) continue;
      const size_t at = (size_t)(b0 + q / kUnits) * H + j0 + q % kUnits;
      a.cT[at] = a.c0[at];
      a.hT[at] = a.h0[at];
    }
  }
}

// The LayerNorm-LSTM forward's grid (fwd_grid's slices and tiles) and
// shared memory: the resident columns, the slices' unit counts and the
// carries, then a chunk buffer that holds a chunk's h rows in (a) and its
// rows of an exchange in (b) and (c), as many rows as fit, a multiple of a
// task's rows, at most the tile's rows rounded up and at most one task per
// warp. False when not even one task's rows fit. Rows per thread: 2 at
// either weight type (at B=100, H=512 float 4 rows left four warps to the
// phases after the product and took 6.53 ms a call against 5.95, the
// outputs bitwise equal; measured on an H100).
template <typename W>
bool ln_fwd_grid(int B, int H, int D, int sms, int smem_max, FwdGrid& g) {
  const LoopGrid lg = loop_grid<float>(B, H, sms);
  g.slices = lg.slices;
  g.tiles = lg.tiles;
  const int nb_max = (B + g.tiles - 1) / g.tiles;
  g.rows = kLnFwdRows;
  const int task_rows = kLnRowLanes * g.rows;
  const size_t fixed =
      ((size_t)(H + D) * kUnits * 4 + 32 + (size_t)nb_max * kUnits) *
      sizeof(float);
  size_t row = (size_t)fwd_row_stride<W>(H) * sizeof(W);
  const size_t ex = (size_t)g.slices * kLnGateEx * sizeof(float);
  if (ex > row) row = ex;
  if (fixed + task_rows * row > (size_t)smem_max) return false;
  int chunk = (int)(((size_t)smem_max - fixed) / row) / task_rows * task_rows;
  const int need = (nb_max + task_rows - 1) / task_rows * task_rows;
  const int most = kFwdWarps * task_rows;
  if (chunk > need) chunk = need;
  if (chunk > most) chunk = most;
  g.chunk = chunk;
  g.smem = fixed + (size_t)chunk * row;
  return true;
}

// The LayerNorm-LSTM forward's cooperative loop over windows of rows
// (lstm_loops.cuh's fwd_windows), wk its scratch; windows > 0 forces that
// many (the ladder's grid-scaling runs; production passes 0: the plan's).
template <typename W, typename R, int ARM = kLnFwdProd>
cudaError_t launch_ln_fwd_loop(const Fwd<W, R>& a, W* hx, LnFwdWork wk,
                               cudaStream_t stream, int windows = 0) {
  const int H = a.p.H, D = a.p.D;
  return fwd_windows(
      a.B, H,
      [&](int rows, int sms, int smem_max, FwdGrid& g) {
        return ln_fwd_grid<W>(rows, H, D, sms, smem_max, g);
      },
      [](const FwdGrid&) {
        return (const void*)ln_lstm_fwd_loop_kernel<W, R, ARM>;
      },
      [&](const void* fn, FwdGrid& g, int r0, int nr) {
        Fwd<W, R> args = a;
        W* hxp = hx;
        void* params[] = {&args,    &hxp,     &wk, &g.slices,
                          &g.tiles, &g.chunk, &r0, &nr};
        return cudaLaunchCooperativeKernel(fn, dim3(g.slices * g.tiles),
                                           dim3(kFwdThreads), params, g.smem,
                                           stream);
      },
      windows);
}

// ---------------------------------------------------------------------------
// The LayerNorm-LSTM backward of srt_ln_lstm_bwd: four launches (fused_rnn.cu's
// header, "Design of the LayerNorm-LSTM backward"). The first is the LSTM's
// recompute (Cell::b is null).

// The scratch of the launches after the recompute for an arm: production's
// ln_work; no_lnbwd the statistics alone, fake the exchanges and the dxh
// stash alone (in ln_work's order), the others none.
template <int ARM>
LnWork ln_arm_work(float* work, int T, int B, int H, int slices) {
  if constexpr (ARM == kLnBwdProd) {
    return ln_work(work, T, B, H, slices);
  } else {
    LnWork w = {nullptr, nullptr, nullptr, nullptr};
    if (ARM == kLnBwdNoLnBwd) w.stats = work;
    if (ARM == kLnBwdFake) {
      w.exb = work;
      w.exa = w.exb + (size_t)B * slices * 8;
      w.dxh = w.exa + (size_t)B * slices * 2;
    }
    return w;
  }
}

// The ladder's no_lnbwd and no_ln arms: the gate block's backward without
// the layer norms' two corrections (d_pre = dy * gamma, dc += dyc *
// lnc_gamma) from S's statistics, the LN sums kept; d_pre written over pre
// and the dx_bias sums. One pass over the pairs, no exchange.
template <int U, typename S, typename W, typename R>
__device__ __forceinline__ void ln_phase_uncorrected(const Bwd<W, R>& a,
                                                     const LnCtx<U> c,
                                                     const LnWork& w, int s) {
  const int H = a.p.H, G = 4 * H, B = a.B, j = c.j;
  if (!c.unit) return;
  for (int q = threadIdx.x; q < c.nb * U; q += kLoopThreads) {
    const int row = c.b0 + q / U;
    const size_t m = (size_t)s * B + row;
    // every load before the first store
    float* pr = a.part + (size_t)row * c.pstride + j;
    float ln[10], xbs[4];
#pragma unroll
    for (int e = 0; e < 10; ++e) ln[e] = pr[e * H];
    float* xb = a.dxb != nullptr ? a.dxb + (size_t)row * G + j : nullptr;
#pragma unroll
    for (int g = 0; g < 4; ++g) xbs[g] = xb != nullptr ? xb[g * H] : 0.0f;
    const float dc = a.dc0[(size_t)row * H + j];
    const LnPair r = ln_pair_at<U, W, R, S>(a, c, w, s, q);
    const float dcv = dc + r.dyc * c.gc;
    const float df = dcv * r.c_prev;
    const float di = dcv * (r.gu * r.m);
    const float dgu = dcv * r.i * r.m;
    const float dy[4] = {di * r.i * (1.0f - r.i), dgu * (1.0f - r.gu * r.gu),
                         df * r.f * (1.0f - r.f),
                         r.do_ * r.o * (1.0f - r.o)};
    ln[8] += r.dyc * r.xhat_c;
    ln[9] += r.dyc;
    float* dpr = a.dpre + m * G + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      ln[g] += dy[g] * r.xhat[g];
      ln[4 + g] += dy[g];
    }
#pragma unroll
    for (int e = 0; e < 10; ++e) pr[e * H] = ln[e];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float dp = dy[g] * c.gam[g];
      dpr[g * H] = dp;
      if (xb != nullptr) xb[g * H] = xbs[g] + dp;
    }
    a.dc0[(size_t)row * H + j] = dcv * r.f;
  }
}

// The ladder's no_gates and no_gradmm arms: d_pre = 0.25 pre + dh + 0.1 dc
// (each gate), dc' = 0.9 dc + 1e-3 c_prev; d_pre written over pre and the
// dx_bias sums. One pass over the pairs, no exchange.
template <int U, typename W, typename R>
__device__ __forceinline__ void ln_phase_no_gates(const Bwd<W, R>& a,
                                                  const LnCtx<U> c, int s) {
  const int H = a.p.H, G = 4 * H, B = a.B, j = c.j;
  if (!c.unit) return;
  for (int q = threadIdx.x; q < c.nb * U; q += kLoopThreads) {
    const int row = c.b0 + q / U;
    const size_t m = (size_t)s * B + row, at = m * H + j;
    float* dpr = a.dpre + m * G + j;
    float* xb = a.dxb != nullptr ? a.dxb + (size_t)row * G + j : nullptr;
    float pre[4], xbs[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      pre[g] = __ldcg(dpr + g * H);
      xbs[g] = xb != nullptr ? xb[g * H] : 0.0f;
    }
    float dh = 0.0f;
    for (int pt = 0; pt < c.parts; ++pt) dh += c.s_part[pt * c.plane + q];
    const float dh_tot = dh + to_f(a.dhs[at]);
    const float dc = a.dc0[(size_t)row * H + j];
    const float c_prev = to_f(a.cs[at]);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float dp = pre[g] * 0.25f + dh_tot + dc * 0.1f;
      dpr[g * H] = dp;
      if (xb != nullptr) xb[g * H] = xbs[g] + dp;
    }
    a.dc0[(size_t)row * H + j] = dc * 0.9f + c_prev * 1e-3f;
  }
}

// dxs = 0.5 xs over the window's row-steps (the arms without the dx
// product), every thread of the grid in turn.
template <typename W, typename R>
__device__ __forceinline__ void dxs_half(const Bwd<W, R>& a, int r0, int nr) {
  const int D = a.p.D;
  const size_t n = (size_t)a.T * nr * D;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t i = e / D, q = e - i * D;
    const size_t at = (i / nr * a.B + r0 + i % nr) * D + q;
    a.dxs[at] = a.xs[at] * 0.5f;
  }
}

// The backward's floor arm: no recompute, no product, no barrier. Each
// thread walks its pairs' whole sequences backwards, kFloorPairs at a
// time, with dh and dc in registers: d_pre = dh + 0.1 dc [+ x_bias] summed
// into dx_bias, dc' = 0.9 dc + 1e-3 c_prev, dh' = 0.5 dh + 1e-3 h_prev;
// then dxs = 0.5 xs.
template <typename W, typename R>
__device__ __forceinline__ void ln_bwd_floor(const Bwd<W, R>& a, int b0,
                                             int nb, int j0, int nu, int r0,
                                             int nr) {
  constexpr int P = kFloorPairs;
  const int H = a.p.H, G = 4 * H, B = a.B;
  const float* xbp = a.p.xb;
  for (int q0 = threadIdx.x; q0 < nb * kUnits; q0 += P * kLoopThreads) {
    bool ok[P];
    int row[P], j[P];
    float dh[P], dc[P], xbv[P][4], acc[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int q = q0 + i * kLoopThreads;
      ok[i] = q < nb * kUnits && q % kUnits < nu;
      row[i] = b0 + (ok[i] ? q / kUnits : 0);
      j[i] = j0 + (ok[i] ? q % kUnits : 0);
      const size_t at = (size_t)row[i] * H + j[i];
      dh[i] = ok[i] && a.dhT != nullptr ? a.dhT[at] : 0.0f;
      dc[i] = ok[i] && a.dcT != nullptr ? a.dcT[at] : 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        xbv[i][g] = ok[i] && xbp != nullptr
                        ? xbp[(size_t)row[i] * G + g * H + j[i]]
                        : 0.0f;
        acc[i][g] = 0.0f;
      }
    }
    for (int s = a.T - 1; s >= 0; --s) {
      float hp[P], c_prev[P], dhs[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const size_t at = ((size_t)s * B + row[i]) * H + j[i];
        hp[i] = s > 0 ? to_f(a.hs[at - (size_t)B * H])
                      : rnd<R>(a.h0[(size_t)row[i] * H + j[i]]);
        c_prev[i] = to_f(a.cs[at]);
        dhs[i] = to_f(a.dhs[at]);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float dh_tot = dh[i] + dhs[i];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = dh_tot + dc[i] * 0.1f;
          if (xbp != nullptr) v = v + xbv[i][g];
          acc[i][g] += v;
        }
        dc[i] = dc[i] * 0.9f + c_prev[i] * 1e-3f;
        dh[i] = dh_tot * 0.5f + hp[i] * 1e-3f;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!ok[i]) continue;
      a.dc0[(size_t)row[i] * H + j[i]] = dc[i];
      a.dh0[(size_t)row[i] * H + j[i]] = dh[i];
      if (a.dxb != nullptr) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          a.dxb[(size_t)row[i] * G + g * H + j[i]] = acc[i][g];
      }
    }
  }
  dxs_half(a, r0, nr);
}

// 3. The serial loop, one persistent cooperative kernel on the LSTM
// loop's grid, its phases (a)-(c) ln_loop.cuh's (shared with the HyperLSTM
// backward's loop). Block (tile, slice) keeps the wh rows of its units
// resident (as float) and the dh parts of its pairs in shared memory;
// thread tid owns the pairs q = tid + k * kLoopThreads, all of unit j0 +
// tid % kUnits, so a half warp holds the 16 units of one row and the
// unit's LN parameters sit in registers. Each pair's running dc (in dc0),
// LN sums (in part, [B, 10H]) and dx_bias sums (in dxb) are read and
// written by their owner only. Per step s: (a) each pair's gate block from
// the hoisted pre and statistics; the half warp sums dxh_c and dxh_c *
// xhat_c over its units into exa; barrier. (b) the cell norm's row sums,
// over the slices in order; dcv, the four dy, the LN sums, dxh stashed,
// and the gate norms' 8 partials into exb; barrier. (c) those sums in
// slice order give d_pre, written over pre in place (LnDpre), and the
// dx_bias sums; barrier. (d) dh_{s-1} for the block's rows and units
// (dh_parts). Exchanges and d_pre are written by other blocks during the
// kernel: read through L2. The ladder's arms without the corrections run
// one pass over the pairs in place of (a)-(c) (ln_phase_uncorrected,
// ln_phase_no_gates), one barrier a step; floor is ln_bwd_floor.
template <typename W, typename R, int ARM = kLnBwdProd>
__global__ void __launch_bounds__(kLoopThreads)
ln_lstm_bwd_loop_kernel(Bwd<W, R> a, LnWork w, int slices, int tiles,
                        int parts, int r0, int nr) {
  using P = LnBwdPolicy<ARM>;
  using S = typename P::Stats;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Cell<W>& p = a.p;
  const int H = p.H, G = 4 * H;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  if constexpr (P::kFloor) {
    ln_bwd_floor(a, b0, nb, j0, nu, r0, nr);
    return;
  }
  const int nb_max = (nr + tiles - 1) / tiles;
  // [kUnits][4H], zero past nu; a bf16 weight widened once, exactly (its
  // unpacking at every use cost more than the bytes it saves)
  float* s_w = reinterpret_cast<float*>(smem_raw);
  // [parts][nb_max][kUnits]: dh of every pair is the sum of its parts
  float* s_part = s_w + kUnits * G;
  float* s_ex = s_part + parts * nb_max * kUnits;  // [kLnRows][slices][8]
  const LnCtx<kUnits> c = ln_ctx<kUnits>(a, s_part, s_ex, slices, sl, j0,
                                         nu, b0, nb, nb_max, parts, 10 * H);
  const int tid = threadIdx.x;

  for (int e = tid; e < kUnits * G; e += kLoopThreads) {
    const int k = e / G, cc = e - k * G;
    s_w[e] = k < nu ? to_f(p.wh[(size_t)(j0 + k) * G + cc]) : 0.0f;
  }
  ln_init<kUnits, P::kGates>(a, c, nb_max);
  __syncthreads();  // s_part holds dhT
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  for (int s = a.T - 1; s >= 0; --s) {
    if constexpr (P::kExchanges) {
      ln_phase_a<kUnits, W, R, S>(a, c, w, s);
      grid.sync();  // exa complete
      ln_phase_b<kUnits, W, R, S>(a, c, w, s);
      grid.sync();  // exb complete
      LnDpre e(a.dxb, H);
      ln_phase_c<kUnits, W, R, LnDpre, S>(a, c, w, s, e);
    } else if constexpr (P::kGates) {
      ln_phase_uncorrected<kUnits, S>(a, c, w, s);
    } else {
      ln_phase_no_gates(a, c, s);
    }
    grid.sync();  // d_pre[s] complete across the grid
    dh_parts<W>(a.dpre + ((size_t)s * a.B + b0) * G, s_w, s_part, H, nb,
                nb_max, parts);
    __syncthreads();  // every part of this step's dh written
  }
  if constexpr (P::kWeightPass) {
    if (a.dxs != nullptr) dxs_rows(a, r0, nr);
  } else {
    dxs_half(a, r0, nr);
  }
  ln_dh0(a, c);
}

// The LN loop's grid (the LSTM loop's) and shared memory (the resident wh
// rows, the dh parts, a pass's rows of an exchange) for a window of rows.
template <typename W>
size_t ln_loop_smem(int rows, int H, int sms) {
  const LoopGrid g = loop_grid<W>(rows, H, sms);
  const int nb_max = (rows + g.tiles - 1) / g.tiles;
  return ((size_t)kUnits * 4 * H + (size_t)g.parts * nb_max * kUnits +
          (size_t)kLnRows * g.slices * 8) *
         sizeof(float);
}

// The LN loop's windows, planned before any launch (ready_loop); windows >
// 0 forces that many (the ladder's grid-scaling runs).
template <int ARM = kLnBwdProd, typename W, typename R>
cudaError_t ln_loop_plan(const Bwd<W, R>& a, LoopPlan& plan,
                         int windows = 0) {
  if (a.B < 1 || a.dc0 == nullptr || a.dh0 == nullptr ||
      (LnBwdPolicy<ARM>::kGates && a.part == nullptr))
    return cudaErrorInvalidValue;
  int smem_max = 0;
  cudaError_t err = device_limits(plan.sms, smem_max);
  if (err != cudaSuccess) return err;
  const int H = a.p.H, sms = plan.sms;
  auto smem_for = [&](int rows) { return ln_loop_smem<W>(rows, H, sms); };
  if (windows == 0) {
    plan.win = plan_windows(a.B, (size_t)smem_max, smem_for);
  } else {
    plan.win = forced_windows(a.B, windows, (size_t)smem_max, smem_for);
    if (plan.win.n == 0) return cudaErrorInvalidValue;
  }
  plan.fn = (const void*)ln_lstm_bwd_loop_kernel<W, R, ARM>;
  const LoopGrid g0 = loop_grid<W>(plan.win.most(a.B), H, sms);
  return ready_loop(plan.fn, kLoopThreads, plan.win, g0.slices * g0.tiles,
                    sms);
}

// The four launches in order (stage 0), or one of them: 1 the recompute,
// 2 the statistics, 3 the loop with the LN parameters' row sum, 4 the
// weight pass. An arm's launches are production's less what it takes out
// (LnBwdPolicy: the recompute, the statistics, the row sum, the weight
// pass); windows > 0 forces the loop's windows.
template <typename W, typename R, int ARM = kLnBwdProd>
cudaError_t launch_ln_lstm_bwd(const Bwd<W, R>& a, float* work, int stage,
                               float* dwx, float* dwh, float* dln,
                               cudaStream_t stream, int windows = 0) {
  using P = LnBwdPolicy<ARM>;
  const int H = a.p.H, M = a.T * a.B;
  if (H < 1 || H > kMaxThreads || stage < 0 || stage > 4)
    return cudaErrorInvalidValue;
  const bool loop = stage == 0 || stage == 3;
  LoopPlan plan;
  cudaError_t err = loop ? ln_loop_plan<ARM>(a, plan, windows) : cudaSuccess;
  LnWork w = ln_arm_work<ARM>(work, a.T, a.B, H, (H + kUnits - 1) / kUnits);
  if (err == cudaSuccess && (stage == 0 || stage == 1) && P::kRecompute)
    err = launch_product<W>(PreOp<W, R>{a}, 1, stream);
  if (err == cudaSuccess && (stage == 0 || stage == 2) && P::kStats &&
      M > 0) {
    ln_stats_kernel<W, R><<<M, threads_for(H), 0, stream>>>(a, w.stats);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && loop) {
    for (int win = 0; win < plan.win.n && err == cudaSuccess; ++win) {
      int r0 = plan.win.first(win, a.B), nr = plan.win.rows(win, a.B);
      LoopGrid g = loop_grid<W>(nr, H, plan.sms);
      Bwd<W, R> args = a;
      void* params[] = {&args, &w, &g.slices, &g.tiles, &g.parts, &r0, &nr};
      err = cudaLaunchCooperativeKernel(
          plan.fn, dim3(g.slices * g.tiles), dim3(kLoopThreads), params,
          ln_loop_smem<W>(nr, H, plan.sms), stream);
    }
    if (err == cudaSuccess && P::kGates) {
      sum_rows_kernel<<<(10 * H + 255) / 256, 256, 0, stream>>>(a.part, a.B,
                                                                10 * H, dln);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess && (stage == 0 || stage == 4) && P::kWeightPass) {
    const WgArgs<R> wg = wg_lstm_args(a.xs, a.h0, a.hs, a.dpre, a.T, a.B,
                                      a.p.D, H, 0, a.wg, dwx, dwh, nullptr);
    err = launch_weight_grad_pass<W>(wg, stream);
  }
  return err;
}

}  // namespace
