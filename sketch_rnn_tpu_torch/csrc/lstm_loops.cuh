// The persistent weight-resident LSTM loops of the PyTorch port, shared by
// two users: fused_rnn.cu (srt_lstm_fwd and srt_lstm_bwd's loop, rows 3
// and 4: fused_lstm and fused_lstm_seq) and lstm_seq.cu (srt_lstm_seq_fwd
// and srt_lstm_seq_bwd's loop, row 7: the cuDNN-layout LSTM with its
// reserve space). fused_rnn.cu's header has the design ("Design of the
// LSTM forward", "Design of the LSTM backward", "Row windows");
// lstm_seq.cu's says what differs for the reserve.
//
// Two compile-time policies tell the users apart; the rest of each loop is
// one code:
//  - the forward's x part (XProduct, XStreamed): x_t @ wx + b from the
//    resident wx columns, computed while the h rows are in flight (rows 3
//    and 4), or the streamed row xp[t, b, 4H] of a projection made outside
//    for all steps at once, read while the h rows are in flight, with the
//    post-activation gates (i, unmasked g, f, o) stored as cuDNN's reserve
//    (row 7);
//  - the backward's gate-block source (GatesRecompute, GatesReserve): the
//    pre-activations the hoisted recompute left in the d_pre scratch, or
//    the stored gates of the reserve (no recompute launch).
// Either way every pre-activation is the row-block design's in-order fmaf
// chain over k, so each forward is bit for bit its user's row-block entry,
// and the backward's dh sums take the loop's fixed order.
//
// Everything sits in an unnamed namespace: each translation unit gets its
// own copy.

#pragma once

#include <cooperative_groups.h>

#include "persist.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

// A call's weights and arguments, taken by every kernel of fused_rnn.cu
// and by the loops here (lstm_seq.cu fills them with D = 0 and no b).
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
  WgPlan wg;    // the weight pass's split-K plan and partials scratch
  int T, B;
};

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

// ---------------------------------------------------------------------------
// The backward's serial loop, one persistent cooperative kernel. Block
// (tile, slice) owns the batch rows of its tile and the hidden units of its
// slice (kUnits at most): their dh, dc and dx_bias sums stay in its shared
// memory for the whole sequence, and so do the wh rows of its units, all
// 4H columns. Per step: the gate block of each owned (b, j) from its
// source S (the recomputed pre, read and overwritten by d_pre in place, or
// the stored gates, d_pre written beside them), one grid barrier, then
// dh_{s-1}[b, k] = sum_c rnd_W(d_pre[s, b, c]) wh[k, c] for its rows b and
// units k. d_pre is written by other blocks during this kernel, so it is
// read with ld.global.cg (L2, never a stale L1 line).
constexpr int kLoopThreads = 256, kLoopWarps = kLoopThreads / 32;
constexpr int kUnits = 16;  // hidden units (wh rows) per slice
constexpr int kBGroup = 4;  // batch rows per warp task

// Sum 32 lanes' v[64] so that lane l ends with the sums of v[2 l] and
// v[2 l + 1] in v[0], v[1]: halve, exchange, add, five times.
template <int HALF, int O, int N>
__device__ __forceinline__ void rs_stage(float (&v)[N], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float lo = v[i], hi = v[i + HALF];
    const float keep = up ? hi : lo;
    v[i] = keep + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
  }
}

// one quad (4 columns) of a resident weight row, as float
__device__ __forceinline__ float4 quad(const float* w) {
  return *reinterpret_cast<const float4*>(w);
}
__device__ __forceinline__ float4 quad(const bf16* w) {
  const uint2 r = *reinterpret_cast<const uint2*>(w);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

template <typename W>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<W>(v.x), rnd<W>(v.y), rnd<W>(v.z), rnd<W>(v.w));
}

// The transposed product of a backward loop's step: the parts of
// dh_{s-1}[b, k] = sum_c rnd_W(d_pre[s, b, c]) wh[k, c] for the block's nb
// rows b (d_pre rows from dps on, written by other blocks of the kernel:
// read through L2) and its kUnits units k (the wh rows resident in s_w,
// as W or widened to float, zero past the slice), into s_part
// [parts][nb_max][kUnits]. A warp task
// is kBGroup rows x kUnits units over one part of the 4H columns, taken a
// quad (4 columns) at a time by the lanes in turn; a shuffle
// reduce-scatter leaves each lane two sums. The caller sums the parts in
// order after a __syncthreads.
template <typename W, typename S>
__device__ __forceinline__ void dh_parts(const float* dps, const S* s_w,
                                         float* s_part, int H, int nb,
                                         int nb_max, int parts) {
  const int G = 4 * H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntasks = (nb + kBGroup - 1) / kBGroup * parts;
  for (int task = warp; task < ntasks; task += kLoopWarps) {
    const int grp = task / parts, part = task - grp * parts;
    const int q_lo = part * H / parts, q_hi = (part + 1) * H / parts;
    const float4* rows[kBGroup];
    bool valid[kBGroup];
#pragma unroll
    for (int r = 0; r < kBGroup; ++r) {
      const int bl = grp * kBGroup + r;
      valid[r] = bl < nb;
      rows[r] = reinterpret_cast<const float4*>(
          dps + (size_t)(valid[r] ? bl : 0) * G);
    }
    float acc[kBGroup * kUnits];
#pragma unroll
    for (int e = 0; e < kBGroup * kUnits; ++e) acc[e] = 0.0f;
    for (int qd = q_lo + lane; qd < q_hi; qd += 32) {
      float4 d[kBGroup];
#pragma unroll
      for (int r = 0; r < kBGroup; ++r)
        d[r] = valid[r] ? rnd4<W>(__ldcg(rows[r] + qd))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const float4 w = quad(s_w + (size_t)k * G + 4 * qd);
#pragma unroll
        for (int r = 0; r < kBGroup; ++r) {
          float v = acc[r * kUnits + k];
          v = fmaf(d[r].x, w.x, v);
          v = fmaf(d[r].y, w.y, v);
          v = fmaf(d[r].z, w.z, v);
          acc[r * kUnits + k] = fmaf(d[r].w, w.w, v);
        }
      }
    }
    rs_stage<32, 16>(acc, lane);
    rs_stage<16, 8>(acc, lane);
    rs_stage<8, 4>(acc, lane);
    rs_stage<4, 2>(acc, lane);
    rs_stage<2, 1>(acc, lane);
    // lane l holds entries 2 l, 2 l + 1: row l / 8, units 2 (l % 8) + 0, 1
    const int bl = grp * kBGroup + (lane >> 3), k = (lane & 7) * 2;
    if (bl < nb) {
      float* dst = s_part + ((size_t)part * nb_max + bl) * kUnits + k;
      dst[0] = acc[0];
      dst[1] = acc[1];
    }
  }
}

// dxs = rnd_W(d_pre) @ wx^T for every row-step of the window's rows r0 ..
// r0 + nr - 1 after a backward loop's last grid barrier: no recurrence, so
// every warp of the grid takes row-steps (t, r0 + i), i + t * nr in turn
// (with one window, the row-steps in memory order).
template <typename W, typename R>
__device__ __forceinline__ void dxs_rows(const Bwd<W, R>& a, int r0, int nr) {
  const int H = a.p.H, G = 4 * H, D = a.p.D, lane = threadIdx.x & 31;
  const size_t rows_all = (size_t)a.T * nr;
  const size_t nwg = (size_t)gridDim.x * kLoopWarps;
  for (size_t i = (size_t)blockIdx.x * kLoopWarps + (threadIdx.x >> 5);
       i < rows_all; i += nwg) {
    const size_t mr = i / nr * a.B + r0 + i % nr;
    const float4* row = reinterpret_cast<const float4*>(a.dpre + mr * G);
    for (int q0 = 0; q0 < D; q0 += 8) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
      for (int qd = lane; qd < H; qd += 32) {
        const float4 dv = rnd4<W>(__ldcg(row + qd));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (q0 + e < D) {
            const W* w = a.p.wx + (size_t)(q0 + e) * G + 4 * qd;
            float v = fmaf(dv.x, to_f(w[0]), acc[e]);
            v = fmaf(dv.y, to_f(w[1]), v);
            v = fmaf(dv.z, to_f(w[2]), v);
            acc[e] = fmaf(dv.w, to_f(w[3]), v);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        if (lane == e && q0 + e < D) a.dxs[mr * D + q0 + e] = acc[e];
      }
    }
  }
}

// The gate block's source, a compile-time policy. GatesRecompute (rows 3
// and 4): the pre-activations that srt_lstm_bwd's hoisted recompute left in
// the d_pre scratch, activated here (the forget bias, then the sigmoids and
// tanh) and overwritten by their gradients. GatesReserve (row 7): the
// post-activation gates (i, unmasked g, f, o) the forward stored [T, B,
// 4H]; nothing is recomputed, and d_pre is written beside them.
struct GatesRecompute {
  static constexpr bool kReserve = false;
};
struct GatesReserve {
  static constexpr bool kReserve = true;
  const float* gates;  // [T, B, 4H]
};

template <typename W, typename R, typename S>
__global__ void __launch_bounds__(kLoopThreads)
lstm_bwd_loop_kernel(Bwd<W, R> a, S src, int slices, int tiles, int parts,
                     int r0, int nr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Cell<W>& p = a.p;
  const int H = p.H, G = 4 * H, B = a.B;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  const int nb_max = (nr + tiles - 1) / tiles;
  W* s_w = reinterpret_cast<W*>(smem_raw);  // [kUnits][4H], zero past nu
  float* s_dh = reinterpret_cast<float*>(smem_raw + kUnits * G * sizeof(W));
  float* s_dc = s_dh + nb_max * kUnits;        // [nb_max][kUnits]
  float* s_xb = s_dc + nb_max * kUnits;        // [nb_max][kUnits][4]
  float* s_part = s_xb + 4 * nb_max * kUnits;  // [parts][nb_max][kUnits]
  const int tid = threadIdx.x;
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;

  for (int e = tid; e < kUnits * G; e += kLoopThreads) {
    const int k = e / G, c = e - k * G;
    s_w[e] = k < nu ? p.wh[(size_t)(j0 + k) * G + c] : from_f<W>(0.0f);
  }
  // pair q = (row b0 + q / kUnits, unit j0 + q % kUnits), real when the
  // unit is below nu; each thread keeps the same pairs throughout
  const int npairs = nb * kUnits;
  for (int q = tid; q < npairs; q += kLoopThreads) {
    const int u = q % kUnits;
    const size_t at = (size_t)(b0 + q / kUnits) * H + j0 + u;
    s_dh[q] = (u < nu && a.dhT != nullptr) ? a.dhT[at] : 0.0f;
    s_dc[q] = (u < nu && a.dcT != nullptr) ? a.dcT[at] : 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) s_xb[4 * q + g] = 0.0f;
  }
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  for (int s = a.T - 1; s >= 0; --s) {
    for (int q = tid; q < npairs; q += kLoopThreads) {
      const int u = q % kUnits;
      if (u >= nu) continue;
      const int row = b0 + q / kUnits, j = j0 + u;
      const size_t at = ((size_t)s * B + row) * H + j;
      float* dpr = a.dpre + ((size_t)s * B + row) * G;
      float pre[4];
      if constexpr (!S::kReserve) {
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = __ldcg(dpr + g * H + j);
      }
      const float c_prev = to_f(a.cs[at]);
      const float dh_tot = s_dh[q] + to_f(a.dhs[at]);
      const float dc = s_dc[q];
      const float m = dropout_mask(a.drop, seed, s, B, row, H, j);
      float i, gu, f, o;
      if constexpr (S::kReserve) {
        const float* gt = src.gates + ((size_t)s * B + row) * G + j;
        i = gt[0];
        gu = gt[H];
        f = gt[2 * H];
        o = gt[3 * H];
      } else {
        i = sigmoidf_(pre[0]);
        gu = tanhf(pre[1]);
        f = sigmoidf_(pre[2] + p.forget_bias);
        o = sigmoidf_(pre[3]);
      }
      const float nc = c_prev * f + i * (gu * m);
      const float tanh_c = tanhf(nc);
      const float dcv = dc + dh_tot * o * (1.0f - tanh_c * tanh_c);
      const float do_ = dh_tot * tanh_c;
      const float df = dcv * c_prev;
      const float di = dcv * (gu * m);
      const float dgu = dcv * i * m;
      const float dp[4] = {di * i * (1.0f - i), dgu * (1.0f - gu * gu),
                           df * f * (1.0f - f), do_ * o * (1.0f - o)};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dpr[g * H + j] = dp[g];
        s_xb[4 * q + g] += dp[g];
      }
      s_dc[q] = dcv * f;
    }
    grid.sync();  // d_pre[s] complete across the grid
    dh_parts<W>(a.dpre + ((size_t)s * B + b0) * G, s_w, s_part, H, nb,
                nb_max, parts);
    __syncthreads();  // every part of this step's dh written
    for (int q = tid; q < npairs; q += kLoopThreads) {
      float sum = 0.0f;
      for (int pt = 0; pt < parts; ++pt)
        sum += s_part[(size_t)pt * nb_max * kUnits + q];
      s_dh[q] = sum;
    }
  }
  if (a.dxs != nullptr) dxs_rows(a, r0, nr);
  for (int q = tid; q < npairs; q += kLoopThreads) {
    const int u = q % kUnits;
    if (u >= nu) continue;
    const int row = b0 + q / kUnits, j = j0 + u;
    if (a.dc0 != nullptr) {
      a.dc0[(size_t)row * H + j] = s_dc[q];
      a.dh0[(size_t)row * H + j] = s_dh[q];
    }
    if (a.dxb != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        a.dxb[(size_t)row * G + g * H + j] = s_xb[4 * q + g];
    }
  }
}

// The loop's grid: slices of kUnits hidden units, then as many batch tiles
// as fill the SMs once; an error, never a fallback, when that many blocks
// cannot co-reside. Warp tasks split the columns into parts when the
// tile's row groups would leave warps idle.
struct LoopGrid {
  int slices, tiles, parts;
  size_t smem;
};

template <typename W>
LoopGrid loop_grid(int B, int H, int sms) {
  LoopGrid g;
  g.slices = (H + kUnits - 1) / kUnits;
  const int fill = sms / g.slices > 0 ? sms / g.slices : 1;
  g.tiles = B < fill ? B : fill;
  const int nb_max = (B + g.tiles - 1) / g.tiles;
  const int groups = (nb_max + kBGroup - 1) / kBGroup;
  g.parts = kLoopWarps / groups;
  if (g.parts > H / 32) g.parts = H / 32;
  if (g.parts < 1) g.parts = 1;
  g.smem = (size_t)kUnits * 4 * H * sizeof(W) +
           (size_t)nb_max * kUnits * (6 + g.parts) * sizeof(float);
  return g;
}

// The LSTM loop's windows, planned before any of its user's launches
// (srt_lstm_bwd, srt_lstm_seq_bwd).
struct LoopPlan {
  Windows win;
  int sms;
  const void* fn;
};

template <typename S, typename W, typename R>
cudaError_t loop_plan(const Bwd<W, R>& a, LoopPlan& plan) {
  if (a.B < 1) return cudaErrorInvalidValue;
  int smem_max = 0;
  cudaError_t err = device_limits(plan.sms, smem_max);
  if (err != cudaSuccess) return err;
  const int H = a.p.H, sms = plan.sms;
  plan.win = plan_windows(a.B, (size_t)smem_max, [&](int rows) {
    return loop_grid<W>(rows, H, sms).smem;
  });
  plan.fn = (const void*)lstm_bwd_loop_kernel<W, R, S>;
  const LoopGrid g0 = loop_grid<W>(plan.win.most(a.B), H, sms);
  return ready_loop(plan.fn, kLoopThreads, plan.win, g0.slices * g0.tiles,
                    sms);
}

// The loop over the plan's windows; src is the plan's gate-block source.
template <typename W, typename R, typename S>
cudaError_t launch_loop(const Bwd<W, R>& a, S src, const LoopPlan& plan,
                        cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  for (int w = 0; w < plan.win.n && err == cudaSuccess; ++w) {
    int r0 = plan.win.first(w, a.B), nr = plan.win.rows(w, a.B);
    LoopGrid g = loop_grid<W>(nr, a.p.H, plan.sms);
    Bwd<W, R> args = a;
    void* params[] = {&args, &src, &g.slices, &g.tiles, &g.parts, &r0, &nr};
    err = cudaLaunchCooperativeKernel(plan.fn, dim3(g.slices * g.tiles),
                                      dim3(kLoopThreads), params, g.smem,
                                      stream);
  }
  return err;
}

// ---------------------------------------------------------------------------
// The LSTM forward of srt_lstm_fwd and srt_lstm_seq_fwd: one persistent
// cooperative kernel (fused_rnn.cu's header, "Design of the LSTM
// forward"). Per step and chunk of rows each
// warp takes at most one task, kTaskUnits units x (kRowLanes * ROWS) rows:
// lane l takes unit l % 8 and the rows l / 8 + 4 i (i < ROWS), all four
// gates of each. The chunk's h rows arrive by cp.async in kParts groups
// over k, so the product over part p runs while the later parts are in
// flight.
constexpr int kFwdThreads = 256, kFwdWarps = kFwdThreads / 32;
constexpr int kTaskUnits = 8;               // units per warp task
constexpr int kRowLanes = 32 / kTaskUnits;  // row groups per warp task
constexpr int kParts = 4;                   // cp.async groups over k
constexpr int kMaxXd = 8;                   // x inputs held in registers

// elements per resident h row: whole 16-byte copies, plus a pad that puts
// the rows of one 8-byte read (bf16) in distinct banks
template <typename W>
__host__ __device__ inline int fwd_row_stride(int H) {
  return (H + 7) / 8 * 8 + 16 / (int)sizeof(W);
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  static_assert(kParts == 4, "one case per part");
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else
    asm volatile("cp.async.wait_group 3;\n" ::);
}

// one h value written by another block of this kernel (L2, not L1)
__device__ __forceinline__ float ldcg_raw(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg_raw(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// h_{t-1} of the rows row0 .. row0 + cr - 1 into s_h (row stride rs, type
// W). At t = 0 (hin null) rnd_W(h0) through registers. After it the hx
// plane of the previous step, written by other blocks of this kernel: by
// 16-byte cp.async.cg (L2, never a stale L1 line), kp columns of every row
// per commit group, when the rows allow it, else element by element. Each
// thread commits kParts groups either way.
template <typename W>
__device__ __forceinline__ void load_h_chunk(W* s_h, int rs, const float* h0,
                                             const W* hin, bool async,
                                             size_t row0, int cr, int H,
                                             int kp) {
  constexpr int kE = 16 / sizeof(W);  // elements per copy
  if (hin != nullptr && async) {
    for (int part = 0; part < kParts; ++part) {
      const int k0 = part * kp, k1 = k0 + kp < H ? k0 + kp : H;
      const int n = k0 < H ? (k1 - k0) / kE : 0;  // copies per row
      for (int e = threadIdx.x; e < cr * n; e += kFwdThreads) {
        const int r = e / n, k = k0 + (e - r * n) * kE;
        cp_async16(s_h + r * rs + k, hin + (row0 + r) * H + k);
      }
      cp_async_commit();
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < cr * H; e += kFwdThreads) {
    const int r = e / H, k = e - r * H;
    const size_t at = (row0 + r) * H + k;
    s_h[r * rs + k] = hin == nullptr ? from_f<W>(h0[at]) : ldcg_raw(hin + at);
  }
  for (int part = 0; part < kParts; ++part) cp_async_commit();
}

// The x part of the forward, a compile-time policy. XProduct (rows 3 and
// 4): x_t @ wx + b from the resident wx columns and b (Fwd::xs, Cell::D
// inputs), computed while the h rows are in flight. XStreamed (row 7): the
// row xp[t, b, 4H] of a projection made outside (Cell::D = 0, no b), read
// while the h rows are in flight; the post-activation gates (i, unmasked
// g, f, o) are stored to gates[t, b, 4H], cuDNN's reserve.
struct XProduct {
  static constexpr bool kStreamed = false;
};
struct XStreamed {
  static constexpr bool kStreamed = true;
  const float* xp;  // [T, B, 4H]
  float* gates;     // [T, B, 4H]
};

// lstm_seq's gate block from the x part xp and the recurrent sums acc of
// one (row, unit): the post-activation gates (i, unmasked g, f, o), the
// new cell state and h. Every sum and product is rounded on its own (the
// _rn intrinsics: no contraction into a fused multiply-add, which the
// compiler chooses by context), so the loop, which calls it, and
// lstm_seq.cu's row-block kernel, which writes the same operations out,
// agree bit for bit (the same expressions left to the compiler did not).
// The division is IEEE round-to-nearest as 1.0f / d, as in sigmoidf_.
__device__ __forceinline__ float sigmoid_rn(float x) {
  return 1.0f / __fadd_rn(1.0f, expf(-x));
}
__device__ __forceinline__ void seq_gates(const float (&xp)[4],
                                          const float (&acc)[4], float c,
                                          float m, float forget_bias,
                                          float& i, float& gu, float& f,
                                          float& o, float& nc, float& nh) {
  i = sigmoid_rn(__fadd_rn(xp[0], acc[0]));
  gu = tanhf(__fadd_rn(xp[1], acc[1]));
  f = sigmoid_rn(__fadd_rn(__fadd_rn(xp[2], acc[2]), forget_bias));
  o = sigmoid_rn(__fadd_rn(xp[3], acc[3]));
  nc = __fadd_rn(__fmul_rn(c, f), __fmul_rn(i, __fmul_rn(gu, m)));
  nh = __fmul_rn(tanhf(nc), o);
}

template <typename W, typename R, int ROWS, typename X>
__global__ void __launch_bounds__(kFwdThreads)
lstm_fwd_loop_kernel(Fwd<W, R> a, X xin, W* hx, int slices, int tiles,
                     int chunk, int r0, int nr) {
  constexpr int kTaskRows = kRowLanes * ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Cell<W>& p = a.p;
  const int H = p.H, G = 4 * H, B = a.B, D = p.D;
  const int sl = blockIdx.x % slices, bt = blockIdx.x / slices;
  const int j0 = sl * H / slices, nu = (sl + 1) * H / slices - j0;
  const int b0 = r0 + bt * nr / tiles;
  const int nb = (bt + 1) * nr / tiles - bt * nr / tiles;
  const int nb_max = (nr + tiles - 1) / tiles;
  const int rs = fwd_row_stride<W>(H);
  const int kp = ((H + kParts - 1) / kParts + 7) / 8 * 8;  // k per part
  // [H + D][kUnits][4]: the wh rows, then the wx rows; zero past nu
  float* s_w = reinterpret_cast<float*>(smem_raw);
  const float* s_wx = s_w + (size_t)H * kUnits * 4;
  float* s_b = s_w + (size_t)(H + D) * kUnits * 4;  // [kUnits][4]
  float* s_c = s_b + kUnits * 4;                     // [nb_max][kUnits]
  W* s_h = reinterpret_cast<W*>(s_c + (size_t)nb_max * kUnits);  // [chunk][rs]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t seed = a.drop.seed != nullptr ? (uint32_t)*a.drop.seed : 0u;
  const bool async = H % (16 / (int)sizeof(W)) == 0 &&
                     (reinterpret_cast<uintptr_t>(hx) & 15) == 0;

  for (int e = tid; e < (H + D) * kUnits * 4; e += kFwdThreads) {
    const int k = e / (kUnits * 4), u = (e / 4) % kUnits;
    const int col = (e % 4) * H + j0 + u;
    float v = 0.0f;
    if (u < nu)
      v = to_f(k < H ? p.wh[(size_t)k * G + col]
                     : p.wx[(size_t)(k - H) * G + col]);
    s_w[e] = v;
  }
  if (tid < kUnits * 4) {
    const int u = tid / 4;
    s_b[tid] = (u < nu && p.b != nullptr) ? p.b[(tid % 4) * H + j0 + u]
                                          : 0.0f;
  }
  for (int q = tid; q < nb * kUnits; q += kFwdThreads) {
    const int u = q % kUnits;
    s_c[q] = u < nu ? a.c0[(size_t)(b0 + q / kUnits) * H + j0 + u] : 0.0f;
  }
  __syncthreads();  // the resident state, before the first x part reads it
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const size_t plane = (size_t)B * H;
  const int u = (warp % 2) * kTaskUnits + lane % kTaskUnits;
  const float* wc = s_w + u * 4;

  for (int t = 0; t < a.T; ++t) {
    const W* hin = t == 0 ? nullptr : hx + ((t + 1) & 1) * plane;
    W* hout = hx + (t & 1) * plane;
    for (int r0 = 0; r0 < nb; r0 += chunk) {
      const int cr = nb - r0 < chunk ? nb - r0 : chunk;
      // this warp's task (the host keeps a chunk to kFwdWarps tasks)
      const bool busy =
          warp < (cr + kTaskRows - 1) / kTaskRows * (kUnits / kTaskUnits);
      const int lr0 = warp / 2 * kTaskRows + lane / kTaskUnits;
      float acc[ROWS][4], xp[ROWS][4], xbv[ROWS][4], mv[ROWS];
      float xq[ROWS][kMaxXd];
      if (busy) {  // x, x_bias and the mask, asked for ahead of the h copies
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int lr = lr0 + rr * kRowLanes;
          const bool ok = lr < cr && u < nu;
          const int row = b0 + r0 + (ok ? lr : 0), j = j0 + (ok ? u : 0);
          if constexpr (X::kStreamed) {
            const float* x = xin.xp + ((size_t)t * B + row) * G + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              xp[rr][g] = x[g * H];
              acc[rr][g] = 0.0f;
            }
          } else {
            const float* x = a.xs + ((size_t)t * B + row) * D;
#pragma unroll
            for (int q = 0; q < kMaxXd; ++q)
              xq[rr][q] = q < D ? rnd<W>(x[q]) : 0.0f;
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            xbv[rr][g] = (ok && p.xb != nullptr)
                             ? p.xb[(size_t)row * G + g * H + j]
                             : 0.0f;
          mv[rr] = dropout_mask(a.drop, seed, t, B, row, H, j);
        }
      }
      load_h_chunk<W>(s_h, rs, a.h0, hin, async, (size_t)(b0 + r0), cr, H,
                      kp);
      if (!X::kStreamed && busy) {
        // while h is in flight: x @ wx + b, gate_pre's first sum (one
        // in-order fmaf chain over the D inputs per gate)
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
            const int lr = lr0 + rr * kRowLanes;
            const int row = b0 + r0 + (lr < cr && u < nu ? lr : 0);
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
            xp[rr][g] = p.b != nullptr ? sx[g] + s_b[u * 4 + g] : sx[g];
            acc[rr][g] = 0.0f;
          }
        }
      }
      // h @ wh: one in-order fmaf chain over k per output, part by part
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        cp_async_wait(kParts - 1 - part);
        __syncthreads();  // this part of k of every row is in s_h
        if (!busy) continue;
        const int k1 = (part + 1) * kp < H ? (part + 1) * kp : H;
        int k = part * kp;
#pragma unroll 2
        for (; k + 4 <= k1; k += 4) {
          float4 hv[ROWS];
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            hv[rr] = quad(s_h + (size_t)(lr0 + rr * kRowLanes) * rs + k);
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
                to_f(s_h[(size_t)(lr0 + rr * kRowLanes) * rs + k]);
            acc[rr][0] = fmaf(h, w.x, acc[rr][0]);
            acc[rr][1] = fmaf(h, w.y, acc[rr][1]);
            acc[rr][2] = fmaf(h, w.z, acc[rr][2]);
            acc[rr][3] = fmaf(h, w.w, acc[rr][3]);
          }
        }
      }
      if (busy) {
        // the gate block of every row (rnn_fwd_kernel's, or with XStreamed
        // seq_gates, lstm_seq_fwd_kernel's); real pairs stored
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int lr = lr0 + rr * kRowLanes;
          const bool ok = lr < cr && u < nu;
          const float m = mv[rr];
          float* cp = s_c + (size_t)(r0 + (ok ? lr : 0)) * kUnits + u;
          const float c = *cp;
          float i, gu, f, o, nc, nh;
          if constexpr (X::kStreamed) {
            seq_gates(xp[rr], acc[rr], c, m, p.forget_bias, i, gu, f, o, nc,
                      nh);
          } else {
            float pre[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              pre[g] = xp[rr][g] + acc[rr][g];
              if (p.xb != nullptr) pre[g] = pre[g] + xbv[rr][g];
            }
            i = sigmoidf_(pre[0]);
            gu = tanhf(pre[1]);
            f = sigmoidf_(pre[2] + p.forget_bias);
            o = sigmoidf_(pre[3]);
            nc = c * f + i * (gu * m);
            nh = tanhf(nc) * o;
          }
          if (!ok) continue;
          const int row = b0 + r0 + lr, j = j0 + u;
          const size_t at = ((size_t)t * B + row) * H + j;
          a.cs[at] = from_f<R>(c);
          a.hs[at] = from_f<R>(nh);
          hout[(size_t)row * H + j] = from_f<W>(nh);
          *cp = nc;
          if constexpr (X::kStreamed) {
            float* gt = xin.gates + ((size_t)t * B + row) * G + j;
            gt[0] = i;
            gt[H] = gu;
            gt[2 * H] = f;
            gt[3 * H] = o;
          }
          if (a.cT != nullptr && t == a.T - 1) {
            a.cT[(size_t)row * H + j] = nc;
            a.hT[(size_t)row * H + j] = nh;
          }
        }
      }
      __syncthreads();  // all reads of s_h and s_c done: next chunk
    }
    grid.sync();  // hx[t & 1] complete across the grid
  }
  if (a.cT != nullptr && a.T == 0) {  // no step: the final carry is the first
    for (int q = tid; q < nb * kUnits; q += kFwdThreads) {
      if (q % kUnits >= nu) continue;
      const size_t at = (size_t)(b0 + q / kUnits) * H + j0 + q % kUnits;
      a.cT[at] = a.c0[at];
      a.hT[at] = a.h0[at];
    }
  }
}

// The forward's grid (the backward loop's slices and tiles), rows per
// thread and shared memory. Rows per thread: 4 for float weights where a
// tile has more than 16 rows (four warp tasks still keep every SM
// sub-partition busy, and each float read feeds two multiply-adds), else 2
// (bf16: its h rows are half as many bytes to read, and eight warps hide
// latency better than four; measured on an H100). Shared memory: the
// resident columns, b and the carries, then as many h rows per chunk as
// fit, a multiple of a task's rows, at most the tile's rows rounded up and
// at most one task per warp. False when not even one task's rows fit.
struct FwdGrid {
  int slices, tiles, rows, chunk;
  size_t smem;
};

template <typename W>
bool fwd_grid(int B, int H, int D, int sms, int smem_max, FwdGrid& g) {
  const LoopGrid lg = loop_grid<float>(B, H, sms);
  g.slices = lg.slices;
  g.tiles = lg.tiles;
  const int nb_max = (B + g.tiles - 1) / g.tiles;
  g.rows = sizeof(W) == 4 && nb_max > 4 * kRowLanes ? 4 : 2;
  const int task_rows = kRowLanes * g.rows;
  const size_t fixed =
      ((size_t)(H + D + 1) * kUnits * 4 + (size_t)nb_max * kUnits) *
      sizeof(float);
  const size_t row = (size_t)fwd_row_stride<W>(H) * sizeof(W);
  if (fixed + task_rows * row > (size_t)smem_max) return false;
  int chunk = (int)(((size_t)smem_max - fixed) / row) / task_rows * task_rows;
  const int need = (nb_max + task_rows - 1) / task_rows * task_rows;
  const int most = kFwdWarps / (kUnits / kTaskUnits) * task_rows;
  if (chunk > need) chunk = need;
  if (chunk > most) chunk = most;
  g.chunk = chunk;
  g.smem = fixed + (size_t)chunk * row;
  return true;
}

// A forward loop over windows of rows (persist.cuh): grid_for(rows, sms,
// smem_max, g) sizes a window's grid (false where none forms), kernel(g)
// is the kernel of a window's rows per thread, launch(fn, g, r0, nr)
// launches it over the window of nr rows from r0. Both windows' sizes are
// made ready before the first launch. windows > 0 forces that many
// (forced_windows; cudaErrorInvalidValue where they do not fit).
template <typename GridFor, typename KernelFor, typename Launch>
cudaError_t fwd_windows(int B, int H, GridFor&& grid_for, KernelFor&& kernel,
                        Launch&& launch, int windows = 0) {
  if (B < 1 || H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(sms, smem_max);
  if (err != cudaSuccess) return err;
  auto smem_for = [&](int rows) {
    FwdGrid g;
    return grid_for(rows, sms, smem_max, g) ? g.smem : SIZE_MAX;
  };
  const Windows win =
      windows > 0 ? forced_windows(B, windows, (size_t)smem_max, smem_for)
                  : plan_windows(B, (size_t)smem_max, smem_for);
  if (windows > 0 && win.n == 0) return cudaErrorInvalidValue;
  FwdGrid g;
  const int sizes[2] = {win.most(B), win.n > 0 ? B / win.n : 1};
  for (int rows : sizes) {
    if (err != cudaSuccess || rows < 1) break;
    grid_for(rows, sms, smem_max, g);
    err = ready_loop(kernel(g), kFwdThreads, win, g.slices * g.tiles, sms);
  }
  for (int w = 0; w < win.n && err == cudaSuccess; ++w) {
    const int r0 = win.first(w, B), nr = win.rows(w, B);
    grid_for(nr, sms, smem_max, g);
    err = launch(kernel(g), g, r0, nr);
  }
  return err;
}

// The LSTM forward's cooperative loop over windows of rows, its x part
// from xin (XProduct: srt_lstm_fwd; XStreamed: srt_lstm_seq_fwd).
template <typename W, typename R, typename X>
cudaError_t launch_lstm_fwd_loop(const Fwd<W, R>& a, X xin, W* hx,
                                 cudaStream_t stream) {
  const int H = a.p.H, D = a.p.D;
  return fwd_windows(
      a.B, H,
      [&](int rows, int sms, int smem_max, FwdGrid& g) {
        return fwd_grid<W>(rows, H, D, sms, smem_max, g);
      },
      [](const FwdGrid& g) {
        return g.rows == 4 ? (const void*)lstm_fwd_loop_kernel<W, R, 4, X>
                           : (const void*)lstm_fwd_loop_kernel<W, R, 2, X>;
      },
      [&](const void* fn, FwdGrid& g, int r0, int nr) {
        Fwd<W, R> args = a;
        X x = xin;
        W* hxp = hx;
        void* params[] = {&args,    &x,       &hxp, &g.slices,
                          &g.tiles, &g.chunk, &r0,  &nr};
        return cudaLaunchCooperativeKernel(fn, dim3(g.slices * g.tiles),
                                           dim3(kFwdThreads), params, g.smem,
                                           stream);
      });
}

}  // namespace
