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
//   srt_ln_lstm_fwd  <- fused_ln_lstm forward, _lnlstm_fwd_kernel (:826,
//                       pallas_call at :1016)
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
// The row-block design, which every kernel here ran first and which each
// keeps reachable as srt_lstm_fwd_rowblock, srt_lstm_bwd_rowblock,
// srt_ln_lstm_fwd_rowblock and srt_ln_lstm_bwd_rowblock, to be held and
// timed beside the design that replaced it (rnn_fwd_kernel,
// rnn_bwd_kernel). The recurrence of a batch row never reads another row,
// so each of these kernels is one block per row (grid = B) with the T loop
// inside the block, one thread per hidden unit j (blockDim = H rounded up
// to a warp, H <= 512): the carry (and, backwards, dh/dc) of the row lives
// in shared memory and registers for the whole sequence. Thread j computes
// column j of the four gates, reading row k of wh coalesced across the
// block; layer-norm statistics are block reductions (block_sum). The
// backward's transposed product dh_{t-1} = d_pre @ wh^T (and dx = d_pre @
// wx^T) gives each warp whole rows of wh, read coalesced, reduced by
// shuffles.
//
// Row windows (srt_lstm_fwd, srt_lstm_bwd's loop, srt_ln_lstm_fwd,
// srt_ln_lstm_bwd's loop). Each persistent loop below holds a batch tile's
// state in one block's shared memory: the forwards' cell carries, the
// backwards' dh parts. No row of a recurrence reads another, so where the
// tiles of the whole batch do not fit, the launcher plans the least number
// n of windows of rows whose tiles do (window w the rows [w * B / n, (w +
// 1) * B / n)) and launches the loop once per window, in order on the
// stream. A window's kernel takes its first row and row count and keeps B
// as the row stride of every [T, B, .] and [B, .] buffer, so nothing is
// copied; the hoisted recompute, the LN statistics, the weight pass and
// the row sums run once over all rows. Where the batch fits, the plan is
// one window: the launch it always was. A shape whose resident state does
// not fit even at one row is refused before any launch. A forward's sums
// do not depend on the tiling, so windows change none of its outputs; a
// backward's window may split its columns into other parts (the dh sums'
// order), within tolerance.
//
// The LSTM's two persistent loops below (the forward, the backward's dh
// loop) live in lstm_loops.cuh with their grid and window launchers, shared
// by two users: this file (srt_lstm_fwd, srt_lstm_bwd; rows 3 and 4 of
// PERF.md's table) and lstm_seq.cu (srt_lstm_seq_fwd, srt_lstm_seq_bwd;
// row 7). Compile-time policies give each user its x part (here XProduct:
// x @ wx + b from resident wx columns) and its backward gate source (here
// GatesRecompute: the hoisted recompute's pre); the rest is one code.
// Likewise the LayerNorm-LSTM's two loops and their launches live in
// ln_lstm.cuh, shared with probe_ln.cu (the LayerNorm ladder, rows 8-9),
// whose arms are compile-time policies of them; production is the default.
//
// Design of the LSTM forward (srt_lstm_fwd): one persistent kernel
// launched cooperatively, on the backward loop's grid: slices of 16
// hidden units x batch tiles, at most one block per SM, refused (never
// replaced) when it cannot co-reside. Block (tile, slice) keeps resident
// in shared memory for the whole sequence the columns g * H + j (g = 0..3)
// of wh and wx for its units j and the same columns of b, laid out [row
// k][unit][gate] so one 16-byte read gives a unit's four gates, and the
// float cell carry of each (row, unit) pair it owns. The weights are held
// as float: a bf16 weight is widened once, exactly, instead of at every
// multiply-add. Blocks exchange h through a ping-pong scratch hx[2, B, H]
// of the weight type: it holds rnd_W(h), the product's operand (the stored
// hs is rounded to R, which differs from W in the mixed cases). Per step
// t, the h_{t-1} rows of the tile pass through shared memory, as W, in
// chunks of rows (all of them at the training shapes; B=4096 at H=512 fits
// in one window, B=8192 takes two): rnd_W(h0) at t = 0,
// else hx[(t + 1) & 1], copied by cp.async.cg (through L2: other blocks
// wrote it in this kernel) in four commit groups over k, so that the
// product over the first quarter of k starts while the rest is in flight;
// the x part, x_bias and the dropout mask are read meanwhile. A warp takes
// one task, 8 units x (4 x ROWS) rows of a chunk, each thread the four
// gates of one unit in ROWS rows: ROWS = 4 for float weights where a tile
// has more than 16 rows (H=512 at B=100: four warps, one per SM
// sub-partition), else 2 (eight warps at H=512 bf16, four at H=256).
// Every output is one fmaf chain over k = 0..H-1 in order
// from 0.0f, added to the x part as gate_pre adds it, so each output, and
// with it the whole forward, is bit for bit the row-block kernel's. The
// products read their operands from shared memory, whose 128 bytes per
// clock (a 16-byte read takes four of them whatever it broadcasts) and
// their latency bound them: 4 rows x 4 gates per thread make two
// multiply-adds per float read.
// The gate block is rnn_fwd_kernel's, written out again; it writes cs (the
// pre-step c) and hs as R, hx[t & 1] as W, and the final carry after the
// last step. One grid barrier per step is enough: step t + 1 writes the
// buffer step t read, and every block has left step t once it passes the
// barrier.
// Sizing per step at B=100: H=512 (32 slices x 4 tiles = 128 blocks, 25
// rows a tile) reads 32 x 100 x 512 x sizeof(W) = 6.6 MB of h from L2 at
// float (3.3 MB bf16) and keeps 200,256 bytes of shared memory per block
// at float (167,488 bf16; 132,608 of them weights and b); H=256 (16
// slices x 8 tiles, 12-13 rows) 1.6 MB (0.8 MB), 84,544 bytes (76,352).
// The row-block design read all of wh per row per step instead: 105 GB per
// call at H=512 float.
//
// Design of the LSTM backward (srt_lstm_bwd): three launches.
//  1. The hoisted gate recompute. h_{t-1} is read from the stored hs, so
//     the recompute depends on nothing the loop computes: one tiled
//     product computes pre = ((rnd_W(x) @ wx + b) + rnd_W(h_prev) @ wh)
//     [+ x_bias] for all K = T*B row-steps at once (M = T*B, K = H, N =
//     4H; the D-wide x part and the biases in the epilogue, as the two
//     sums gate_pre adds) into the d_pre scratch. bf16 weights: mma.sync
//     m16n8k16 on the tensor cores, cp.async double-buffered weight tiles;
//     float weights: a SIMT tiled product (no TF32).
//  2. The serial loop, one persistent kernel launched cooperatively: a
//     grid of (batch tiles x slices of 16 hidden units), at most one block
//     per SM, refused (never replaced) when it cannot co-reside. Each
//     block keeps the wh rows of its units (all 4H columns) resident in
//     shared memory, and the dh, dc and dx_bias sums of its (row, unit)
//     pairs. Per step s: the gate block of each owned pair from pre[s],
//     d_pre written over it in place; one grid barrier; then dh_{s-1} =
//     rnd_W(d_pre[s]) @ wh^T for its rows and units (warps split the
//     columns, a shuffle reduce-scatter, parts summed in a fixed order).
//     The owner of (b, j) computes dh[b, j] itself, so one barrier per step
//     is enough. d_pre is read with ld.global.cg: other blocks write it
//     during the kernel, and an L1 line could be stale. After the last
//     step, dxs = rnd_W(d_pre) @ wx^T has no recurrence, so every warp of
//     the grid takes rows of it.
//  3. The weight pass over the same scratch (weight_grad.cuh: split-K
//     tiles on the tensor cores at bf16, a register-tiled SIMT product at
//     float, the slices' partials added in order by a second launch).
// Sizing per loop step at H=512, B=100 (32 slices x 4 tiles = 128 blocks):
// L2 reads ~ blocks x (B / tiles) x 4H x 4 B = 26 MB; shared memory per
// block ~ 16 x 4H x sizeof(W) (128 KiB float, 64 KiB bf16) plus the pairs'
// sums; products ~ (B / tiles) x 16 x 4H multiply-adds per block. At H=256
// (16 slices x 8 tiles): 6.5 MB, 64 / 32 KiB.
//
// Design of the LayerNorm-LSTM backward (srt_ln_lstm_bwd): four launches.
//  1. The LSTM backward's hoisted recompute of pre (no b).
//  2. The statistics: the loop's layer norms need each row's sums over
//     all H units, which the loop spreads over H / 16 blocks. Of them only
//     the forward ones depend on nothing the loop computes, so one small
//     kernel computes them for every row-step from pre, cs and the mask,
//     one block per row-step with the row-block design's block sums in
//     its order: the four gates' mean and rsqrt(var + 1e-6), and those of
//     the new cell state, into a [T * B, 10] float scratch.
//  3. The serial loop, one persistent cooperative kernel on the LSTM
//     loop's grid: block (tile, slice) keeps the wh rows of its 16 units
//     resident in shared memory, widened to float (unpacking bf16 at
//     every use cost more than the bytes it saves), and the dh of its
//     (row, unit) pairs as the parts of the transposed product; each
//     pair's dc, LN-parameter
//     and dx_bias sums live in dc0, the [B, 10H] partials and dxb, each
//     read and written by its owner thread only. A half warp holds the 16
//     units of one row. Per step: (a) each pair's gate block from pre and
//     the statistics; per row the sums over the block's units of dxh_c
//     and dxh_c * xhat_c go to an exchange [B, slices, 2]; grid barrier.
//     (b) the cell norm's two row sums, the slices' partials added in
//     slice order (a pass's rows of the exchange first copied to shared
//     memory by the whole block, so that the sums do not wait on one L2
//     load after another); dcv, the four dy, the LN sums; dxh = dy * gamma is
//     stashed ([4, B, H]) and its 8 partials (dxh, dxh * xhat per gate)
//     go to [B, slices, 8]; grid barrier. (c) those sums in slice order
//     give d_pre, written over pre, and the dx_bias sums; grid barrier.
//     (d) dh_{s-1} for the block's rows and units as in the LSTM loop.
//     After the last step, dxs over the whole grid as there. Every sum
//     has a fixed order and no atomics, so every result is the same on
//     every run; the exchanges' sums are taken in another order than the
//     row-block design's block sums, so the two agree within tolerance,
//     not bit for bit.
//  4. The weight pass over the same scratch, as in the LSTM backward.
//     Each pair's loads come before its stores: through float pointers
//     the compiler cannot move a load above a store, so read-modify-writes
//     interleaved with other stores each waited out an L2 round trip.
// Sizing at H=512, B=100 (32 slices x 4 tiles = 128 blocks of 25 rows):
// shared memory per block 149,056 bytes at either dtype (wh rows 131,072,
// dh parts 1,600, a pass's 16 rows of the wider exchange 16,384); scratch
// 1,947,200 bytes beside d_pre (exchanges 128,000, statistics 1,000,000,
// the dxh stash 819,200); three grid barriers per step, 750 per call.
// B=4096 takes 212,992 bytes; at B=8192 a tile's dh parts and the wh rows
// exceed a block's shared memory, and the loop runs in two windows.
//
// Design of the LayerNorm-LSTM forward (srt_ln_lstm_fwd): one persistent
// kernel launched cooperatively on the LSTM forward's grid (slices of 16
// hidden units x batch tiles, at most one block per SM, refused when it
// cannot co-reside), with its resident columns of wh and wx (as float),
// its h exchange hx[2, B, H] and its in-order fmaf chain per output. A
// row's layer norms sum over all H units, spread over H / 16 blocks, so
// each step has three phases, each ended by a grid barrier:
//  (a) the products of the block's (row, unit) pairs, all four gates
//      (gate_pre's sums: x @ wx, then h @ wh, then x_bias); per row, each
//      gate's mean and M2 over the slice's units (two passes) go to an
//      exchange [B, slices, 8];
//  (b) per row, the slices' partials combined in slice order by Chan's
//      rule (mean = sum n_s m_s / H, M2 = sum (M2_s + n_s (m_s - mean)^2),
//      rs = rsqrt(M2 / H + 1e-6)), the gate block up to the new cell state
//      nc, and nc's slice mean and M2 to an exchange [B, slices, 2];
//  (c) the cell norm combined the same way, h = tanh(yc) * o, the stores
//      of cs (the pre-step c), hs and hx[t & 1], the final carry.
// A warp task is the 16 units of the slice x 2 x 2 rows (lane l: unit l %
// 16), so a half warp holds one row's units and the slice moments are
// half-warp shuffles; a lane combines one gate's partials for its rows,
// all rows' sums advancing together, and the half warp shares them. A
// chunk's rows of an exchange are first copied to shared memory by the
// whole block (into the chunk's h buffer, idle after the product). Where a
// tile's rows pass in one chunk (B=100), each pair's pre-activations, nc
// and o stay in registers across the barriers; where they take several
// (B=4096: 1,024 rows a tile, chunks of 16 at float, 32 at bf16), they go
// through a [4, B, H] stash in the work scratch. Every sum has a fixed
// order and no atomics, so every run gives the same result; the row
// moments are summed in another order than block_sum's, so it agrees
// with the row-block design within tolerance, not bit for bit. Sizing at
// B=100, H=512 (128 blocks of 25 rows): shared memory 191,872 bytes at
// float (the wh and wx columns 132,352, the tile's carries 1,600, a chunk
// buffer of 28 rows 57,792), 163,200 at bf16; the work scratch 947,200
// bytes (the exchanges 128,000, the stash 819,200, unused there); three
// grid barriers a step, 750 a call.
//
// Weight gradients cross every row, and blocks run in no fixed order, so
// they are NOT accumulated across blocks with atomics (whose order, and so
// whose rounding, would change from run to run). The recurrence writes
// d_pre [T, B, 4H] (float, unrounded) to a scratch the wrapper allocates,
// and a second pass (weight_grad.cuh) reduces
//   [dwx; dwh; db] = sum over (t, b) of [x_t; h_{t-1}; 1]^T d_pre_t
// (K = T*B terms) as a split-K tiled product in a fixed order, gathering
// its left operand from xs, hs and h0 in place. It rounds d_pre to W for
// the dwx/dwh rows and keeps it unrounded for db, so the one float scratch
// serves both. Per-row quantities need no cross-block
// reduction: dx_bias sums d_pre over time in registers (shared memory in
// the LSTM loop); the LN parameters' gradients are summed over time per
// row into a [B, 10H] partials scratch that a third kernel
// (sum_rows_kernel) adds up in row order. Every output is summed in a
// fixed order, with no atomics, so every result is the same,
// bit for bit, on every run. The weight gradients are written as float;
// the wrapper rounds them to W (the cotangent of a bf16 primal), as the
// JAX package's custom VJP does.
//
// Bound on the H100 at the training shapes (B=100, T=250; the encoder at
// H=256, the decoders at H=512, D=5): the recurrences' products are SIMT
// multiply-adds, outside the tensor cores: float 67 TFLOP/s. fused_lstm_seq
// fwd 13.4 GFLOP, bwd ~39.8; fused_lstm / fused_ln_lstm fwd 52.9, bwd
// ~158.9 GFLOP (including the weight-gradient products), i.e. 0.20 / 0.59 /
// 0.79 / 2.37 ms, above the time their bytes need at 3.35 TB/s -- bound by
// operations. With bf16 operands the same products could run on the tensor
// cores (989 TFLOP/s dense bf16), a bound 15x lower. What bounds each part
// of the LSTM backward: the recompute is a product of 2*T*B*H*4H FLOP
// (52.4 GFLOP at H=512) whose 205 MB float output takes 0.06 ms at HBM
// rate: bound by operations, 0.78 ms float (SIMT) and 0.05 ms bf16 (tensor
// cores). The loop's T steps are serial: each is a barrier plus a
// (B / tiles) x 16 x 4H product per block fed by L2 (the 26 MB above at
// H=512), so latency and L2 bandwidth bound it, not the FLOP count
// (52.4 GFLOP of SIMT work, 0.78 ms at peak). The weight pass is a
// product over K = T*B: bound by d_pre's bytes at bf16 (0.07 ms), by
// operations at float (0.78 ms); weight_grad.cuh has its design. The
// LSTM forward's T steps are serial too: each is a grid barrier, an L2 read of the tile's h rows (6.6 MB a step at H=512
// float) and a (B / tiles) x 16 x 4H product per block from resident
// weights, in SIMT multiply-adds so that the sums keep the row-block
// order; its shared-memory reads and their latency bound the product, not
// the FLOP count (PERF.md has the split of a step). The LN forward's step
// is the LSTM forward's plus two exchanges and two grid barriers, the LN
// backward's loop the LSTM loop's plus as many: latency bounds both too
// (the row-block LN forward, one block per row, re-read wh from L2 every
// step instead). PERF.md keeps the measured times beside these bounds.

#include <cooperative_groups.h>

#include "ln_lstm.cuh"
#include "ln_loop.cuh"
#include "lstm_loops.cuh"
#include "persist.cuh"
#include "recompute.cuh"
#include "rnn_common.cuh"
#include "weight_grad.cuh"

namespace {

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

template <bool LN, typename W, typename R>
cudaError_t launch_fwd(const Fwd<W, R>& a, cudaStream_t stream) {
  if (a.p.H < 1 || a.p.H > kMaxThreads) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.p.H + a.p.D) * sizeof(float);
  cudaError_t err = set_smem((const void*)rnn_fwd_kernel<LN, W, R>, smem);
  if (err != cudaSuccess) return err;
  rnn_fwd_kernel<LN, W, R><<<a.B, threads_for(a.p.H), smem, stream>>>(a);
  return cudaGetLastError();
}

// [dwx; dwh; db] from the d_pre scratch (weight_grad.cuh)
template <typename W, typename R>
cudaError_t launch_weight_grad(const Bwd<W, R>& a, int ones, float* dwx,
                               float* dwh, float* db, cudaStream_t stream) {
  const WgArgs<R> w = wg_lstm_args(a.xs, a.h0, a.hs, a.dpre, a.T, a.B,
                                   a.p.D, a.p.H, ones, a.wg, dwx, dwh, db);
  return launch_weight_grad_pass<W>(w, stream);
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
  return launch_weight_grad(a, ones, dwx, dwh, db, stream);
}

// ---------------------------------------------------------------------------
// The LSTM backward of srt_lstm_bwd: three launches (header, "Design").
// The loop (2) and the forward's loop are lstm_loops.cuh's, shared with
// lstm_seq.cu; this file holds the recompute (1) and the launches.

// 1. The hoisted gate recompute: the tiled products of recompute.cuh over
// the operand PreOp, pre = ((x @ wx [+ b]) + h_{t-1} @ wh) [+ x_bias] of
// every row-step into the d_pre scratch.
template <typename W, typename R>
cudaError_t launch_recompute(const Bwd<W, R>& a, cudaStream_t stream) {
  return launch_product<W>(PreOp<W, R>{a}, 1, stream);
}

// The three launches in order (stage 0), or one of them (1, 2 or 3); the
// loop's gate block reads the recomputed pre (GatesRecompute).
template <typename W, typename R>
cudaError_t launch_lstm_bwd(const Bwd<W, R>& a, int stage, float* dwx,
                            float* dwh, float* db, cudaStream_t stream) {
  if (a.p.H < 1 || a.p.H > kMaxThreads || stage < 0 || stage > 3)
    return cudaErrorInvalidValue;
  const bool loop = stage == 0 || stage == 2;
  LoopPlan plan;
  cudaError_t err = loop ? loop_plan<GatesRecompute>(a, plan) : cudaSuccess;
  if (err == cudaSuccess && (stage == 0 || stage == 1))
    err = launch_recompute(a, stream);
  if (err == cudaSuccess && loop)
    err = launch_loop(a, GatesRecompute{}, plan, stream);
  if (err == cudaSuccess && (stage == 0 || stage == 3))
    err = launch_weight_grad(a, 1, dwx, dwh, db, stream);
  return err;
}

// srt_lstm_fwd's arguments as a Fwd, launched by the cooperative loop or,
// with rowblock, by the row-block design (which needs no hx).
cudaError_t lstm_fwd_any(bool rowblock, const float* xs, const float* xb,
                         const void* wx, const float* b, const void* wh,
                         const float* c0, const float* h0,
                         const float* masks, const int* seed, int T, int B,
                         int D, int H, int w_bf16, int r_bf16, float keep,
                         float inv_keep, float forget_bias, void* hs,
                         void* cs, float* cT, float* hT, void* hx,
                         void* stream) {
  return with_types(w_bf16, r_bf16, [&](auto w, auto r) {
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
    const cudaStream_t st = (cudaStream_t)stream;
    if (rowblock) return launch_fwd<false>(a, st);
    return launch_lstm_fwd_loop(a, XProduct{}, static_cast<W*>(hx), st);
  });
}

// srt_lstm_bwd's arguments as a Bwd, and stage (0: the three launches,
// 1-3: one of them) or, for stage -1, the row-block design.
cudaError_t lstm_bwd_any(int stage, const float* xs, const float* xb,
                         const void* wx, const float* b, const void* wh,
                         const float* h0, const void* hs, const void* cs,
                         const void* dhs, const float* dcT, const float* dhT,
                         const float* masks, const int* seed, int T, int B,
                         int D, int H, int w_bf16, int r_bf16, float keep,
                         float inv_keep, float forget_bias, float* dpre,
                         float* dxs, float* dxb, float* dwx, float* db,
                         float* dwh, float* dc0, float* dh0, int wg_slices,
                         int wg_kslice, float* wg_part, void* stream) {
  return with_types(w_bf16, r_bf16, [&](auto w, auto r) {
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
    a.wg = {wg_slices, wg_kslice, wg_part};
    a.T = T;
    a.B = B;
    const cudaStream_t st = (cudaStream_t)stream;
    if (stage < 0) return launch_bwd<false>(a, 1, dwx, dwh, db, st);
    return launch_lstm_bwd(a, stage, dwx, dwh, db, st);
  });
}

// srt_ln_lstm_fwd's arguments as a Fwd, launched by the cooperative loop
// or, with rowblock, by the row-block design (which needs no hx and no
// work).
cudaError_t ln_lstm_fwd_any(bool rowblock, const float* xs, const float* xb,
                            const void* wx, const void* wh,
                            const float* ln_gamma, const float* ln_beta,
                            const float* lnc_gamma, const float* lnc_beta,
                            const float* c0, const float* h0,
                            const float* masks, const int* seed, int T, int B,
                            int D, int H, int w_bf16, int r_bf16, float keep,
                            float inv_keep, float forget_bias, void* hs,
                            void* cs, float* cT, float* hT, void* hx,
                            float* work, void* stream) {
  return with_types(w_bf16, r_bf16, [&](auto w, auto r) {
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
    const cudaStream_t st = (cudaStream_t)stream;
    if (rowblock) return launch_fwd<true>(a, st);
    return launch_ln_fwd_loop(a, static_cast<W*>(hx),
                              ln_fwd_work(work, B, H), st);
  });
}

// srt_ln_lstm_bwd's arguments as a Bwd, and stage (0: the four launches,
// 1-4: one of them) or, for stage -1, the row-block design.
cudaError_t ln_lstm_bwd_any(
    int stage, const float* xs, const float* xb, const void* wx,
    const void* wh, const float* ln_gamma, const float* ln_beta,
    const float* lnc_gamma, const float* lnc_beta, const float* h0,
    const void* hs, const void* cs, const void* dhs, const float* dcT,
    const float* dhT, const float* masks, const int* seed, int T, int B,
    int D, int H, int w_bf16, int r_bf16, float keep, float inv_keep,
    float forget_bias, float* dpre, float* part, float* work, float* dxs,
    float* dxb, float* dwx, float* dwh, float* dln, float* dc0, float* dh0,
    int wg_slices, int wg_kslice, float* wg_part, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return with_types(w_bf16, r_bf16, [&](auto w, auto r) {
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
    a.wg = {wg_slices, wg_kslice, wg_part};
    a.T = T;
    a.B = B;
    if (stage >= 0)
      return launch_ln_lstm_bwd(a, work, stage, dwx, dwh, dln, st);
    cudaError_t err = launch_bwd<true>(a, 0, dwx, dwh, nullptr, st);
    if (err != cudaSuccess) return err;
    sum_rows_kernel<<<(10 * H + 255) / 256, 256, 0, st>>>(part, B, 10 * H,
                                                          dln);
    return cudaGetLastError();
  });
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
// gradients are written as float32. The backward entries' wg_slices,
// wg_kslice and wg_part are the weight pass's split-K plan
// (cuda_fused.weight_grad_plan) and its float partials scratch, [wg_slices,
// D + H + ones, 4H] (weight_grad.cuh); a plan that does not cover T * B is
// cudaErrorInvalidValue. Each returns the cudaError_t of its launches (0
// when all were accepted).

// cT, hT: or null. hx: a [2, B, H] scratch of the weight type, the h
// exchange between the blocks. The cooperative loop, over windows of rows
// where the batch's tiles do not fit at once; a grid that cannot co-reside
// is cudaErrorCooperativeLaunchTooLarge, a shape whose rows do not fit even
// one at a time cudaErrorLaunchOutOfResources, both before any launch.
int srt_lstm_fwd(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* c0,
                 const float* h0, const float* masks, const int* seed, int T,
                 int B, int D, int H, int w_bf16, int r_bf16, float keep,
                 float inv_keep, float forget_bias, void* hs, void* cs,
                 float* cT, float* hT, void* hx, void* stream) {
  return (int)lstm_fwd_any(false, xs, xb, wx, b, wh, c0, h0, masks, seed, T,
                           B, D, H, w_bf16, r_bf16, keep, inv_keep,
                           forget_bias, hs, cs, cT, hT, hx, stream);
}

// The row-block design srt_lstm_fwd replaced (rnn_fwd_kernel<false>),
// kept to be held and timed beside it; hx is not used.
int srt_lstm_fwd_rowblock(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* c0,
                 const float* h0, const float* masks, const int* seed, int T,
                 int B, int D, int H, int w_bf16, int r_bf16, float keep,
                 float inv_keep, float forget_bias, void* hs, void* cs,
                 float* cT, float* hT, void* hx, void* stream) {
  return (int)lstm_fwd_any(true, xs, xb, wx, b, wh, c0, h0, masks, seed, T,
                           B, D, H, w_bf16, r_bf16, keep, inv_keep,
                           forget_bias, hs, cs, cT, hT, hx, stream);
}

// dcT, dhT, dxs, dxb, dc0, dh0: or null. The hoisted recompute, the
// cooperative loop (over windows of rows where the batch's tiles do not
// fit at once) and the weight pass; a grid that cannot co-reside is
// cudaErrorCooperativeLaunchTooLarge, before any launch.
int srt_lstm_bwd(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* h0,
                 const void* hs, const void* cs, const void* dhs,
                 const float* dcT, const float* dhT, const float* masks,
                 const int* seed, int T, int B, int D, int H, int w_bf16,
                 int r_bf16, float keep, float inv_keep, float forget_bias,
                 float* dpre, float* dxs, float* dxb, float* dwx, float* db,
                 float* dwh, float* dc0, float* dh0, int wg_slices,
                 int wg_kslice, float* wg_part, void* stream) {
  return (int)lstm_bwd_any(0, xs, xb, wx, b, wh, h0, hs, cs, dhs, dcT, dhT,
                           masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                           inv_keep, forget_bias, dpre, dxs, dxb, dwx, db,
                           dwh, dc0, dh0, wg_slices, wg_kslice, wg_part,
                           stream);
}

// One of srt_lstm_bwd's three launches (stage 1: recompute, 2: loop, 3:
// weight pass), on the same arguments, to time them apart.
int srt_lstm_bwd_stage(int stage, const float* xs, const float* xb,
                       const void* wx, const float* b, const void* wh, const float* h0,
                 const void* hs, const void* cs, const void* dhs,
                 const float* dcT, const float* dhT, const float* masks,
                 const int* seed, int T, int B, int D, int H, int w_bf16,
                 int r_bf16, float keep, float inv_keep, float forget_bias,
                 float* dpre, float* dxs, float* dxb, float* dwx, float* db,
                 float* dwh, float* dc0, float* dh0, int wg_slices,
                 int wg_kslice, float* wg_part, void* stream) {
  if (stage < 1 || stage > 3) return (int)cudaErrorInvalidValue;
  return (int)lstm_bwd_any(stage, xs, xb, wx, b, wh, h0, hs, cs, dhs, dcT, dhT,
                           masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                           inv_keep, forget_bias, dpre, dxs, dxb, dwx, db,
                           dwh, dc0, dh0, wg_slices, wg_kslice, wg_part,
                           stream);
}

// The row-block design srt_lstm_bwd replaced (rnn_bwd_kernel<false>, then
// the weight pass), kept to be held and timed beside it.
int srt_lstm_bwd_rowblock(const float* xs, const float* xb, const void* wx,
                 const float* b, const void* wh, const float* h0,
                 const void* hs, const void* cs, const void* dhs,
                 const float* dcT, const float* dhT, const float* masks,
                 const int* seed, int T, int B, int D, int H, int w_bf16,
                 int r_bf16, float keep, float inv_keep, float forget_bias,
                 float* dpre, float* dxs, float* dxb, float* dwx, float* db,
                 float* dwh, float* dc0, float* dh0, int wg_slices,
                 int wg_kslice, float* wg_part, void* stream) {
  return (int)lstm_bwd_any(-1, xs, xb, wx, b, wh, h0, hs, cs, dhs, dcT, dhT,
                           masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                           inv_keep, forget_bias, dpre, dxs, dxb, dwx, db,
                           dwh, dc0, dh0, wg_slices, wg_kslice, wg_part,
                           stream);
}

// hx: a [2, B, H] scratch of the weight type, the h exchange between the
// blocks; work: a float scratch of (ceil(H / 16) * 10 + 4 * H) * B floats
// (LnFwdWork). The cooperative loop; a grid that cannot co-reside is
// cudaErrorCooperativeLaunchTooLarge, a shape whose rows do not fit even
// one at a time cudaErrorLaunchOutOfResources, both before any launch.
int srt_ln_lstm_fwd(const float* xs, const float* xb, const void* wx,
                    const void* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* c0, const float* h0,
                    const float* masks, const int* seed, int T, int B, int D,
                    int H, int w_bf16, int r_bf16, float keep,
                    float inv_keep, float forget_bias, void* hs, void* cs,
                    float* cT, float* hT, void* hx, float* work,
                    void* stream) {
  return (int)ln_lstm_fwd_any(false, xs, xb, wx, wh, ln_gamma, ln_beta,
                              lnc_gamma, lnc_beta, c0, h0, masks, seed, T, B,
                              D, H, w_bf16, r_bf16, keep, inv_keep,
                              forget_bias, hs, cs, cT, hT, hx, work, stream);
}

// The row-block design srt_ln_lstm_fwd replaced (rnn_fwd_kernel<true>),
// kept to be held and timed beside it; hx and work are not used.
int srt_ln_lstm_fwd_rowblock(
    const float* xs, const float* xb, const void* wx, const void* wh,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* c0, const float* h0,
    const float* masks, const int* seed, int T, int B, int D, int H,
    int w_bf16, int r_bf16, float keep, float inv_keep, float forget_bias,
    void* hs, void* cs, float* cT, float* hT, void* hx, float* work,
    void* stream) {
  return (int)ln_lstm_fwd_any(true, xs, xb, wx, wh, ln_gamma, ln_beta,
                              lnc_gamma, lnc_beta, c0, h0, masks, seed, T, B,
                              D, H, w_bf16, r_bf16, keep, inv_keep,
                              forget_bias, hs, cs, cT, hT, hx, work, stream);
}

// work: a float scratch of (ceil(H / 16) * 10 + T * 10 + 4 * H) * B
// floats (LnWork).
// dcT, dhT, dxb: or null. The hoisted recompute, the statistics, the
// cooperative loop (over windows of rows where the batch's tiles do not
// fit at once) with the LN parameters' row sum, the weight pass; a grid
// that cannot co-reside is cudaErrorCooperativeLaunchTooLarge, before any
// launch.
int srt_ln_lstm_bwd(const float* xs, const float* xb, const void* wx,
                    const void* wh, const float* ln_gamma,
                    const float* ln_beta, const float* lnc_gamma,
                    const float* lnc_beta, const float* h0, const void* hs,
                    const void* cs, const void* dhs, const float* dcT,
                    const float* dhT, const float* masks, const int* seed,
                    int T, int B, int D, int H, int w_bf16, int r_bf16,
                    float keep, float inv_keep, float forget_bias,
                    float* dpre, float* part, float* work, float* dxs,
                    float* dxb, float* dwx, float* dwh, float* dln,
                    float* dc0, float* dh0, int wg_slices, int wg_kslice,
                    float* wg_part, void* stream) {
  return (int)ln_lstm_bwd_any(0, xs, xb, wx, wh, ln_gamma, ln_beta,
                              lnc_gamma, lnc_beta, h0, hs, cs, dhs, dcT, dhT,
                              masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                              inv_keep, forget_bias, dpre, part, work, dxs,
                              dxb, dwx, dwh, dln, dc0, dh0, wg_slices,
                              wg_kslice, wg_part, stream);
}

// One of srt_ln_lstm_bwd's launches (stage 1: recompute, 2: statistics,
// 3: loop and row sum, 4: weight pass), on the same arguments, to time
// them apart.
int srt_ln_lstm_bwd_stage(int stage, const float* xs, const float* xb,
                          const void* wx, const void* wh,
                          const float* ln_gamma, const float* ln_beta,
                          const float* lnc_gamma, const float* lnc_beta,
                          const float* h0, const void* hs, const void* cs,
                          const void* dhs, const float* dcT,
                          const float* dhT, const float* masks,
                          const int* seed, int T, int B, int D, int H,
                          int w_bf16, int r_bf16, float keep, float inv_keep,
                          float forget_bias, float* dpre, float* part,
                          float* work, float* dxs, float* dxb, float* dwx,
                          float* dwh, float* dln, float* dc0, float* dh0,
                          int wg_slices, int wg_kslice, float* wg_part,
                          void* stream) {
  if (stage < 1 || stage > 4) return (int)cudaErrorInvalidValue;
  return (int)ln_lstm_bwd_any(stage, xs, xb, wx, wh, ln_gamma, ln_beta,
                              lnc_gamma, lnc_beta, h0, hs, cs, dhs, dcT, dhT,
                              masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                              inv_keep, forget_bias, dpre, part, work, dxs,
                              dxb, dwx, dwh, dln, dc0, dh0, wg_slices,
                              wg_kslice, wg_part, stream);
}

// The row-block design srt_ln_lstm_bwd replaced (rnn_bwd_kernel<true>, the
// weight pass, the row sum), kept to be held and timed beside it; work is
// not used.
int srt_ln_lstm_bwd_rowblock(
    const float* xs, const float* xb, const void* wx, const void* wh,
    const float* ln_gamma, const float* ln_beta, const float* lnc_gamma,
    const float* lnc_beta, const float* h0, const void* hs, const void* cs,
    const void* dhs, const float* dcT, const float* dhT, const float* masks,
    const int* seed, int T, int B, int D, int H, int w_bf16, int r_bf16,
    float keep, float inv_keep, float forget_bias, float* dpre, float* part,
    float* work, float* dxs, float* dxb, float* dwx, float* dwh, float* dln,
    float* dc0, float* dh0, int wg_slices, int wg_kslice, float* wg_part,
    void* stream) {
  return (int)ln_lstm_bwd_any(-1, xs, xb, wx, wh, ln_gamma, ln_beta,
                              lnc_gamma, lnc_beta, h0, hs, cs, dhs, dcT, dhT,
                              masks, seed, T, B, D, H, w_bf16, r_bf16, keep,
                              inv_keep, forget_bias, dpre, part, work, dxs,
                              dxb, dwx, dwh, dln, dc0, dh0, wg_slices,
                              wg_kslice, wg_part, stream);
}

// The weight pass alone over a d_pre scratch a backward entry (or one of
// its stages) left: variant 0 the split-K pass every backward entry runs
// (wg_* its plan and scratch), 1 the pass it replaced
// (weight_grad_tiled_kernel, which ignores them), to hold and time them
// beside each other. hs is float32, or bfloat16 when r_bf16; xs and dwx
// may be null when D = 0, db when ones = 0.
int srt_weight_grad(int variant, const float* xs, const float* h0,
                    const void* hs, const float* dpre, int T, int B, int D,
                    int H, int ones, int w_bf16, int r_bf16, int wg_slices,
                    int wg_kslice, float* wg_part, float* dwx, float* dwh,
                    float* db, void* stream) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_types(w_bf16, r_bf16, [&](auto w, auto r) {
    using W = decltype(w);
    using R = decltype(r);
    const WgArgs<R> a = wg_lstm_args(
        xs, h0, static_cast<const R*>(hs), dpre, T, B, D, H, ones,
        WgPlan{wg_slices, wg_kslice, wg_part}, dwx, dwh, db);
    return variant == 0 ? launch_weight_grad_pass<W>(a, st)
                        : launch_weight_grad_tiled<W>(a, st);
  });
}

}  // extern "C"
