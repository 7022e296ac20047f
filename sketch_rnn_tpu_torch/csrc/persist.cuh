// The host helpers of the PyTorch port's persistent cooperative loops
// (the LSTM's two in lstm_loops.cuh, the LayerNorm-LSTM's two in
// ln_lstm.cuh, probe_seq.cu's probe loop): the card's
// limits, windows of rows for a batch whose tiles do not fit in one
// launch, and the checks made before any cooperative launch. Everything
// sits in an unnamed namespace: each translation unit gets its own copy.

#pragma once

#include <stddef.h>

#include "rnn_common.cuh"

namespace {

// The card's SM count and its opt-in shared memory per block.
cudaError_t device_limits(int& sms, int& smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Windows of rows (fused_rnn.cu's header, "Row windows"): a persistent
// loop holds its batch tile's state in one block's shared memory, and no
// row of its recurrence reads another, so a batch whose tiles do not fit
// runs as nwin cooperative launches, window w over the rows [w * B / nwin,
// (w + 1) * B / nwin) (rows differ by one at most between windows). nwin
// is the least whose windows fit: smem_for(rows) is the shared memory of a
// window's grid, SIZE_MAX where none forms; smem the largest of them. 0
// when not even one row fits. One window where the batch fits: the launch
// it always was.
struct Windows {
  int n = 0;
  size_t smem = 0;
  int first(int w, int B) const { return (int)((long long)w * B / n); }
  int rows(int w, int B) const { return first(w + 1, B) - first(w, B); }
  int most(int B) const { return n > 0 ? (B + n - 1) / n : 1; }
};

template <typename F>
Windows plan_windows(int B, size_t smem_max, F&& smem_for) {
  Windows win;
  for (int n = 1; n <= B; ++n) {
    const int hi = (B + n - 1) / n, lo = B / n;
    size_t s = smem_for(hi);
    if (lo > 0 && lo != hi) {
      const size_t t = smem_for(lo);
      if (t > s) s = t;
    }
    if (s <= smem_max) {
      win.n = n;
      win.smem = s;
      return win;
    }
  }
  return win;
}

// n windows of B rows, sized as plan_windows sizes them, for the LayerNorm
// ladder's grid-scaling runs (probe_ln.cu); no windows (n = 0) where they
// do not fit in smem_max or n is not in [1, B].
template <typename F>
Windows forced_windows(int B, int n, size_t smem_max, F&& smem_for) {
  Windows win;
  if (n < 1 || n > B) return win;
  const int hi = (B + n - 1) / n, lo = B / n;
  size_t s = smem_for(hi);
  if (lo > 0 && lo != hi) {
    const size_t t = smem_for(lo);
    if (t > s) s = t;
  }
  if (s <= smem_max) {
    win.n = n;
    win.smem = s;
  }
  return win;
}

// The shared memory attribute, then the co-residency of a window's grid,
// checked before anything is launched: an error, never a fallback
// (cudaErrorLaunchOutOfResources where no window fits, checked before any
// call that would leave an error behind for the next launch to report;
// cudaErrorCooperativeLaunchTooLarge where the blocks cannot co-reside).
cudaError_t ready_loop(const void* fn, int threads, const Windows& win,
                       int blocks, int sms) {
  if (win.n == 0) return cudaErrorLaunchOutOfResources;
  int occ = 0;
  cudaError_t err = set_smem(fn, win.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads,
                                                        win.smem);
  if (err != cudaSuccess) return err;
  if ((long)occ * sms < (long)blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace
