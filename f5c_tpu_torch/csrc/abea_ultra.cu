// ABEA for ultra-long reads on Hopper (sm_90a): the band fill over a
// window of bands with carried state, and the backtrace walk across one
// window.
//
// abea_fill_window_kernel replaces the TPU kernel
// f5c_tpu/ops/abea_ultra.py:_fill_kernel_win (launched by fill_window;
// K3); abea_walk_window_kernel replaces its XLA walk walk_window (K10).
// The plain PyTorch versions, the state record and the function that pairs
// them are f5c_tpu_torch/ops/abea_ultra.py.  Algorithm reference:
// align.c:180-559.
//
// Why the path exists: the unchunked fill (abea.cu) stores one trace byte
// per band cell, n_bands x 128 bytes per read -- ~110 MB for a 300 kb
// read.  Here a read's trace is rebuilt one window of WIN bands at a time
// (O(WIN) memory), at the cost of a second fill.
//
// abea_fill_window_kernel: one block per read (a ragged grid over the
// batch's ultra reads), 128 threads, three band rows in shared memory,
// and the band step of abea_band.cuh -- the very code of the unchunked
// fill, so the two are bit-identical.  A block loads its read's state
// record (ST_WORDS f32, ~1 KB), runs n_win windows of WIN bands from band
// `base` and writes the state it reaches at the end of every window.  The
// forward pass is one launch over the whole read with no trace (it writes
// the checkpoint of every window and, in the last one, the backtrace
// start); the backward pass re-fills one window from its checkpoint with
// the trace on.  Bands at or past the read's end are not run: the state
// stays, and the trace rows there are 0.
// What bounds it: as for the unchunked fill, the band recurrence -- each
// band needs the previous band's edge cells, so a read is a chain of
// dependent steps of a few global loads and one barrier: latency.  An
// ultra batch holds few reads, so few SMs are busy; the design keeps the
// chain inside one launch (no host round trip per window) and leaves the
// rest to later work (prefetching the next k-mers/events).
//
// abea_walk_window_kernel: one thread per read walks down one window from
// its carried (k, e, n) while e + k + 2 >= base, the cond of walk_window,
// and writes its 2-bit directions straight into the read's output at bit
// offset 2n.  A window's walk rarely ends on a multiple of 4 steps: the
// next window's walk starts by loading that partial byte and ORs on.
// What bounds it: each step's two dependent loads (the band's ll_k, then
// the trace byte), serial per read.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "abea_band.cuh"

namespace {

using namespace f5c_abea;

__global__ void __launch_bounds__(PAD) abea_fill_window_kernel(
    const float* __restrict__ ev_pool, const int64_t* __restrict__ ev_off,
    const int32_t* __restrict__ ev_len, const int32_t* __restrict__ rk_pool,
    const int64_t* __restrict__ rk_off, const int32_t* __restrict__ rk_len,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ level_log_stdv, int n_model,
    const float* __restrict__ params, const int64_t* __restrict__ band_off,
    const float* __restrict__ state_in, int base, int win, int n_win,
    float* __restrict__ state_out, uint8_t* __restrict__ trace,
    int32_t* __restrict__ llk_out) {
  __shared__ float rows[3][PAD];
  const int i = blockIdx.x;
  const int o = threadIdx.x;
  const ReadIn rd = read_in(i, ev_pool, ev_off, ev_len, rk_pool, rk_off,
                            rk_len, params);
  const Model m{level_mean, level_stdv, level_log_stdv, n_model};
  const int nb = static_cast<int>(band_off[i + 1] - band_off[i]);
  const int64_t span = static_cast<int64_t>(n_win) * win;
  uint8_t* tr = trace ? trace + i * span * PAD : nullptr;
  int32_t* llk = llk_out ? llk_out + i * span : nullptr;

  const float* st = state_in + static_cast<int64_t>(i) * ST_WORDS;
  rows[(base - 1) % 3][o] = st[ST_PREV + o];
  rows[(base - 2) % 3][o] = st[ST_PREV2 + o];
  BandState s;
  s.ll_k = __float_as_int(st[ST_LLK]);
  s.k2 = __float_as_int(st[ST_K2]);
  s.ll_e = base - 3 - s.ll_k;
  s.best_e = __float_as_int(st[ST_BEST_E]);
  s.best_s = st[ST_BEST_S];
  __syncthreads();

  int next = base;  // the next band to run
  for (int j = 0; j < n_win; ++j) {
    const int lo = base + j * win;
    const int hi = lo + win;
    const int stop = hi < nb ? hi : nb;
    for (; next < stop; ++next) {
      const int frm = band_step(rows, next, o, rd, m, s);
      if (tr) {
        const int64_t b = next - base;
        tr[b * PAD + o] = static_cast<uint8_t>(frm);
        if (o == 0) llk[b] = s.ll_k;
      }
    }
    if (tr) {
      for (int b = (lo > nb ? lo : nb); b < hi; ++b) {
        tr[static_cast<int64_t>(b - base) * PAD + o] = 0;
        if (o == 0) llk[b - base] = 0;
      }
    }
    float* so = state_out + (static_cast<int64_t>(i) * n_win + j) * ST_WORDS;
    so[ST_PREV + o] = rows[(next - 1) % 3][o];
    so[ST_PREV2 + o] = rows[(next - 2) % 3][o];
    if (o == 0) {
      so[ST_LLK] = __int_as_float(s.ll_k);
      so[ST_K2] = __int_as_float(s.k2);
      so[ST_BEST_E] = __int_as_float(s.best_e);
      so[ST_BEST_S] = s.best_s;
    }
  }
}

__global__ void abea_walk_window_kernel(
    const uint8_t* __restrict__ trace, const int32_t* __restrict__ llk_all,
    int base, int win, int32_t* __restrict__ kst,
    const int64_t* __restrict__ byte_off, uint8_t* __restrict__ out,
    int n_reads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_reads) return;
  const uint8_t* tr = trace + static_cast<int64_t>(i) * win * PAD;
  const int32_t* llk = llk_all + static_cast<int64_t>(i) * win;
  uint8_t* dst = out + byte_off[i];
  const int64_t cap = byte_off[i + 1] - byte_off[i];
  int k = kst[3 * i], e = kst[3 * i + 1], n = kst[3 * i + 2];
  // the byte the previous window's walk left partly written
  unsigned acc = ((n & 3) != 0 && (n >> 2) < cap) ? dst[n >> 2] : 0u;
  while (k >= 0 && e >= 0 && e + k + 2 >= base) {
    int b = e + k + 2 - base;
    b = b >= win ? win - 1 : b;
    int o = k - llk[b];
    o = o < 0 ? 0 : (o >= PAD ? PAD - 1 : o);
    const int f = tr[static_cast<int64_t>(b) * PAD + o];
    acc |= static_cast<unsigned>(f) << (2 * (n & 3));
    if ((n & 3) == 3) {
      if ((n >> 2) < cap) dst[n >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
    k -= (f != FROM_U);
    e -= (f != FROM_L);
    ++n;
  }
  if ((n & 3) != 0 && (n >> 2) < cap) dst[n >> 2] = static_cast<uint8_t>(acc);
  kst[3 * i] = k;
  kst[3 * i + 1] = e;
  kst[3 * i + 2] = n;
}

}  // namespace

extern "C" {

// Launches the windowed fill on `stream`; allocates nothing; returns
// cudaGetLastError() after the launch.  `trace` and `llk` may be null
// (no trace: the forward pass).
int f5c_abea_fill_window(
    const void* ev_pool, const void* ev_off, const void* ev_len,
    const void* rk_pool, const void* rk_off, const void* rk_len,
    const void* level_mean, const void* level_stdv,
    const void* level_log_stdv, const void* params, const void* band_off,
    const void* state_in, void* state_out, void* trace, void* llk,
    int n_model, int n_reads, int base, int win, int n_win, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n_reads > 0) {
    abea_fill_window_kernel<<<n_reads, PAD, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ev_pool),
        static_cast<const int64_t*>(ev_off),
        static_cast<const int32_t*>(ev_len),
        static_cast<const int32_t*>(rk_pool),
        static_cast<const int64_t*>(rk_off),
        static_cast<const int32_t*>(rk_len),
        static_cast<const float*>(level_mean),
        static_cast<const float*>(level_stdv),
        static_cast<const float*>(level_log_stdv), n_model,
        static_cast<const float*>(params),
        static_cast<const int64_t*>(band_off),
        static_cast<const float*>(state_in), base, win, n_win,
        static_cast<float*>(state_out), static_cast<uint8_t*>(trace),
        static_cast<int32_t*>(llk));
  }
  return static_cast<int>(cudaGetLastError());
}

// Walks one window for every read, updating `kst` (k, e, n per read) and
// `out` in place.
int f5c_abea_walk_window(const void* trace, const void* llk, void* kst,
                         const void* byte_off, void* out, int base, int win,
                         int n_reads, void* stream) {
  cudaGetLastError();
  if (n_reads > 0) {
    const int threads = 128;
    abea_walk_window_kernel<<<(n_reads + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(trace),
        static_cast<const int32_t*>(llk), base, win,
        static_cast<int32_t*>(kst), static_cast<const int64_t*>(byte_off),
        static_cast<uint8_t*>(out), n_reads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
