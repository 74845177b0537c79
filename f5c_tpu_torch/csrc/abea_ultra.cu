// ABEA for ultra-long reads on Hopper (sm_90a): the band fill over a
// window of bands with carried state, and the backtrace walk across one
// window.
//
// abea_fill_window_kernel replaces the TPU kernel
// f5c_tpu/ops/abea_ultra.py:_fill_kernel_win (launched by fill_window;
// K3), with the k-mer ranks of the packed sequences (K11) fused in as in
// the unchunked fill; its XLA walk walk_window (K10) is replaced by the
// tiled walk of abea_walk_tiled.cu (abea_walk_window_kernel below was
// K10's first port).
// The plain PyTorch versions, the state record and the function that pairs
// them are f5c_tpu_torch/ops/abea_ultra.py.  Algorithm reference:
// align.c:180-559.
//
// Why the path exists: the unchunked fill (abea.cu) keeps a read's whole
// trace, 2 bits a band cell: n_bands x (32 + 4) bytes with the band's
// lower-left k-mer -- ~29 MB for a 300 kb read of ~811,000 bands, and
// without bound as reads grow.  Here a read's trace is rebuilt one window
// of WIN bands at a time (O(WIN) memory), at the cost of a second fill;
// the runner sends a read here only past its share of the trace budget
// (~868,000 bands, a ~320 kb read, at the defaults).
//
// abea_fill_window_kernel: one block per read (a ragged grid over the
// batch's ultra reads), 128 threads, three band rows in shared memory,
// and the band step, input staging, batched trace stores and best-start
// reduction of abea_band.cuh -- the very code of the unchunked fill, so
// the two are bit-identical.  A block loads its read's state record
// (ST_WORDS f32, ~1 KB), stages the inputs of its first tile from the
// record's lower-left corner, runs n_win windows of WIN bands from band
// `base` and writes the state it reaches at the end of every window.  The
// forward pass is one launch over the whole read with no trace (it writes
// the checkpoint of every window and, in the last one, the backtrace
// start); the backward pass re-fills one window from its checkpoint with
// the trace on.  Bands at or past the read's end are not run: the state
// stays, and the trace rows there are 0.  The trace rows are written as
// abea.cu's (TraceBatch).
// What bounds it: as for the unchunked fill, the band recurrence -- each
// band needs the previous band's edge cells, so a read is a chain of
// dependent steps: latency, each step each warp's issue and one barrier
// (~110 ns a band on an H100 without the trace, ~165 with it; PERF.md).
// An ultra batch holds few reads, so few SMs are busy; the design keeps
// the chain inside one launch (no host round trip per window), the step
// on shared memory and its division off __fdiv_rn's slow path where the
// staged inputs allow (f5c_abea_fill_window_routed reports the route).
//
// abea_walk_window_kernel (a yardstick since the windowed path walks each
// window with the tiled walk of abea_walk_tiled.cu, which replaces K10;
// held and timed beside it): one warp per read walks down one window from
// its carried (k, e, n) while e + k + 2 >= base, the cond of walk_window,
// and writes its 2-bit directions straight into the read's output at bit
// offset 2n -- abea_walk.cuh's walk, shared with the unchunked walk.  A
// window's walk rarely ends on a multiple of 4 steps: the next window's
// walk starts by loading that partial byte and ORs on.
// What bounds it: each step's dependent load of the trace row's 8 bytes
// that hold its cell (the band's ll_k is loaded a step ahead), from the
// staged tiles in shared memory; serial per read.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "abea_band.cuh"
#include "abea_walk.cuh"

namespace {

using namespace f5c_abea;

// kTrace: the backward pass's re-fill, which writes the trace and llk; the
// forward pass is the instance without (no branch around the ballots).
template <bool kTrace>
__global__ void __launch_bounds__(PAD) abea_fill_window_kernel(
    const float* __restrict__ ev_pool, const int64_t* __restrict__ ev_off,
    const int32_t* __restrict__ ev_len, const uint8_t* __restrict__ seq,
    const int64_t* __restrict__ seq_off, const int32_t* __restrict__ rk_len,
    int kmer, const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ level_log_stdv, int n_model,
    const float* __restrict__ params, const int64_t* __restrict__ band_off,
    const float* __restrict__ state_in, int base, int win, int n_win,
    float* __restrict__ state_out, uint8_t* __restrict__ trace,
    int32_t* __restrict__ llk_out, int32_t* __restrict__ guarded) {
  __shared__ float rows[3][ROW];
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = blockIdx.x;
  const int o = threadIdx.x;
  const ReadIn rd = read_in(i, ev_pool, ev_off, ev_len, seq, seq_off,
                            rk_len, kmer, params);
  const Model m{level_mean, level_stdv, level_log_stdv, n_model};
  const int nb = static_cast<int>(band_off[i + 1] - band_off[i]);
  const int64_t span = static_cast<int64_t>(n_win) * win;
  uint8_t* tr = kTrace ? trace + i * span * TRACE_ROW : nullptr;
  int32_t* llk = kTrace ? llk_out + i * span : nullptr;

  const float* st_in = state_in + static_cast<int64_t>(i) * ST_WORDS;
  rows[(base - 1) % 3][o + 1] = st_in[ST_PREV + o];
  rows[(base - 2) % 3][o + 1] = st_in[ST_PREV2 + o];
  guard_rows(rows, o);
  BandState s;
  s.ll_k = __float_as_int(st_in[ST_LLK]);
  s.k2 = __float_as_int(st_in[ST_K2]);
  s.ll_e = base - 3 - s.ll_k;
  s.best_e = __float_as_int(st_in[ST_BEST_E]);
  s.best_s = st_in[ST_BEST_S];
  Cand c{-CUDART_INF_F, 0x7fffffff, -1};
  Stage st;
  st.bind(smem);
  st.init(o, s.ll_k, s.ll_e, rd, m);  // ends with a barrier

  int next = base, left = 0;  // the next band to run; bands to a new tile
  TraceBatch tb;              // its bands counted from base
  tb.lo = 0;
  for (int j = 0; j < n_win; ++j) {
    const int lo = base + j * win;
    const int hi = lo + win;
    run_bands(rows, next, hi < nb ? hi : nb, o, rd, m, st, s, c, left,
              [&](int b, int frm) {
                if (kTrace) {
                  tb.put(o, b - base, frm, s.ll_k);
                  if (((b - base) & 31) == 31)
                    tb.flush(tr, llk, o, b - base);
                }
              });
    if (kTrace && next - 1 - base >= tb.lo)
      tb.flush(tr, llk, o, next - 1 - base);
    const int z0 = lo > nb ? lo : nb;  // the bands past the read's end
    if (kTrace && z0 < hi) {            // get zero rows
      uint4* zr = reinterpret_cast<uint4*>(
          tr + static_cast<int64_t>(z0 - base) * TRACE_ROW);
      const int64_t n16 =
          static_cast<int64_t>(hi - z0) * (TRACE_ROW / 16);
      for (int64_t q = o; q < n16; q += PAD) zr[q] = make_uint4(0, 0, 0, 0);
      for (int b = z0 + o; b < hi; b += PAD) llk[b - base] = 0;
    }
    reduce_best(o, st, s, c);
    float* so = state_out + (static_cast<int64_t>(i) * n_win + j) * ST_WORDS;
    so[ST_PREV + o] = rows[(next - 1) % 3][o + 1];
    so[ST_PREV2 + o] = rows[(next - 2) % 3][o + 1];
    if (o == 0) {
      so[ST_LLK] = __int_as_float(s.ll_k);
      so[ST_K2] = __int_as_float(s.k2);
      so[ST_BEST_E] = __int_as_float(s.best_e);
      so[ST_BEST_S] = s.best_s;
    }
  }
  if (guarded && o == 0) guarded[i] = st.fast ? 0 : 1;
}

__global__ void __launch_bounds__(32) abea_walk_window_kernel(
    const uint8_t* __restrict__ trace, const int32_t* __restrict__ llk_all,
    int base, int win, int32_t* __restrict__ kst,
    const int64_t* __restrict__ byte_off, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  int k = kst[3 * i], e = kst[3 * i + 1], n = kst[3 * i + 2];
  walk_tiles(trace + static_cast<int64_t>(i) * win * TRACE_ROW,
             llk_all + static_cast<int64_t>(i) * win, win, base, k, e, n,
             out + byte_off[i], byte_off[i + 1] - byte_off[i], smem, lane);
  if (lane == 0) {
    kst[3 * i] = k;
    kst[3 * i + 1] = e;
    kst[3 * i + 2] = n;
  }
}

}  // namespace

extern "C" {

int f5c_abea_fill_window_routed(const void*, const void*, const void*,
                                const void*, const void*, const void*,
                                const void*, const void*, const void*,
                                const void*, const void*, const void*, void*,
                                void*, void*, void*, int, int, int, int, int,
                                int, int, void*);

// Launches the windowed fill on `stream`; allocates nothing; returns
// cudaGetLastError() after the launch.  `trace` and `llk` are both null
// (no trace: the forward pass) or both set.  `smem_bytes` is the block's
// dynamic shared memory as the wrapper sizes it (ops/abea.py
// fill_smem_bytes, walk_smem_bytes); a size other than the kernel's
// layout is refused.
// `seq`, `seq_off` and `kmer` as for f5c_abea_fill (abea.cu); like it,
// without the route report.
int f5c_abea_fill_window(
    const void* ev_pool, const void* ev_off, const void* ev_len,
    const void* seq, const void* seq_off, const void* rk_len,
    const void* level_mean, const void* level_stdv,
    const void* level_log_stdv, const void* params, const void* band_off,
    const void* state_in, void* state_out, void* trace, void* llk,
    int kmer, int n_model, int n_reads, int base, int win, int n_win,
    int smem_bytes, void* stream) {
  return f5c_abea_fill_window_routed(
      ev_pool, ev_off, ev_len, seq, seq_off, rk_len, level_mean, level_stdv,
      level_log_stdv, params, band_off, state_in, state_out, trace, llk,
      nullptr, kmer, n_model, n_reads, base, win, n_win, smem_bytes, stream);
}

// f5c_abea_fill_window that also writes, for each read, whether its bands
// took __fdiv_rn (1) or the fast quotient (0) into `guarded` (i32
// [n_reads]), as f5c_abea_fill_routed does.
int f5c_abea_fill_window_routed(
    const void* ev_pool, const void* ev_off, const void* ev_len,
    const void* seq, const void* seq_off, const void* rk_len,
    const void* level_mean, const void* level_stdv,
    const void* level_log_stdv, const void* params, const void* band_off,
    const void* state_in, void* state_out, void* trace, void* llk,
    void* guarded, int kmer, int n_model, int n_reads, int base, int win,
    int n_win, int smem_bytes, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (smem_bytes != FILL_SMEM || kmer < 1 || kmer > 15 ||
      (trace == nullptr) != (llk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_reads > 0) {
    auto kernel = trace ? abea_fill_window_kernel<true>
                        : abea_fill_window_kernel<false>;
    kernel<<<n_reads, PAD, smem_bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ev_pool),
        static_cast<const int64_t*>(ev_off),
        static_cast<const int32_t*>(ev_len),
        static_cast<const uint8_t*>(seq),
        static_cast<const int64_t*>(seq_off),
        static_cast<const int32_t*>(rk_len), kmer,
        static_cast<const float*>(level_mean),
        static_cast<const float*>(level_stdv),
        static_cast<const float*>(level_log_stdv), n_model,
        static_cast<const float*>(params),
        static_cast<const int64_t*>(band_off),
        static_cast<const float*>(state_in), base, win, n_win,
        static_cast<float*>(state_out), static_cast<uint8_t*>(trace),
        static_cast<int32_t*>(llk), static_cast<int32_t*>(guarded));
  }
  return static_cast<int>(cudaGetLastError());
}

// Walks one window for every read, updating `kst` (k, e, n per read) and
// `out` in place.
int f5c_abea_walk_window(const void* trace, const void* llk, void* kst,
                         const void* byte_off, void* out, int base, int win,
                         int n_reads, int smem_bytes, void* stream) {
  cudaGetLastError();
  if (smem_bytes != WALK_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (n_reads > 0) {
    abea_walk_window_kernel<<<n_reads, 32, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(trace),
        static_cast<const int32_t*>(llk), base, win,
        static_cast<int32_t*>(kst), static_cast<const int64_t*>(byte_off),
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
