// Event detection for Hopper (sm_90a).
//
// Replaces the JAX device op f5c_tpu/ops/events_device.py:
// detect_events_device (K9; its t-stat tracks _tstat, its peak scan
// _peak_scan, its host wrapper detect_events_batch).  The arithmetic is
// the port's host detector, f5c_tpu_torch/native/src/f5chost.cpp
// (tstat_at, compute_tstat_pair, peak_detector, f5c_detect_events,
// f5c_events_from_peaks; events.c:222-513), operation for operation in f64
// and f32 with correctly rounded intrinsics: the JAX op's two-float
// arithmetic existed only because the TPU has no f64.  The plain PyTorch
// version and the ragged layout are f5c_tpu_torch/ops/events_device.py.
//
// events_sums_kernel, one block of 256 threads per read (a ragged grid
// over the signal slab; no read is padded):
//   1. exclusive prefix sums of the samples and of their f32 squares in
//      f64, by tiles of 2,048 samples: each thread sums 8 samples, a block
//      scan adds the thread totals, a carry joins the tiles.  The host sums
//      in sample order; a scan in another order gives the same bits
//      exactly when no partial sum rounds, which holds for real signals
//      (events_device.py in the JAX package) but not for every input.  So
//      the block then checks the defining recurrence, S[i+1] ==
//      S[i] + x_i, at every sample, and where it fails (the first such
//      sample, every earlier S being right by induction) one thread redoes
//      the sums from there in sample order: the result is the host's bit
//      for bit on any input;
//   2. the two t-stat tracks, element-wise.
// events_peaks_kernel, one warp per read: the two coupled peak detectors,
// a sequential state machine over the samples, run by lane 0 over tiles
// of both tracks that the warp stages into a double-buffered ring in
// shared memory with cp.async (the pattern of abea_walk.cuh); it writes
// the event bounds (0, the peaks in emission order, n) and the event
// count.  A read has at most n + 1 events, the bound the host detector
// sizes its buffers to, so no read can overflow its slot.
// events_assemble_kernel, one block per read: start, length, mean and
// stdv of every event, at the read's offset in the compact output (the
// wrapper reads the counts back to size it).
//
// What bounds it: the peak scan, a chain of dependent steps over every
// sample of the longest read, on one thread (the host detector's own
// limit); the sums and tracks stream each sample's 28 bytes of scratch at
// the card's bandwidth, in parallel across reads.  Reads run side by side,
// one block or warp each.

#include <cfloat>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int SUM_THREADS = 256;
constexpr int SUM_ITEMS = 8;
constexpr int SUM_TILE = SUM_THREADS * SUM_ITEMS;
constexpr int PEAK_TILE = 1024;  // samples of each track per staged tile

struct Params {
  int w1, w2;
  float th1, th2, ph;
};

__device__ __forceinline__ Params params(int rna) {
  return rna ? Params{7, 14, 2.5f, 9.0f, 1.0f}
             : Params{3, 6, 1.4f, 9.0f, 0.2f};
}

// f5chost.cpp tstat_at: the f32/f64 mixing of events.c:324-373
__device__ __forceinline__ float tstat_at(const double* S, const double* Q,
                                          int64_t i, int w) {
  const float wf = static_cast<float>(w);
  const double wd = static_cast<double>(wf);
  const double sum1 = __dsub_rn(S[i], S[i - w]);
  const double sumsq1 = __dsub_rn(Q[i], Q[i - w]);
  const float sum2 = __double2float_rn(__dsub_rn(S[i + w], S[i]));
  const float sumsq2 = __double2float_rn(__dsub_rn(Q[i + w], Q[i]));
  const float mean1 = __double2float_rn(__ddiv_rn(sum1, wd));
  const float mean2 = __fdiv_rn(sum2, wf);
  double cv = __dsub_rn(__ddiv_rn(sumsq1, wd),
                        static_cast<double>(__fmul_rn(mean1, mean1)));
  cv = __dadd_rn(cv, static_cast<double>(__fdiv_rn(sumsq2, wf)));
  cv = __dsub_rn(cv, static_cast<double>(__fmul_rn(mean2, mean2)));
  float combined_var = __double2float_rn(cv);
  combined_var = combined_var < FLT_MIN ? FLT_MIN : combined_var;
  const float delta = __fsub_rn(mean2, mean1);
  const float sq = __fsqrt_rn(__fdiv_rn(combined_var, wf));
  const double t = __ddiv_rn(fabs(static_cast<double>(delta)),
                             static_cast<double>(sq));
  return __double2float_rn(t);
}

// compute_tstat: zero outside [w, n - w), and everywhere when n < 2w
__device__ __forceinline__ float track(const double* S, const double* Q,
                                       int64_t i, int64_t n, int w) {
  if (n < 2 * static_cast<int64_t>(w) || i < w || i >= n - w) return 0.0f;
  return tstat_at(S, Q, i, w);
}

__device__ __forceinline__ double sq_of(float v) {
  return static_cast<double>(__fmul_rn(v, v));  // an f32 square
}

__global__ void __launch_bounds__(SUM_THREADS) events_sums_kernel(
    const float* __restrict__ pa_pool, const int64_t* __restrict__ sig_off,
    double* __restrict__ S_all, double* __restrict__ Q_all,
    float* __restrict__ T1_all, float* __restrict__ T2_all, int rna,
    int32_t* __restrict__ fixed) {
  __shared__ double wtot[2][SUM_THREADS / 32];
  __shared__ double carry[2];
  __shared__ unsigned long long first_bad;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t s0 = sig_off[b];
  const int64_t n = sig_off[b + 1] - s0;
  const float* x = pa_pool + s0;
  double* S = S_all + s0 + b;  // n + 1 entries a read
  double* Q = Q_all + s0 + b;
  if (tid == 0) {
    S[0] = 0.0;
    Q[0] = 0.0;
    carry[0] = 0.0;
    carry[1] = 0.0;
    first_bad = static_cast<unsigned long long>(n);
  }
  __syncthreads();

  // 1. prefix sums by tiles
  for (int64_t t0 = 0; t0 < n; t0 += SUM_TILE) {
    const int64_t base = t0 + static_cast<int64_t>(tid) * SUM_ITEMS;
    double ls[SUM_ITEMS], lq[SUM_ITEMS];
    double a = 0.0, q = 0.0;
#pragma unroll
    for (int j = 0; j < SUM_ITEMS; ++j) {
      const float v = base + j < n ? x[base + j] : 0.0f;
      a = __dadd_rn(a, static_cast<double>(v));
      q = __dadd_rn(q, sq_of(v));
      ls[j] = a;
      lq[j] = q;
    }
    double ia = a, iq = q;  // inclusive scan of the thread totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double ta = __shfl_up_sync(0xffffffffu, ia, off);
      const double tq = __shfl_up_sync(0xffffffffu, iq, off);
      if (lane >= off) {
        ia = __dadd_rn(ta, ia);
        iq = __dadd_rn(tq, iq);
      }
    }
    if (lane == 31) {
      wtot[0][warp] = ia;
      wtot[1][warp] = iq;
    }
    double ea = __shfl_up_sync(0xffffffffu, ia, 1);
    double eq = __shfl_up_sync(0xffffffffu, iq, 1);
    if (lane == 0) {
      ea = 0.0;
      eq = 0.0;
    }
    __syncthreads();
    double pa = carry[0], pq = carry[1];
    for (int w = 0; w < warp; ++w) {
      pa = __dadd_rn(pa, wtot[0][w]);
      pq = __dadd_rn(pq, wtot[1][w]);
    }
    pa = __dadd_rn(pa, ea);
    pq = __dadd_rn(pq, eq);
    double last_a = 0.0, last_q = 0.0;
#pragma unroll
    for (int j = 0; j < SUM_ITEMS; ++j) {
      last_a = __dadd_rn(pa, ls[j]);
      last_q = __dadd_rn(pq, lq[j]);
      if (base + j < n) {
        S[base + j + 1] = last_a;
        Q[base + j + 1] = last_q;
      }
    }
    __syncthreads();  // every thread has read carry and wtot
    if (tid == SUM_THREADS - 1) {
      carry[0] = last_a;
      carry[1] = last_q;
    }
  }
  __syncthreads();

  // the recurrence check, then the sequential sums from its first failure
  for (int64_t i = tid; i < n; i += SUM_THREADS) {
    const float v = x[i];
    if (__dadd_rn(S[i], static_cast<double>(v)) != S[i + 1] ||
        __dadd_rn(Q[i], sq_of(v)) != Q[i + 1])
      atomicMin(&first_bad, static_cast<unsigned long long>(i));
  }
  __syncthreads();
  const int64_t bad = static_cast<int64_t>(first_bad);
  if (bad < n && tid == 0) {
    double a = S[bad], q = Q[bad];
    for (int64_t i = bad; i < n; ++i) {
      const float v = x[i];
      a = __dadd_rn(a, static_cast<double>(v));
      q = __dadd_rn(q, sq_of(v));
      S[i + 1] = a;
      Q[i + 1] = q;
    }
  }
  if (tid == 0) fixed[b] = bad < n ? 1 : 0;
  __syncthreads();

  // 2. the t-stat tracks
  const Params p = params(rna);
  float* T1 = T1_all + s0;
  float* T2 = T2_all + s0;
  for (int64_t i = tid; i < n; i += SUM_THREADS) {
    T1[i] = track(S, Q, i, n, p.w1);
    T2[i] = track(S, Q, i, n, p.w2);
  }
}

// Queues the copy of samples [lo, lo + PEAK_TILE) (those < n) of both
// tracks into buffer slot `buf` of `s_t`, as one group.
__device__ __forceinline__ void stage_peak_tile(const float* T1,
                                                const float* T2, int64_t lo,
                                                int64_t n, float* s_t,
                                                int buf, int lane) {
  float* d1 = s_t + (2 * buf) * PEAK_TILE;
  float* d2 = d1 + PEAK_TILE;
  const int64_t hi = lo + PEAK_TILE < n ? lo + PEAK_TILE : n;
  for (int64_t i = lo + lane; i < hi; i += 32) {
    __pipeline_memcpy_async(d1 + (i - lo), T1 + i, 4);
    __pipeline_memcpy_async(d2 + (i - lo), T2 + i, 4);
  }
  __pipeline_commit();
}

__device__ __forceinline__ bool gt_f32(float a, float b, float ph) {
  return __fsub_rn(a, b) > ph;  // an f32 difference, as in events.c
}

__global__ void __launch_bounds__(32) events_peaks_kernel(
    const float* __restrict__ T1_all, const float* __restrict__ T2_all,
    const int64_t* __restrict__ sig_off, int32_t* __restrict__ bnd_all,
    int32_t* __restrict__ n_events, int rna) {
  __shared__ __align__(16) float s_t[4 * PEAK_TILE];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t s0 = sig_off[b];
  const int64_t n = sig_off[b + 1] - s0;
  const float* T1 = T1_all + s0;
  const float* T2 = T2_all + s0;
  int32_t* bnd = bnd_all + s0 + 2 * b;  // n + 2 entries a read
  const Params p = params(rna);
  const int h1 = p.w1 / 2, h2 = p.w2 / 2;

  // the detectors' state (events.c:380-452), lane 0's
  int64_t pp0 = -1, pp1 = -1, masked1 = 0, m = 0;
  float pv0 = FLT_MAX, pv1 = FLT_MAX;
  bool val0 = false, val1 = false;

  stage_peak_tile(T1, T2, 0, n, s_t, 0, lane);
  stage_peak_tile(T1, T2, PEAK_TILE, n, s_t, 1, lane);
  for (int64_t t = 0; t * PEAK_TILE < n; ++t) {
    const int buf = static_cast<int>(t & 1);
    const int64_t lo = t * PEAK_TILE;
    __pipeline_wait_prior(1);  // tile t has landed (this lane's copies)
    __syncwarp();              // and every lane's
    if (lane == 0) {
      const float* c1 = s_t + (2 * buf) * PEAK_TILE;
      const float* c2 = c1 + PEAK_TILE;
      const int64_t hi = lo + PEAK_TILE < n ? lo + PEAK_TILE : n;
      for (int64_t i = lo > 0 ? lo : 1; i < hi; ++i) {
        float v = c1[i - lo];
        if (pp0 == -1) {
          if (v < pv0) {
            pv0 = v;
          } else if (gt_f32(v, pv0, p.ph)) {
            pv0 = v;
            pp0 = i;
          }
        } else {
          if (v > pv0) {
            pv0 = v;
            pp0 = i;
          }
          if (pv0 > p.th1) {  // the short detector masks the long one
            masked1 = pp0 + p.w1;
            pp1 = -1;
            pv1 = FLT_MAX;
            val1 = false;
          }
          if (gt_f32(pv0, v, p.ph) && pv0 > p.th1) val0 = true;
          if (val0 && i - pp0 > h1) {
            if (pp0 > 0 && pp0 < n) bnd[++m] = static_cast<int32_t>(pp0);
            pp0 = -1;
            pv0 = v;
            val0 = false;
          }
        }
        if (masked1 >= i) continue;
        v = c2[i - lo];
        if (pp1 == -1) {
          if (v < pv1) {
            pv1 = v;
          } else if (gt_f32(v, pv1, p.ph)) {
            pv1 = v;
            pp1 = i;
          }
        } else {
          if (v > pv1) {
            pv1 = v;
            pp1 = i;
          }
          if (gt_f32(pv1, v, p.ph) && pv1 > p.th2) val1 = true;
          if (val1 && i - pp1 > h2) {
            if (pp1 > 0 && pp1 < n) bnd[++m] = static_cast<int32_t>(pp1);
            pp1 = -1;
            pv1 = v;
            val1 = false;
          }
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer
    stage_peak_tile(T1, T2, lo + 2 * PEAK_TILE, n, s_t, buf, lane);
  }
  __pipeline_wait_prior(0);  // no copy outlives the block
  if (lane == 0) {
    bnd[0] = 0;
    bnd[m + 1] = static_cast<int32_t>(n);
    n_events[b] = static_cast<int32_t>(m + 1);
  }
}

__global__ void __launch_bounds__(SUM_THREADS) events_assemble_kernel(
    const double* __restrict__ S_all, const double* __restrict__ Q_all,
    const int64_t* __restrict__ sig_off,
    const int32_t* __restrict__ bnd_all, const int64_t* __restrict__ ev_off,
    int64_t* __restrict__ start, float* __restrict__ length,
    float* __restrict__ mean, float* __restrict__ stdv) {
  const int b = blockIdx.x;
  const int64_t s0 = sig_off[b];
  const double* S = S_all + s0 + b;
  const double* Q = Q_all + s0 + b;
  const int32_t* bnd = bnd_all + s0 + 2 * b;
  const int64_t o = ev_off[b];
  const int64_t ne = ev_off[b + 1] - o;
  for (int64_t j = threadIdx.x; j < ne; j += SUM_THREADS) {
    const int64_t s = bnd[j], e = bnd[j + 1];
    const float len = __ll2float_rn(e - s);
    const float mu =
        __fdiv_rn(__double2float_rn(__dsub_rn(S[e], S[s])), len);
    const float dsq = __double2float_rn(__dsub_rn(Q[e], Q[s]));
    const float var = __fsub_rn(__fdiv_rn(dsq, len), __fmul_rn(mu, mu));
    start[o + j] = s;
    length[o + j] = len;
    mean[o + j] = mu;
    stdv[o + j] = __fsqrt_rn(var > 0.0f ? var : 0.0f);
  }
}

}  // namespace

extern "C" {

// Launches the sums/tracks and the peak scan on `stream`; allocates
// nothing; returns cudaGetLastError() after the launches.  Scratch, per
// read b of n_b samples at offset sig_off[b]: S and Q (n_b + 1 doubles at
// sig_off[b] + b), T1 and T2 (n_b floats at sig_off[b]), the bounds
// (n_b + 2 ints at sig_off[b] + 2b); out: n_events [n_reads] and fixed
// [n_reads] (1 where the block redid its sums in sample order).
int f5c_events_detect(const void* pa_pool, const void* sig_off, void* S,
                      void* Q, void* T1, void* T2, void* bnd,
                      void* n_events, void* fixed, int n_reads, int rna,
                      void* stream) {
  cudaGetLastError();
  if (n_reads <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  events_sums_kernel<<<n_reads, SUM_THREADS, 0, st>>>(
      static_cast<const float*>(pa_pool),
      static_cast<const int64_t*>(sig_off), static_cast<double*>(S),
      static_cast<double*>(Q), static_cast<float*>(T1),
      static_cast<float*>(T2), rna, static_cast<int32_t*>(fixed));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  events_peaks_kernel<<<n_reads, 32, 0, st>>>(
      static_cast<const float*>(T1), static_cast<const float*>(T2),
      static_cast<const int64_t*>(sig_off), static_cast<int32_t*>(bnd),
      static_cast<int32_t*>(n_events), rna);
  return static_cast<int>(cudaGetLastError());
}

// Writes every read's events at ev_off[b] of the outputs.
int f5c_events_assemble(const void* S, const void* Q, const void* sig_off,
                        const void* bnd, const void* ev_off, void* start,
                        void* length, void* mean, void* stdv, int n_reads,
                        void* stream) {
  cudaGetLastError();
  if (n_reads > 0) {
    events_assemble_kernel<<<n_reads, SUM_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(S), static_cast<const double*>(Q),
        static_cast<const int64_t*>(sig_off),
        static_cast<const int32_t*>(bnd),
        static_cast<const int64_t*>(ev_off), static_cast<int64_t*>(start),
        static_cast<float*>(length), static_cast<float*>(mean),
        static_cast<float*>(stdv));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
