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
// events_peaks_kernel, one block per read of up to 1,024 threads, one
// contiguous chunk of samples a thread: the two coupled peak detectors (a
// sequential state machine over the samples, peak_step) run chunk by chunk
// side by side, speculatively from the initial state, then re-run from
// their predecessors' end states until no start state changes, an exact
// fixed point (the schedule at the kernel); it writes the event bounds (0,
// the peaks in emission order, n), the event count and the rounds taken.
// A read has at most n + 1 events, the bound the host detector sizes its
// buffers to, so no read can overflow its slot.
// events_assemble_kernel, one block per read: start, length, mean and
// stdv of every event, at the read's offset in the compact output (the
// wrapper reads the counts back to size it).
//
// What bounds it: the peak scan's chain of dependent steps, one thread's
// chunk a round (the host detector runs the whole read as one chain); a
// long read fills one SM with 1,024 chains, which then share its issue
// slots.  On real signals 2-3 rounds (each run counts its chunk's
// emissions) and one writing run take 3-4 chunk lengths of steps.  The sums and tracks
// stream each sample's 28 bytes of scratch at the card's bandwidth, one
// block of 256 threads a read.  Reads run side by side, one block each.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUM_THREADS = 256;
constexpr int SUM_ITEMS = 8;
constexpr int SUM_TILE = SUM_THREADS * SUM_ITEMS;
constexpr int PEAK_THREADS = 1024;  // the most threads (chunks) a read
constexpr int MIN_CHUNK = 32;      // the fewest samples a chunk, when chosen

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

__device__ __forceinline__ bool gt_f32(float a, float b, float ph) {
  return __fsub_rn(a, b) > ph;  // an f32 difference, as in events.c
}

// The two detectors' state (events.c:380-452).  Positions are within the
// read (a read's bounds are int32, so is every position).
struct State {
  int pp0, pp1, masked1;
  float pv0, pv1;
  bool val0, val1;
};

__device__ __forceinline__ State initial_state() {
  return State{-1, -1, 0, FLT_MAX, FLT_MAX, false, false};
}

// Bitwise equality, pv as bits: equal states take equal paths.
__device__ __forceinline__ bool same_state(const State& a, const State& b) {
  return a.pp0 == b.pp0 && a.pp1 == b.pp1 && a.masked1 == b.masked1 &&
         __float_as_uint(a.pv0) == __float_as_uint(b.pv0) &&
         __float_as_uint(a.pv1) == __float_as_uint(b.pv1) &&
         a.val0 == b.val0 && a.val1 == b.val1;
}

// One sample i of both tracks (v1 = T1[i], v2 = T2[i]): the host
// detector's step, short detector first.  An emitted peak goes to
// out[m++] when WRITE, and is only counted otherwise.
template <bool WRITE>
__device__ __forceinline__ void peak_step(State& s, int i, float v1, float v2,
                                          const Params& p, int n, int& m,
                                          int32_t* out) {
  const int h1 = p.w1 / 2, h2 = p.w2 / 2;
  float v = v1;
  if (s.pp0 == -1) {
    if (v < s.pv0) {
      s.pv0 = v;
    } else if (gt_f32(v, s.pv0, p.ph)) {
      s.pv0 = v;
      s.pp0 = i;
    }
  } else {
    if (v > s.pv0) {
      s.pv0 = v;
      s.pp0 = i;
    }
    if (s.pv0 > p.th1) {  // the short detector masks the long one
      s.masked1 = s.pp0 + p.w1;
      s.pp1 = -1;
      s.pv1 = FLT_MAX;
      s.val1 = false;
    }
    if (gt_f32(s.pv0, v, p.ph) && s.pv0 > p.th1) s.val0 = true;
    if (s.val0 && i - s.pp0 > h1) {
      if (s.pp0 > 0 && s.pp0 < n) {
        if (WRITE) out[m] = s.pp0;
        ++m;
      }
      s.pp0 = -1;
      s.pv0 = v;
      s.val0 = false;
    }
  }
  if (s.masked1 >= i) return;
  v = v2;
  if (s.pp1 == -1) {
    if (v < s.pv1) {
      s.pv1 = v;
    } else if (gt_f32(v, s.pv1, p.ph)) {
      s.pv1 = v;
      s.pp1 = i;
    }
  } else {
    if (v > s.pv1) {
      s.pv1 = v;
      s.pp1 = i;
    }
    if (gt_f32(s.pv1, v, p.ph) && s.pv1 > p.th2) s.val1 = true;
    if (s.val1 && i - s.pp1 > h2) {
      if (s.pp1 > 0 && s.pp1 < n) {
        if (WRITE) out[m] = s.pp1;
        ++m;
      }
      s.pp1 = -1;
      s.pv1 = v;
      s.val1 = false;
    }
  }
}

__device__ __forceinline__ void load8(const float* t, int64_t g, float4& a,
                                      float4& b) {
  a = __ldg(reinterpret_cast<const float4*>(t + g));
  b = __ldg(reinterpret_cast<const float4*>(t + g + 4));
}

__device__ __forceinline__ float at8(const float4& a, const float4& b,
                                     int k) {
  return k < 4 ? (k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w)
               : (k == 4 ? b.x : k == 5 ? b.y : k == 6 ? b.z : b.w);
}

// Runs samples [lo, hi) of the read at s0 from state s; returns the peaks
// emitted (written to out[0..] when WRITE).  The tracks are read straight
// from global memory in aligned groups of 8 samples (two 16-byte loads a
// track; the slabs are padded to a multiple of 8), the next group loaded
// while this one runs; with the slab's samples at absolute offsets a
// group never straddles two reads' alignment.  A mask that ends before hi
// masks no later sample, so the end state holds it as 0, the initial mask.
template <bool WRITE>
__device__ int run_chunk(State& s, const float* __restrict__ T1,
                         const float* __restrict__ T2, int64_t s0, int lo,
                         int hi, const Params& p, int n, int32_t* out) {
  int m = 0;
  if (lo < hi) {
    const int64_t a_lo = s0 + lo, a_hi = s0 + hi;
    int64_t g = a_lo & ~static_cast<int64_t>(7);
    float4 c1a, c1b, c2a, c2b;
    load8(T1, g, c1a, c1b);
    load8(T2, g, c2a, c2b);
    for (; g < a_hi; g += 8) {
      float4 n1a = c1a, n1b = c1b, n2a = c2a, n2b = c2b;
      if (g + 8 < a_hi) {
        load8(T1, g + 8, n1a, n1b);
        load8(T2, g + 8, n2a, n2b);
      }
      const int k0 = a_lo > g ? static_cast<int>(a_lo - g) : 0;
      const int k1 = a_hi - g < 8 ? static_cast<int>(a_hi - g) : 8;
      const int i0 = static_cast<int>(g - s0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= k0 && k < k1)
          peak_step<WRITE>(s, i0 + k, at8(c1a, c1b, k), at8(c2a, c2b, k), p,
                           n, m, out);
      }
      c1a = n1a;
      c1b = n1b;
      c2a = n2a;
      c2b = n2b;
    }
  }
  if (s.masked1 < hi) s.masked1 = 0;
  return m;
}

// Block-wide exclusive scan of v (every thread of the block); *total gets
// the sum.  Uses wsum[32].
__device__ __forceinline__ int block_excl_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = wsum[nwarps - 1];
  return (warp > 0 ? wsum[warp - 1] : 0) + x - v;
}

// The chunk-parallel peak scan, one block per read, blockDim.x (32..1024,
// a multiple of 32) threads.  Thread c owns chunk c, samples [1 + c L,
// 1 + (c + 1) L) of [1, n): L = `chunk` when > 0 (the wrapper then gives
// at least as many threads as chunks), else the read's samples over
// min(blockDim.x, (n - 1) / MIN_CHUNK) chunks.  Exact by its fixed point:
//   round 1: every chunk runs from the initial state and keeps its end
//     state in shared memory;
//   round r > 1: every chunk whose predecessor's end state (round r - 1)
//     differs from the state it last ran from re-runs from it; the loop
//     ends when no start state changed.  After round r chunks 0..r-1 are
//     exact, so it ends within one round a chunk on any input (no cap).
//     On real signals the detectors fall back into step at an emission
//     (the state after one is (-1, that sample's value, false) whatever
//     came before): 2-3 rounds.  A long stretch where they never do (a
//     rise over threshold 1, then samples within the peak height below
//     it) takes one round a chunk, each re-running one chunk: the
//     sequential scan's length;
//   then each chunk's emissions from its last run (which started from its
//   fixed-point state) are counted, a block scan gives the offsets, and a
//   last run writes them to bnd[1 + offset ...]; bnd[0] = 0, bnd[m + 1] =
//   n, n_events = m + 1, rounds = r.  A chunk emits at most one peak a
//   detector every 2 samples (an emission needs its peak at an earlier
//   sample of the same run), a read at most n + 1 bounds in all: the
//   n + 2 slots a read has hold them on any input (the densest signal
//   known gives one event every 3 samples).
__global__ void __launch_bounds__(PEAK_THREADS) events_peaks_kernel(
    const float* __restrict__ T1_all, const float* __restrict__ T2_all,
    const int64_t* __restrict__ sig_off, int32_t* __restrict__ bnd_all,
    int32_t* __restrict__ n_events, int32_t* __restrict__ rounds_out,
    int rna, int chunk) {
  __shared__ int e_pp0[PEAK_THREADS], e_pp1[PEAK_THREADS],
      e_mask[PEAK_THREADS];
  __shared__ float e_pv0[PEAK_THREADS], e_pv1[PEAK_THREADS];
  __shared__ unsigned char e_val[PEAK_THREADS];
  __shared__ int wsum[32];
  const int b = blockIdx.x, c = threadIdx.x;
  const int64_t s0 = sig_off[b];
  const int n = static_cast<int>(sig_off[b + 1] - s0);
  int32_t* bnd = bnd_all + s0 + 2 * b;  // n + 2 entries a read
  const Params p = params(rna);

  const int span = n > 1 ? n - 1 : 0;  // samples 1 .. n - 1
  int L = chunk;
  if (L <= 0) {
    int want = span / MIN_CHUNK;
    want = want < 1 ? 1 : want;
    const int cn = want < static_cast<int>(blockDim.x) ? want : blockDim.x;
    L = span > 0 ? (span + cn - 1) / cn : 1;
  }
  const int n_chunks = (span + L - 1) / L;
  const bool active = c < n_chunks;
  const int lo = active ? 1 + c * L : n;
  const int hi = active ? (span - c * L < L ? n : lo + L) : n;

  State start = initial_state(), s = start;
  int count = 0;
  if (active) count = run_chunk<false>(s, T1_all, T2_all, s0, lo, hi, p, n,
                                       nullptr);
  int r = 1;
  for (;;) {
    e_pp0[c] = s.pp0;
    e_pp1[c] = s.pp1;
    e_mask[c] = s.masked1;
    e_pv0[c] = s.pv0;
    e_pv1[c] = s.pv1;
    e_val[c] = static_cast<unsigned char>(s.val0 | (s.val1 << 1));
    __syncthreads();
    State ns = start;
    if (active && c > 0) {
      const unsigned char v = e_val[c - 1];
      ns = State{e_pp0[c - 1], e_pp1[c - 1], e_mask[c - 1], e_pv0[c - 1],
                 e_pv1[c - 1], (v & 1) != 0, (v & 2) != 0};
    }
    const bool changed = !same_state(ns, start);
    // a barrier too: every thread has read its predecessor before any
    // end state is overwritten
    if (!__syncthreads_or(changed)) break;
    ++r;
    if (changed) {
      start = ns;
      s = start;
      count = run_chunk<false>(s, T1_all, T2_all, s0, lo, hi, p, n, nullptr);
    }
  }
  int total;
  const int off = block_excl_scan(count, wsum, &total);
  if (active) {
    s = start;
    run_chunk<true>(s, T1_all, T2_all, s0, lo, hi, p, n, bnd + 1 + off);
  }
  if (c == 0) {
    bnd[0] = 0;
    bnd[total + 1] = n;
    n_events[b] = total + 1;
    rounds_out[b] = r;
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
// sig_off[b] + b), T1 and T2 (n_b floats at sig_off[b]; both slabs padded
// to a multiple of 8 floats), the bounds (n_b + 2 ints at sig_off[b] +
// 2b); out: n_events, fixed (1 where the block redid its sums in sample
// order) and rounds (the peak scan's), each [n_reads].  `threads`: the
// peak scan's block, a multiple of 32 up to 1024.
int f5c_events_detect(const void* pa_pool, const void* sig_off, void* S,
                      void* Q, void* T1, void* T2, void* bnd,
                      void* n_events, void* fixed, void* rounds, int n_reads,
                      int rna, int threads, void* stream) {
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
  events_peaks_kernel<<<n_reads, threads, 0, st>>>(
      static_cast<const float*>(T1), static_cast<const float*>(T2),
      static_cast<const int64_t*>(sig_off), static_cast<int32_t*>(bnd),
      static_cast<int32_t*>(n_events), static_cast<int32_t*>(rounds), rna,
      0);
  return static_cast<int>(cudaGetLastError());
}

// The peak scan alone on given tracks (the probe): T1, T2 and the bounds
// in the layout above; `chunk` > 0 pins the chunk length (then `threads`
// must be at least every read's number of chunks), 0 lets the kernel
// choose as f5c_events_detect does.
int f5c_events_peaks(const void* T1, const void* T2, const void* sig_off,
                     void* bnd, void* n_events, void* rounds, int n_reads,
                     int rna, int chunk, int threads, void* stream) {
  cudaGetLastError();
  if (n_reads > 0) {
    events_peaks_kernel<<<n_reads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(T1), static_cast<const float*>(T2),
        static_cast<const int64_t*>(sig_off), static_cast<int32_t*>(bnd),
        static_cast<int32_t*>(n_events), static_cast<int32_t*>(rounds), rna,
        chunk);
  }
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
