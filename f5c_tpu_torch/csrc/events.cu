// Event detection for Hopper (sm_90a).
//
// Replaces the JAX device op f5c_tpu/ops/events_device.py:
// detect_events_device (K9; its exact prefix sums _df_scan and
// _window_sums, its t-stat tracks _tstat, its peak scan _peak_scan, its
// host wrapper detect_events_batch).  The arithmetic is the port's host
// detector, f5c_tpu_torch/native/src/f5chost.cpp (tstat_at,
// compute_tstat_pair, peak_detector, f5c_detect_events,
// f5c_events_from_peaks; events.c:222-513), operation for operation in f64
// and f32 with correctly rounded intrinsics: the JAX op's two-float
// arithmetic existed only because the TPU has no f64.  The plain PyTorch
// version, the ragged layout and the plain model of these kernels (their
// tile table, order of additions, check and redo, and the assembly's
// event-to-read search) are f5c_tpu_torch/ops/events_device.py.
//
// The prefix sums and tracks, a grid over the launch's tiles of SUM_TILE
// samples (every tile of every read: a block finds its read by a binary
// search of the wrapper's tile table, an exclusive prefix of the reads'
// tile counts), in five launches:
//   1. events_tile_totals_kernel: each tile's totals of the samples and of
//      their f32 squares, in f64 (a thread sums its SUM_ITEMS consecutive
//      samples, a warp scan adds the threads' totals, the warps' totals
//      are added in order);
//   2. events_carry_kernel, one warp a read: the exclusive scan of the
//      read's tile totals, in rounds of 32 tiles (each a warp scan, a
//      running sum between rounds), in place: each tile's carry;
//   3. events_rescan_kernel: each tile rescans its samples from its carry
//      and stores S and Q, and checks the defining recurrence, S[i+1] ==
//      S[i] + x_i (and Q with the f32 square), at each of its samples but
//      its first, against the stored values;
//   4. events_fix_kernel, one block a read: the same check at the first
//      sample of each tile, against the previous tile's last stored value
//      (a carry from the scan of totals is not bitwise that value); from
//      the first failing sample of the read (an atomicMin over both
//      checks; every earlier sum is right by induction) one thread redoes
//      the sums in sample order, with no cap.  The host sums in sample
//      order; the tiled order gives the same bits exactly when no partial
//      sum rounds, which holds for real signals (f32 pA sums fit 45 of
//      the 53 bits) but not for every input: the result is the host's,
//      bit for bit, on any input, and fixed[b] says where it was redone;
//   5. events_tracks_kernel: the two t-stat tracks of every sample of the
//      launch, element-wise (the reads of S and Q at i +- w coalesce).
// The order of additions is fixed by the launch's tiles, so a read's
// sums, and whether it was redone, do not change from run to run.
// events_peaks_kernel, one block per read of up to 1,024 threads, one
// contiguous chunk of samples a thread: the two coupled peak detectors (a
// sequential state machine over the samples, peak_step) run chunk by chunk
// side by side, speculatively from the initial state, then re-run from
// their predecessors' end states until no start state changes, an exact
// fixed point (the schedule at the kernel); it writes the event bounds (0,
// the peaks in emission order, n), the event count and the rounds taken.
// A read has at most n + 1 events, the bound the host detector sizes its
// buffers to, so no read can overflow its slot.
// events_assemble_kernel, one thread an event of the launch (a binary
// search of the event offsets finds its read): start, length, mean and
// stdv, at the event's place in the compact output (the wrapper reads the
// counts back to size it).
//
// What bounds it: the peak scan's chain of dependent steps, one thread's
// chunk a round (the host detector runs the whole read as one chain); a
// long read fills one SM with 1,024 chains, which then share its issue
// slots.  On real signals 2-3 rounds (each run counts its chunk's
// emissions) and one writing run take 3-4 chunk lengths of steps.  The
// sums and tracks are bound by bytes: each sample's 4 bytes in, read
// twice (totals, rescan), and 28 bytes of scratch out (S and Q in f64, T1
// and T2 in f32), on every SM however long a read is (a 2.70 M-sample
// read is 660 tiles); their f64 additions, ~8 a sample, are far below the
// card's rate.  The tiles' samples go through shared memory both ways, so
// that the loads and the stores of S and Q coalesce.  The assembly reads
// its events' bounds and sums and writes 20 bytes an event.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUM_THREADS = 256;
constexpr int SUM_ITEMS = 16;
constexpr int SUM_TILE = SUM_THREADS * SUM_ITEMS;  // 4,096 samples a tile
constexpr int SUM_WARPS = SUM_THREADS / 32;
// shared memory of a tile kernel: the tile's samples as floats (one word
// of padding in 32) or its sums as doubles (one in 16), in turn
constexpr int SM_DOUBLES = SUM_TILE + SUM_TILE / 16;
constexpr int CARRY_WARPS = 8;     // reads a block of the carry scan
constexpr int FIX_THREADS = 128;
constexpr int EV_THREADS = 256;
constexpr int PEAK_THREADS = 1024;  // the most threads (chunks) a read
constexpr int MIN_CHUNK = 32;      // the fewest samples a chunk, when chosen
constexpr unsigned FULL = 0xffffffffu;

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

// The largest b < n with off[b] <= j, for j in [off[0], off[n]) and off
// non-decreasing: the read whose range [off[b], off[b + 1]) holds j
// (empty ranges are passed over).  events_device.owner is its model.
__device__ __forceinline__ int owner_of(const int64_t* __restrict__ off,
                                        int n, int64_t j) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Tile g of the launch: its read b (n samples at s0 of the slab), its
// first sample within the read and its samples (a read's positions are
// int32, as in the peak scan; the wrapper refuses longer reads).
struct Tile {
  int b, n, base, count;
  int64_t s0;
};

__device__ __forceinline__ Tile tile_at(const int64_t* __restrict__ sig_off,
                                        const int64_t* __restrict__ tile_off,
                                        int n_reads, int64_t g) {
  Tile t;
  t.b = owner_of(tile_off, n_reads, g);
  t.s0 = sig_off[t.b];
  t.n = static_cast<int>(sig_off[t.b + 1] - t.s0);
  t.base = static_cast<int>(g - tile_off[t.b]) * SUM_TILE;
  const int left = t.n - t.base;
  t.count = left < SUM_TILE ? left : SUM_TILE;
  return t;
}

__device__ __forceinline__ int fpad(int p) { return p + (p >> 5); }
__device__ __forceinline__ int dpad(int p) { return p + (p >> 4); }

// The tile's samples, SUM_ITEMS consecutive ones a thread (0 past the
// read): loaded coalesced into shared memory, read back by thread.
__device__ __forceinline__ void load_tile(const float* __restrict__ pa_pool,
                                          const Tile& t, double* sm,
                                          float (&v)[SUM_ITEMS]) {
  float* fs = reinterpret_cast<float*>(sm);
  const float* x = pa_pool + t.s0 + t.base;
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < SUM_ITEMS; ++m) {
    const int p = m * SUM_THREADS + tid;
    fs[fpad(p)] = p < t.count ? x[p] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) v[j] = fs[fpad(tid * SUM_ITEMS + j)];
  __syncthreads();
}

// Each thread's SUM_ITEMS values to out[0 .. count), coalesced through
// shared memory.
__device__ __forceinline__ void store_tile(double* sm,
                                           const double (&l)[SUM_ITEMS],
                                           double* __restrict__ out,
                                           int count) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) sm[dpad(tid * SUM_ITEMS + j)] = l[j];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < SUM_ITEMS; ++m) {
    const int p = m * SUM_THREADS + tid;
    if (p < count) out[p] = sm[dpad(p)];
  }
  __syncthreads();
}

// Inclusive warp scan of two sums: Hillis-Steele steps of 1 .. 16 lanes.
__device__ __forceinline__ void warp_scan2(double& a, double& q, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double ta = __shfl_up_sync(FULL, a, off);
    const double tq = __shfl_up_sync(FULL, q, off);
    if (lane >= off) {
      a = __dadd_rn(ta, a);
      q = __dadd_rn(tq, q);
    }
  }
}

// 1. The tiles' totals: tot[2g], tot[2g + 1] for tile g.
__global__ void __launch_bounds__(SUM_THREADS) events_tile_totals_kernel(
    const float* __restrict__ pa_pool, const int64_t* __restrict__ sig_off,
    const int64_t* __restrict__ tile_off, int n_reads,
    double* __restrict__ tot) {
  __shared__ double sm[SM_DOUBLES];
  __shared__ double wtot[2][SUM_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile t = tile_at(sig_off, tile_off, n_reads, blockIdx.x);
  float v[SUM_ITEMS];
  load_tile(pa_pool, t, sm, v);
  double a = 0.0, q = 0.0;
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) {
    a = __dadd_rn(a, static_cast<double>(v[j]));
    q = __dadd_rn(q, sq_of(v[j]));
  }
  warp_scan2(a, q, lane);
  if (lane == 31) {
    wtot[0][warp] = a;
    wtot[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ta = 0.0, tq = 0.0;
    for (int w = 0; w < SUM_WARPS; ++w) {
      ta = __dadd_rn(ta, wtot[0][w]);
      tq = __dadd_rn(tq, wtot[1][w]);
    }
    tot[2 * static_cast<int64_t>(blockIdx.x)] = ta;
    tot[2 * static_cast<int64_t>(blockIdx.x) + 1] = tq;
  }
}

// 2. Each read's tile totals replaced by their exclusive scan, one warp a
// read; also S[0] = Q[0] = 0 and fixed[b] = n (no failing sample yet).
__global__ void __launch_bounds__(32 * CARRY_WARPS) events_carry_kernel(
    const int64_t* __restrict__ sig_off, const int64_t* __restrict__ tile_off,
    int n_reads, double* __restrict__ tot, double* __restrict__ S_all,
    double* __restrict__ Q_all, int32_t* __restrict__ fixed) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * CARRY_WARPS + (threadIdx.x >> 5);
  if (b >= n_reads) return;  // the whole warp
  const int64_t t0 = tile_off[b], nt = tile_off[b + 1] - t0;
  double* tb = tot + 2 * t0;
  double run_a = 0.0, run_q = 0.0;
  for (int64_t r = 0; r < nt; r += 32) {
    const int64_t k = r + lane;
    const bool in = k < nt;
    double a = in ? tb[2 * k] : 0.0, q = in ? tb[2 * k + 1] : 0.0;
    warp_scan2(a, q, lane);
    double ea = __shfl_up_sync(FULL, a, 1), eq = __shfl_up_sync(FULL, q, 1);
    if (lane == 0) {
      ea = 0.0;
      eq = 0.0;
    }
    if (in) {
      tb[2 * k] = __dadd_rn(run_a, ea);
      tb[2 * k + 1] = __dadd_rn(run_q, eq);
    }
    run_a = __dadd_rn(run_a, __shfl_sync(FULL, a, 31));
    run_q = __dadd_rn(run_q, __shfl_sync(FULL, q, 31));
  }
  if (lane == 0) {
    const int64_t s0 = sig_off[b];
    S_all[s0 + b] = 0.0;
    Q_all[s0 + b] = 0.0;
    fixed[b] = static_cast<int32_t>(sig_off[b + 1] - s0);
  }
}

// 3. Each tile's sums from its carry, stored, and checked at every sample
// but the tile's first; a failure lowers fixed[b] to its sample.
__global__ void __launch_bounds__(SUM_THREADS) events_rescan_kernel(
    const float* __restrict__ pa_pool, const int64_t* __restrict__ sig_off,
    const int64_t* __restrict__ tile_off, int n_reads,
    const double* __restrict__ carry, double* __restrict__ S_all,
    double* __restrict__ Q_all, int32_t* __restrict__ fixed) {
  __shared__ double sm[SM_DOUBLES];
  __shared__ double wtot[2][SUM_WARPS], wlast[2][SUM_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t g = blockIdx.x;
  const Tile t = tile_at(sig_off, tile_off, n_reads, g);
  float v[SUM_ITEMS];
  load_tile(pa_pool, t, sm, v);
  double ls[SUM_ITEMS], lq[SUM_ITEMS];
  double a = 0.0, q = 0.0;
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) {
    a = __dadd_rn(a, static_cast<double>(v[j]));
    q = __dadd_rn(q, sq_of(v[j]));
    ls[j] = a;
    lq[j] = q;
  }
  warp_scan2(a, q, lane);
  if (lane == 31) {
    wtot[0][warp] = a;
    wtot[1][warp] = q;
  }
  double ea = __shfl_up_sync(FULL, a, 1), eq = __shfl_up_sync(FULL, q, 1);
  if (lane == 0) {
    ea = 0.0;
    eq = 0.0;
  }
  __syncthreads();
  double pa = carry[2 * g], pq = carry[2 * g + 1];
  for (int w = 0; w < warp; ++w) {
    pa = __dadd_rn(pa, wtot[0][w]);
    pq = __dadd_rn(pq, wtot[1][w]);
  }
  pa = __dadd_rn(pa, ea);
  pq = __dadd_rn(pq, eq);
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) {
    ls[j] = __dadd_rn(pa, ls[j]);
    lq[j] = __dadd_rn(pq, lq[j]);
  }
  // the sums stored just before this thread's first sample: its left
  // neighbour's last (lane 0: the previous warp's last lane's)
  if (lane == 31) {
    wlast[0][warp] = ls[SUM_ITEMS - 1];
    wlast[1][warp] = lq[SUM_ITEMS - 1];
  }
  double prev_a = __shfl_up_sync(FULL, ls[SUM_ITEMS - 1], 1);
  double prev_q = __shfl_up_sync(FULL, lq[SUM_ITEMS - 1], 1);
  __syncthreads();
  if (lane == 0 && warp > 0) {
    prev_a = wlast[0][warp - 1];
    prev_q = wlast[1][warp - 1];
  }
  int bad = -1;
#pragma unroll
  for (int j = 0; j < SUM_ITEMS; ++j) {
    const int p = tid * SUM_ITEMS + j;
    if (bad < 0 && p > 0 && p < t.count &&
        (__dadd_rn(prev_a, static_cast<double>(v[j])) != ls[j] ||
         __dadd_rn(prev_q, sq_of(v[j])) != lq[j]))
      bad = p;
    prev_a = ls[j];
    prev_q = lq[j];
  }
  if (bad >= 0) atomicMin(&fixed[t.b], t.base + bad);
  const int64_t at = t.s0 + t.b + 1 + t.base;  // S[base + 1 ..]
  store_tile(sm, ls, S_all + at, t.count);
  store_tile(sm, lq, Q_all + at, t.count);
}

// 4. The check at each tile's first sample, then the redo in sample order
// from the read's first failure; fixed[b] = 1 where it ran.
__global__ void __launch_bounds__(FIX_THREADS) events_fix_kernel(
    const float* __restrict__ pa_pool, const int64_t* __restrict__ sig_off,
    const int64_t* __restrict__ tile_off, double* __restrict__ S_all,
    double* __restrict__ Q_all, int32_t* __restrict__ fixed) {
  __shared__ int first_bad;
  const int b = blockIdx.x;
  const int64_t s0 = sig_off[b];
  const int n = static_cast<int>(sig_off[b + 1] - s0);
  const float* x = pa_pool + s0;
  double* S = S_all + s0 + b;  // n + 1 entries a read
  double* Q = Q_all + s0 + b;
  if (threadIdx.x == 0) first_bad = fixed[b];
  __syncthreads();
  const int nt = static_cast<int>(tile_off[b + 1] - tile_off[b]);
  for (int k = threadIdx.x; k < nt; k += FIX_THREADS) {
    const int i = k * SUM_TILE;
    const float v = x[i];
    if (__dadd_rn(S[i], static_cast<double>(v)) != S[i + 1] ||
        __dadd_rn(Q[i], sq_of(v)) != Q[i + 1])
      atomicMin(&first_bad, i);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int bad = first_bad;
  if (bad < n) {
    double a = S[bad], q = Q[bad];
    for (int i = bad; i < n; ++i) {
      const float v = x[i];
      a = __dadd_rn(a, static_cast<double>(v));
      q = __dadd_rn(q, sq_of(v));
      S[i + 1] = a;
      Q[i + 1] = q;
    }
  }
  fixed[b] = bad < n ? 1 : 0;
}

// 5. The two t-stat tracks of every sample, a tile a block.
__global__ void __launch_bounds__(SUM_THREADS) events_tracks_kernel(
    const int64_t* __restrict__ sig_off, const int64_t* __restrict__ tile_off,
    int n_reads, const double* __restrict__ S_all,
    const double* __restrict__ Q_all, float* __restrict__ T1_all,
    float* __restrict__ T2_all, int rna) {
  const Tile t = tile_at(sig_off, tile_off, n_reads, blockIdx.x);
  const double* S = S_all + t.s0 + t.b;
  const double* Q = Q_all + t.s0 + t.b;
  const Params p = params(rna);
#pragma unroll 4
  for (int m = 0; m < SUM_ITEMS; ++m) {
    const int k = m * SUM_THREADS + threadIdx.x;
    if (k < t.count) {
      const int i = t.base + k;
      T1_all[t.s0 + i] = track(S, Q, i, t.n, p.w1);
      T2_all[t.s0 + i] = track(S, Q, i, t.n, p.w2);
    }
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


// Event j of the launch, one thread each: its read by a binary search of
// ev_off (B + 1 entries), its bounds at the read's slot, its sums at the
// read's S and Q.
__global__ void __launch_bounds__(EV_THREADS) events_assemble_kernel(
    const double* __restrict__ S_all, const double* __restrict__ Q_all,
    const int64_t* __restrict__ sig_off,
    const int32_t* __restrict__ bnd_all, const int64_t* __restrict__ ev_off,
    int n_reads, int64_t n_events, int64_t* __restrict__ start,
    float* __restrict__ length, float* __restrict__ mean,
    float* __restrict__ stdv) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * EV_THREADS +
                    threadIdx.x;
  if (j >= n_events) return;
  const int b = owner_of(ev_off, n_reads, j);
  const int64_t s0 = sig_off[b];
  const double* S = S_all + s0 + b;
  const double* Q = Q_all + s0 + b;
  const int32_t* bnd = bnd_all + s0 + 2 * b;
  const int64_t k = j - ev_off[b];
  const int64_t s = bnd[k], e = bnd[k + 1];
  const float len = __ll2float_rn(e - s);
  const float mu = __fdiv_rn(__double2float_rn(__dsub_rn(S[e], S[s])), len);
  const float dsq = __double2float_rn(__dsub_rn(Q[e], Q[s]));
  const float var = __fsub_rn(__fdiv_rn(dsq, len), __fmul_rn(mu, mu));
  start[j] = s;
  length[j] = len;
  mean[j] = mu;
  stdv[j] = __fsqrt_rn(var > 0.0f ? var : 0.0f);
}

}  // namespace

extern "C" {

// Launches the prefix sums and the tracks on `stream`; allocates nothing;
// returns the first launch error, else cudaGetLastError() after the
// launches.  tile_off: i64 [n_reads + 1], the exclusive prefix of the
// reads' tile counts (ceil(n_b / 4096)), n_tiles its last entry; tot: f64
// [2 n_tiles] scratch.  Per read b of n_b samples at offset sig_off[b]: S
// and Q (n_b + 1 doubles at sig_off[b] + b), T1 and T2 (n_b floats at
// sig_off[b]; both slabs padded to a multiple of 8 floats, for the peak
// scan); fixed [n_reads]: 1 where the read's sums were redone in sample
// order.
int f5c_events_sums(const void* pa_pool, const void* sig_off,
                    const void* tile_off, void* tot, void* S, void* Q,
                    void* T1, void* T2, void* fixed, int n_reads,
                    int n_tiles, int rna, void* stream) {
  cudaGetLastError();
  if (n_reads <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(pa_pool);
  const int64_t* so = static_cast<const int64_t*>(sig_off);
  const int64_t* to = static_cast<const int64_t*>(tile_off);
  double* tt = static_cast<double*>(tot);
  double* s = static_cast<double*>(S);
  double* q = static_cast<double*>(Q);
  int32_t* fx = static_cast<int32_t*>(fixed);
  cudaError_t err;
  if (n_tiles > 0) {
    events_tile_totals_kernel<<<n_tiles, SUM_THREADS, 0, st>>>(x, so, to,
                                                               n_reads, tt);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  events_carry_kernel<<<(n_reads + CARRY_WARPS - 1) / CARRY_WARPS,
                        32 * CARRY_WARPS, 0, st>>>(so, to, n_reads, tt, s, q,
                                                   fx);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    events_rescan_kernel<<<n_tiles, SUM_THREADS, 0, st>>>(x, so, to, n_reads,
                                                          tt, s, q, fx);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  events_fix_kernel<<<n_reads, FIX_THREADS, 0, st>>>(x, so, to, s, q, fx);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    events_tracks_kernel<<<n_tiles, SUM_THREADS, 0, st>>>(
        so, to, n_reads, s, q, static_cast<float*>(T1),
        static_cast<float*>(T2), rna);
  }
  return static_cast<int>(cudaGetLastError());
}

// The peak scan on the tracks: T1, T2 and the bounds (n_b + 2 ints at
// sig_off[b] + 2b) in the layout above; out: n_events and rounds (the
// scan's), each [n_reads].  `threads`: the block, a multiple of 32 up to
// 1024; `chunk` > 0 pins the chunk length (then `threads` must be at least
// every read's number of chunks), 0 lets the kernel choose (the main
// path).
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

// Writes the launch's n_events events, read b's at ev_off[b] of the
// outputs.
int f5c_events_assemble(const void* S, const void* Q, const void* sig_off,
                        const void* bnd, const void* ev_off, void* start,
                        void* length, void* mean, void* stdv, int n_reads,
                        long long n_events, void* stream) {
  cudaGetLastError();
  if (n_reads > 0 && n_events > 0) {
    const long long blocks = (n_events + EV_THREADS - 1) / EV_THREADS;
    events_assemble_kernel<<<static_cast<unsigned>(blocks), EV_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(S), static_cast<const double*>(Q),
        static_cast<const int64_t*>(sig_off),
        static_cast<const int32_t*>(bnd),
        static_cast<const int64_t*>(ev_off), n_reads, n_events,
        static_cast<int64_t*>(start), static_cast<float*>(length),
        static_cast<float*>(mean), static_cast<float*>(stdv));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
