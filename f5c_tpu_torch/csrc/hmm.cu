// CpG profile-HMM forward log-likelihood per window, for Hopper (sm_90a),
// with the window's inputs built inside the kernel.
//
// Replaces the TPU kernel f5c_tpu/ops/hmm_pallas.py:_hmm_kernel (K2)
// together with the input assembly that feeds it on the device,
// f5c_tpu/ops/hmm_meta.py:build_inputs (K6): the counterpart of
// hmm_meta.hmm_forward_meta.  It also covers the XLA scan
// f5c_tpu/ops/hmm.py:hmm_forward_packed (K7): it takes any window width.
// The plain PyTorch version is f5c_tpu_torch/ops/hmm_meta.py:
// hmm_forward_meta_plain (build_inputs, then ops/hmm.py:hmm_forward_plain).
// Algorithm reference: hmm.c:115-335 (M/B/K states, flanks, KMER_SKIP).
//
// Inputs: 16 bytes of metadata a window, the 2-bit packed reference, the
// per-read table, the event pool and the model.  A window's prologue ranks
// its k-mers from the packed reference (csrc/hmm_ranks.cuh, bit for bit
// build_inputs) and reads its read's scalars, so nothing of size [windows,
// k-mers] is ever in device memory.
//
// Layout: a lane is a k-mer.  The host sorts the windows: the first
// n_narrow have <= 16 k-mers and go two to a warp, one to each 16-lane
// segment (every shuffle and scan takes the segment's width; a segment out
// of events stays masked while its warp-mate goes on, and still joins each
// shuffle).  Every other window has a warp of its own and loops over
// 32-k-mer chunks: a window of one or two chunks keeps its state in
// registers, a wider one keeps its state and its k-mers' Gaussian terms
// in shared memory, each lane touching only its own k-mers.  Events are
// read one step ahead, straight from the pool (a broadcast load per
// segment; staging them a tile ahead in registers, one a lane, and
// shuffling each step's out measured 1.5-2.8 % slower on an H100,
// scripts/hmm_kernel_time.py).
//
// What bounds it: the special-function unit (16 results a clock per SM).
// The recurrence runs in base 2 (every log-probability times log2 e, once)
// on ex2.approx / lg2.approx, ~17 a cell: the M log-sum-exp is one max, 5
// ex2 and 1 lg2 (the pre-flank soft clip takes the slot of the absent
// previous k-mer at k-mer 0); B is 1 ex2 + 1 lg2; the KMER_SKIP input 1
// ex2; the KMER_SKIP chain K_j = logsum(c_j, K_{j-1} + kk) is an inclusive
// running-max scan in the linear domain over pairs (m, s) = m + log2 s,
// one ex2 a round (4 or 5 rounds) and one lg2 after it, with K of the
// previous chunk's last k-mer carried into the next chunk; the post-flank
// end term is a running pair in the window's last lane (4 ex2).  The
// kernel this replaces made ~28 libdevice expf/logf/log1pf calls a cell.
// The running max keeps the chain exact where one max per window would
// underflow (ROADMAP R4).
//
// Precision: a window's states are kept relative to an offset in float64,
// the sum of each step's largest M, so they stay near zero; without it the
// rounding of states thousands of nats from zero adds up over a wide
// window's thousands of steps to about the tolerance of
// f5c_tpu_torch/ops/hmm.py (whose plain version runs in float64).
//
// -inf guards: a max of -inf shifts by 0 (shift_of), so -inf - shift stays
// -inf and never makes NaN; ex2(-inf) = 0 and lg2(0) = -inf carry the rest.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hmm_ranks.cuh"

namespace {

using hmm_in::Window;

constexpr int WARP = 32;
constexpr int NARROW = 16;           // k-mers of a narrow window: a segment
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -__builtin_huge_valf();
constexpr float LOG2E = 1.44269504088896341f;
constexpr double LN2 = 0.693147180559945309;
constexpr float SQRT_HALF_LOG2E = 0.849321800288019f;   // sqrt(log2(e) / 2)
constexpr float LOG_INV_SQRT_2PI = -0.918938f;
constexpr int MAX_SMEM = 232448;     // per-block opt-in limit on sm_90

// the f32 constants of the recurrence in nats, in the order of
// f5c_tpu_torch/ops/hmm.py:CONSTS; passed to the kernel by value
struct HmmConsts {
  float mk, mb, kk, km, b3, bb, nsc, pre_a, pre_b;
};

// the transition constants in base 2
struct Trans {
  float mk, mb, kk, km, b3, bb;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float shift_of(float mx) {
  return mx == NEG_INF ? 0.0f : mx;
}

// log2(2^a + 2^b)
__device__ __forceinline__ float lse2(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx + lg2(1.0f + ex2(fminf(a, b) - shift_of(mx)));
}

// (m, s) += (m2, s2), pairs standing for m + log2(s), rescaled to the
// larger max
__device__ __forceinline__ void pair_add(float& m, float& s, float m2,
                                         float s2) {
  const float mx = fmaxf(m, m2);
  const float f = ex2(fminf(m, m2) - shift_of(mx));
  s = (m >= m2) ? __fmaf_rn(s2, f, s) : __fmaf_rn(s, f, s2);
  m = mx;
}

// A k-mer's emission in base 2: lg - ((e - mean) * inv)^2
struct Gauss {
  float mean, inv, lg;
};

__device__ __forceinline__ Gauss gauss_of(int r, int n_model, float scale,
                                          float shift, float var,
                                          float log_var,
                                          const float* __restrict__ lmean,
                                          const float* __restrict__ lstdv,
                                          const float* __restrict__ llogsd) {
  r = r < 0 ? 0 : (r >= n_model ? n_model - 1 : r);
  Gauss g;
  g.mean = __fadd_rn(__fmul_rn(scale, lmean[r]), shift);
  g.inv = __fmul_rn(__fdiv_rn(1.0f, __fmul_rn(lstdv[r], var)),
                    SQRT_HALF_LOG2E);
  g.lg = __fmul_rn(__fsub_rn(LOG_INV_SQRT_2PI, __fadd_rn(llogsd[r], log_var)),
                   LOG2E);
  return g;
}

// What one chunk hands the next within an event step: its last k-mer's
// old M/B/K and new M/B/K.
struct Carry {
  float Mo, Bo, Ko, Mn, Bn, Kn;
};

// One event step over one chunk of W k-mers (lane jl = k-mer j).  In:
// the old state (M, B, K), the Gaussian, the event, the base-2 transition
// terms of the window and the pre-flank term of k-mer 0 (-inf when the
// soft clip is not open).  Out: the new state in (M, B, K), and with
// MULTI (the window has more than one chunk) the carry for the next.
template <int W, bool MULTI>
__device__ __forceinline__ void step_chunk(float& M, float& B, float& K,
                                           const Gauss& g, float e, int j,
                                           int jl, float pre, float lp_stay,
                                           float lp_step, const Trans& tr,
                                           Carry& cy) {
  const float Mo = M, Bo = B, Ko = K;
  float Mp = __shfl_up_sync(FULL, Mo, 1, W);
  float Bp = __shfl_up_sync(FULL, Bo, 1, W);
  float Kp = __shfl_up_sync(FULL, Ko, 1, W);
  if (jl == 0) {
    Mp = cy.Mo;
    Bp = cy.Bo;
    Kp = cy.Ko;
  }
  const float t0 = lp_stay + Mo;
  const float t1 = (j == 0) ? pre : lp_step + Mp;
  const float t2 = tr.b3 + Bo;
  const float t3 = tr.b3 + Bp;
  const float t4 = tr.km + Kp;
  const float mx = fmaxf(fmaxf(fmaxf(t0, t1), fmaxf(t2, t3)), t4);
  const float sh = shift_of(mx);
  const float ssum = ((((ex2(t0 - sh) + ex2(t1 - sh)) + ex2(t2 - sh))
                       + ex2(t3 - sh)) + ex2(t4 - sh));
  const float a = (e - g.mean) * g.inv;
  const float m_new = (mx + lg2(ssum)) + __fmaf_rn(-a, a, g.lg);
  const float b_new = lse2(tr.mb + Mo, tr.bb + Bo);

  float mnp = __shfl_up_sync(FULL, m_new, 1, W);
  float bnp = __shfl_up_sync(FULL, b_new, 1, W);
  if (jl == 0) {
    mnp = cy.Mn;
    bnp = cy.Bn;
  }
  // the skip input c_j = logsum(mk + M_{j-1}, b3 + B_{j-1}) as a pair,
  // less jl * kk
  const float x = tr.mk + mnp, y = tr.b3 + bnp;
  const float cmx = fmaxf(x, y);
  const float jkk = static_cast<float>(jl) * tr.kk;
  float pm = cmx - jkk;
  float ps = 1.0f + ex2(fminf(x, y) - shift_of(cmx));
  if (MULTI && jl == 0) pair_add(pm, ps, cy.Kn + tr.kk, 1.0f);
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    // lanes below off add an empty pair: no branch around the shuffles
    const float m2 = __shfl_up_sync(FULL, pm, off, W);
    const float s2 = __shfl_up_sync(FULL, ps, off, W);
    pair_add(pm, ps, jl >= off ? m2 : NEG_INF, s2);
  }
  const float k_new = pm + (jkk + lg2(ps));
  if (MULTI) {
    cy.Mo = __shfl_sync(FULL, Mo, W - 1, W);
    cy.Bo = __shfl_sync(FULL, Bo, W - 1, W);
    cy.Ko = __shfl_sync(FULL, Ko, W - 1, W);
    cy.Mn = __shfl_sync(FULL, m_new, W - 1, W);
    cy.Bn = __shfl_sync(FULL, b_new, W - 1, W);
    cy.Kn = __shfl_sync(FULL, k_new, W - 1, W);
  }
  M = m_new;
  B = b_new;
  K = k_new;
}

// the post-flank end term: (em, es) += logsum(M, B, K) + pf, a pair
// em + log2(es) with its max in float64 (it lies as far below the offset
// as the flank term, thousands of units for a wide window, and is rebased
// on every step)
__device__ __forceinline__ void end_add(double& em, float& es, float M,
                                        float B, float K, float pf) {
  const float xm = M + pf, xb = B + pf, xk = K + pf;
  const float xmax = fmaxf(fmaxf(xm, xb), xk);
  if (xmax == NEG_INF) return;
  const float sum3 = (ex2(xm - xmax) + ex2(xb - xmax)) + ex2(xk - xmax);
  const double dd = static_cast<double>(xmax) - em;   // +inf: em is -inf
  const float f = ex2(-static_cast<float>(fabs(dd)));
  if (dd > 0.0) {
    es = __fmaf_rn(es, f, sum3);
    em = xmax;
  } else {
    es = __fmaf_rn(sum3, f, es);
  }
}

struct Args {
  const int4* meta;
  const uint8_t* packed;
  int64_t n_codes;
  const float* read_tab;
  const float* ev_pool;
  const float* level_mean;
  const float* level_stdv;
  const float* level_log_stdv;
  int n_model, k, allow_pre, allow_post;
  HmmConsts cst;
  float* out;
};

// Scores window w (valid: this segment has a window) on a segment of W
// lanes; lane jl of the segment.  The window's chunks of W k-mers: NREG
// of them with the state in registers, or with SMEM any number, the state
// in shared memory (6 * kw_smem floats).
template <int W, int NREG, bool SMEM>
__device__ void score_window(const Args& a, int w, bool valid, int jl,
                             float* smem, int kw_smem) {
  constexpr bool MULTI = SMEM || NREG > 1;
  constexpr int NR = SMEM ? 1 : NREG;    // chunks held in registers
  Window x{};
  if (valid) x = hmm_in::load_window(a.meta, w, a.k);
  const int cap = SMEM ? kw_smem : W * NREG;
  // a window too wide for its class scores NaN, so a wrong class split
  // shows instead of being cut
  const bool too_wide = valid && x.n_km > cap;
  const bool live = valid && !too_wide && x.n_km > 0 && x.n_ev > 0;
  const int nev = live ? x.n_ev : 0;
  const int nkm = live ? x.n_km : 0;
  const int steps = static_cast<int>(__reduce_max_sync(
      FULL, static_cast<unsigned>(nev)));

  const HmmConsts& c = a.cst;
  const Trans tr{c.mk * LOG2E, c.mb * LOG2E, c.kk * LOG2E,
                 c.km * LOG2E, c.b3 * LOG2E, c.bb * LOG2E};
  float scale = 0.0f, shift = 0.0f, var = 1.0f, lp_stay = 0.0f,
        lp_step = 0.0f;
  bool rc = false;
  if (live) {
    const float* rt = a.read_tab
        + static_cast<int64_t>(x.read_id) * hmm_in::RT_COLS;
    scale = rt[hmm_in::RT_SCALE];
    shift = rt[hmm_in::RT_SHIFT];
    var = rt[hmm_in::RT_VAR];
    lp_stay = rt[hmm_in::RT_LP_STAY] * LOG2E;
    lp_step = rt[hmm_in::RT_LP_STEP] * LOG2E;
    rc = rt[hmm_in::RT_RC] > 0.0f;
  }
  const float log_var = logf(var);
  // (0 for a window not scored: nothing touches shared memory)
  const int nch = SMEM ? (nkm + W - 1) / W : NREG;

  float* sM = smem;
  float* sB = sM + kw_smem;
  float* sK = sB + kw_smem;
  float* sGm = sK + kw_smem;
  float* sGi = sGm + kw_smem;
  float* sGl = sGi + kw_smem;
  Gauss gr[NR];
  float Mr[NR], Br[NR], Kr[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    gr[r] = Gauss{0.0f, 0.0f, 0.0f};
    Mr[r] = NEG_INF;
    Br[r] = NEG_INF;
    Kr[r] = NEG_INF;
  }
#pragma unroll
  for (int ch = 0; ch < nch; ++ch) {
    const int j = ch * W + jl;
    Gauss gj{0.0f, 0.0f, 0.0f};
    if (j < nkm) {
      const int r = hmm_in::kmer_rank(a.packed, a.n_codes, a.k, x, rc, j);
      gj = gauss_of(r, a.n_model, scale, shift, var, log_var, a.level_mean,
                    a.level_stdv, a.level_log_stdv);
    }
    if (SMEM) {
      sM[j] = NEG_INF;
      sB[j] = NEG_INF;
      sK[j] = NEG_INF;
      sGm[j] = gj.mean;
      sGi[j] = gj.inv;
      sGl[j] = gj.lg;
    } else {
      gr[SMEM ? 0 : ch] = gj;
    }
  }

  const float* evp = a.ev_pool + x.ev_start;
  const int64_t stride = x.stride;
  const float nevf = static_cast<float>(nev);
  // the states are kept relative to off, the sum of each step's largest M
  // (top), so that they stay near zero and their rounding does not grow
  // with the score
  double off = 0.0, em = -CUDART_INF;
  float es = 0.0f, top = 0.0f;
  float e_next = nev > 0 ? evp[0] : 0.0f;
  for (int i = 0; i < steps; ++i) {
    const float e = e_next;
    if (i + 1 < nev) e_next = evp[(i + 1) * stride];
    const bool act = i < nev;
    const float fi = static_cast<float>(i);
    // the flank terms as the reference forms them in nats, then base 2;
    // the pre-flank term relative to the offset
    const float pre = (i == 0 || a.allow_pre)
        ? static_cast<float>(static_cast<double>(
              ((i == 0) ? c.nsc
                        : __fadd_rn(c.pre_a, __fmul_rn(__fsub_rn(fi, 1.0f),
                                                       c.pre_b))) * LOG2E)
                             - off)
        : NEG_INF;
    const bool do_end = act && (a.allow_post || i == nev - 1);
    const float pf = ((i == nev - 1) ? c.nsc
        : __fadd_rn(c.pre_a, __fmul_rn(__fsub_rn(__fsub_rn(nevf, 2.0f), fi),
                                       c.pre_b))) * LOG2E;
    Carry cy{NEG_INF, NEG_INF, NEG_INF, NEG_INF, NEG_INF, NEG_INF};
    float vmax = NEG_INF;
#pragma unroll
    for (int ch = 0; ch < nch; ++ch) {
      const int j = ch * W + jl;
      const int r = SMEM ? 0 : ch;
      float M, B, K;
      Gauss g;
      if (SMEM) {
        M = sM[j] - top;
        B = sB[j] - top;
        K = sK[j] - top;
        g = Gauss{sGm[j], sGi[j], sGl[j]};
      } else {
        M = Mr[r];
        B = Br[r];
        K = Kr[r];
        g = gr[r];
      }
      const float Mo = M, Bo = B, Ko = K;
      step_chunk<W, MULTI>(M, B, K, g, e, j, jl, pre, lp_stay, lp_step, tr,
                           cy);
      if (!act) {          // a finished segment keeps its state
        M = Mo;
        B = Bo;
        K = Ko;
      }
      if (do_end && j == nkm - 1) end_add(em, es, M, B, K, pf);
      if (SMEM) {
        sM[j] = M;
        sB[j] = B;
        sK[j] = K;
      } else {
        Mr[r] = M;
        Br[r] = B;
        Kr[r] = K;
      }
      if (j < nkm) vmax = fmaxf(vmax, M);
    }
    // the offset takes the step's largest M (applied to the states held
    // in shared memory as they are loaded)
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
      vmax = fmaxf(vmax, __shfl_xor_sync(FULL, vmax, o, W));
    top = (act && vmax != NEG_INF) ? vmax : 0.0f;
    if (!SMEM) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        Mr[r] -= top;
        Br[r] -= top;
        Kr[r] -= top;
      }
    }
    em -= top;
    off += top;
  }
  if (!valid) return;
  if (too_wide) {
    if (jl == 0) a.out[w] = CUDART_NAN_F;
  } else if (nkm == 0) {
    if (jl == 0) a.out[w] = NEG_INF;
  } else if (jl == (nkm - 1) % W) {
    a.out[w] = static_cast<float>(
        (em + static_cast<double>(lg2(es)) + off) * LN2);
  }
}

__global__ void __launch_bounds__(128)
hmm_forward_meta_kernel(Args a, int n_win, int n_narrow, int kw_smem) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int gw = blockIdx.x * (blockDim.x / WARP) + warp;
  const int narrow_warps = (n_narrow + 1) / 2;
  if (gw < narrow_warps) {
    const int w = 2 * gw + lane / NARROW;
    score_window<NARROW, 1, false>(a, w, w < n_narrow, lane % NARROW,
                                   nullptr, 0);
    return;
  }
  const int w = n_narrow + (gw - narrow_warps);
  if (w >= n_win) return;   // whole warp: no shuffle follows
  const Window x = hmm_in::load_window(a.meta, w, a.k);
  if (x.n_km <= WARP) {
    score_window<WARP, 1, false>(a, w, true, lane, nullptr, 0);
  } else if (x.n_km <= 2 * WARP) {
    score_window<WARP, 2, false>(a, w, true, lane, nullptr, 0);
  } else {
    score_window<WARP, 1, true>(
        a, w, true, lane, smem + static_cast<size_t>(warp) * 6 * kw_smem,
        kw_smem);
  }
}

// the rank probe: ranks [n_win, kw] i32 as build_inputs lays them out
__global__ void hmm_window_ranks_kernel(const int4* __restrict__ meta,
                                        const uint8_t* __restrict__ packed,
                                        int64_t n_codes,
                                        const float* __restrict__ read_tab,
                                        int k, int kw, int n_win,
                                        int32_t* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (idx >= static_cast<int64_t>(n_win) * kw) return;
  const int w = static_cast<int>(idx / kw);
  const int j = static_cast<int>(idx % kw);
  const Window x = hmm_in::load_window(meta, w, k);
  const bool rc = read_tab[static_cast<int64_t>(x.read_id) * hmm_in::RT_COLS
                           + hmm_in::RT_RC] > 0.0f;
  out[idx] = j < x.n_km ? hmm_in::kmer_rank(packed, n_codes, k, x, rc, j) : 0;
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream`; allocates nothing; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when kw_smem
// k-mers of state cannot fit one warp's shared memory).  The first
// n_narrow windows of meta must have <= 16 k-mers; kw_smem is 0 when no
// window has more than 64 k-mers, else at least the widest window's
// k-mers, a multiple of 32.  `consts` is a HOST pointer to the nine f32
// constants, copied into the launch.
int f5c_hmm_forward_meta(const void* meta, const void* packed,
                         const void* read_tab, const void* ev_pool,
                         const void* level_mean, const void* level_stdv,
                         const void* level_log_stdv, const void* consts,
                         void* out, long long n_codes, int n_model, int k,
                         int allow_pre, int allow_post, int n_win,
                         int n_narrow, int kw_smem, void* stream) {
  cudaGetLastError();
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.meta = static_cast<const int4*>(meta);
  a.packed = static_cast<const uint8_t*>(packed);
  a.n_codes = n_codes;
  a.read_tab = static_cast<const float*>(read_tab);
  a.ev_pool = static_cast<const float*>(ev_pool);
  a.level_mean = static_cast<const float*>(level_mean);
  a.level_stdv = static_cast<const float*>(level_stdv);
  a.level_log_stdv = static_cast<const float*>(level_log_stdv);
  a.n_model = n_model;
  a.k = k;
  a.allow_pre = allow_pre;
  a.allow_post = allow_post;
  std::memcpy(&a.cst, consts, sizeof(a.cst));
  a.out = static_cast<float*>(out);
  const size_t per_warp = static_cast<size_t>(6) * kw_smem * sizeof(float);
  int warps = 4;
  while (warps > 1 && warps * per_warp > MAX_SMEM) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hmm_forward_meta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_warps = (n_narrow + 1) / 2 + (n_win - n_narrow);
  const int blocks = (n_warps + warps - 1) / warps;
  hmm_forward_meta_kernel<<<blocks, warps * WARP, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      a, n_win, n_narrow, kw_smem);
  return static_cast<int>(cudaGetLastError());
}

// The rank probe: the ranks the forward kernel's prologue computes, as
// build_inputs lays them out ([n_win, kw] i32, 0 past a window's k-mers).
int f5c_hmm_window_ranks(const void* meta, const void* packed,
                         const void* read_tab, void* out, long long n_codes,
                         int k, int kw, int n_win, void* stream) {
  cudaGetLastError();
  const long long total = static_cast<long long>(n_win) * kw;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hmm_window_ranks_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(meta), static_cast<const uint8_t*>(packed),
      n_codes, static_cast<const float*>(read_tab), k, kw, n_win,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
