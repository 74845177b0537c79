// CpG profile-HMM forward log-likelihood per window, for Hopper (sm_90a).
//
// Replaces the TPU kernel f5c_tpu/ops/hmm_pallas.py:_hmm_kernel (launched
// by hmm_forward_pallas; K2) and covers the XLA scan
// f5c_tpu/ops/hmm.py:hmm_forward_packed (K7) that the JAX package uses for
// windows wider than 128 k-mers: this kernel takes any window width.  The
// plain PyTorch version is f5c_tpu_torch/ops/hmm.py:hmm_forward_plain.
// Algorithm reference: hmm.c:115-335 (M/B/K states, flanks, KMER_SKIP).
//
// One warp per window, lane = k-mer, looping over 32-k-mer chunks for wider
// windows.  The window's state (M, B, K) and its per-k-mer Gaussian
// (scaled mean, 1/stdv, log stdv) live in shared memory; each lane only
// ever touches its own k-mers there, so the cross-k-mer terms travel by
// warp shuffles and no barrier is needed.  Events are read straight from
// the event slab at ev_start + stride*i (a reverse-stride window steps
// downward), one step ahead of use.  The KMER_SKIP chain
// K_j = logsum(c_j, K_{j-1} + lp_kk) is solved as K_j = j*lp_kk +
// LSE_{i<=j}(c_i - i*lp_kk), an inclusive log-sum-exp warp scan with the
// running prefix carried across chunks.
// What bounds it: transcendentals.  A k-mer's step costs ~12 expf/logf/
// log1pf (5 in the M log-sum-exp, 2 logaddexp for B and the skip input,
// 5 more in the scan) against ~40 other flops and no memory traffic but
// one broadcast event load per warp.  The design keeps every lane of a
// narrow window busy on its own k-mer and never materialises a state row
// in device memory; trimming the scan's transcendentals (e.g. the
// closed-form segmented cumsum with one max) is later work.
//
// -inf guards follow the reference exactly: mx_s = 0 when the max is
// -inf, and logaddexp returns -inf when both arguments are -inf
// (otherwise -inf - -inf gives NaN).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_INV_SQRT_2PI = -0.918938f;
constexpr int MAX_SMEM = 232448;   // per-block opt-in limit on sm_90

// the f32 constants of the recurrence, in the order of
// f5c_tpu_torch/ops/hmm.py:CONSTS; passed to the kernel by value
struct HmmConsts {
  float mk, mb, kk, km, b3, bb, nsc, pre_a, pre_b;
};

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -CUDART_INF_F) return -CUDART_INF_F;
  const float d = -fabsf(__fsub_rn(a, b));
  return __fadd_rn(m, log1pf(expf(d)));
}

__device__ __forceinline__ float warp_lse_scan(float x, int lane) {
  for (int off = 1; off < WARP; off <<= 1) {
    const float y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = logaddexp(y, x);
  }
  return x;
}

__global__ void hmm_forward_kernel(
    const int32_t* __restrict__ ranks, int kw,
    const int32_t* __restrict__ n_km_arr, const float* __restrict__ ev_pool,
    const int64_t* __restrict__ ev_start_arr,
    const int32_t* __restrict__ stride_arr,
    const int32_t* __restrict__ n_ev_arr, const float* __restrict__ scale_arr,
    const float* __restrict__ shift_arr, const float* __restrict__ var_arr,
    const float* __restrict__ lp_stay_arr,
    const float* __restrict__ lp_step_arr,
    const float* __restrict__ level_mean,
    const float* __restrict__ level_stdv,
    const float* __restrict__ level_log_stdv, int n_model,
    const HmmConsts cst, int allow_pre, int allow_post,
    float* __restrict__ out, int n_win) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int w = blockIdx.x * (blockDim.x / WARP) + warp;
  if (w >= n_win) return;   // whole warp: no barrier follows
  float* sM = smem + static_cast<size_t>(warp) * 6 * kw;
  float* sB = sM + kw;
  float* sK = sB + kw;
  float* sGm = sK + kw;
  float* sGi = sGm + kw;
  float* sGl = sGi + kw;

  const float LP_MK = cst.mk, LP_MB = cst.mb, LP_KK = cst.kk;
  const float LP_KM = cst.km, LP_B3 = cst.b3, LP_BB = cst.bb;
  const float LP_NSC = cst.nsc, PRE_A = cst.pre_a, PRE_B = cst.pre_b;

  const int nkm = n_km_arr[w];
  const int nev = n_ev_arr[w];
  if (nkm <= 0 || nev <= 0) {
    if (lane == 0) out[w] = -CUDART_INF_F;
    return;
  }
  const float scale = scale_arr[w], shift = shift_arr[w];
  const float var = var_arr[w], log_var = logf(var);
  const float lp_stay = lp_stay_arr[w], lp_step = lp_step_arr[w];
  const int nch = (nkm + WARP - 1) / WARP;
  for (int c = 0; c < nch; ++c) {
    const int j = c * WARP + lane;
    if (j < nkm) {
      int r = ranks[static_cast<int64_t>(w) * kw + j];
      r = r < 0 ? 0 : (r >= n_model ? n_model - 1 : r);
      sGm[j] = __fadd_rn(__fmul_rn(scale, level_mean[r]), shift);
      sGi[j] = __fdiv_rn(1.0f, __fmul_rn(level_stdv[r], var));
      sGl[j] = __fadd_rn(level_log_stdv[r], log_var);
      sM[j] = -CUDART_INF_F;
      sB[j] = -CUDART_INF_F;
      sK[j] = -CUDART_INF_F;
    }
  }

  const float* evp = ev_pool + ev_start_arr[w];
  const int64_t stride = stride_arr[w];
  const float nevf = static_cast<float>(nev);
  float lp_end = -CUDART_INF_F;
  float e_next = evp[0];
  for (int i = 0; i < nev; ++i) {
    const float e = e_next;
    if (i + 1 < nev) e_next = evp[(i + 1) * stride];
    const float fi = static_cast<float>(i);
    const float pre = (i == 0) ? LP_NSC
        : __fadd_rn(PRE_A, __fmul_rn(__fsub_rn(fi, 1.0f), PRE_B));
    const float pf = (i == nev - 1) ? LP_NSC
        : __fadd_rn(PRE_A,
                    __fmul_rn(__fsub_rn(__fsub_rn(nevf, 2.0f), fi), PRE_B));
    const bool do_end = allow_post || i == nev - 1;
    // old M/B/K and new M/B of the previous chunk's last k-mer, and the
    // running log-sum-exp prefix of the skip chain
    float cM = -CUDART_INF_F, cB = -CUDART_INF_F, cK = -CUDART_INF_F;
    float cMn = -CUDART_INF_F, cBn = -CUDART_INF_F, cP = -CUDART_INF_F;
    for (int c = 0; c < nch; ++c) {
      const int j = c * WARP + lane;
      const bool in = j < nkm;
      const float Mo = in ? sM[j] : -CUDART_INF_F;
      const float Bo = in ? sB[j] : -CUDART_INF_F;
      const float Ko = in ? sK[j] : -CUDART_INF_F;
      float Mp = __shfl_up_sync(FULL, Mo, 1);
      float Bp = __shfl_up_sync(FULL, Bo, 1);
      float Kp = __shfl_up_sync(FULL, Ko, 1);
      if (lane == 0) {
        Mp = cM;
        Bp = cB;
        Kp = cK;
      }
      cM = __shfl_sync(FULL, Mo, WARP - 1);
      cB = __shfl_sync(FULL, Bo, WARP - 1);
      cK = __shfl_sync(FULL, Ko, WARP - 1);

      float m_new = -CUDART_INF_F, b_new = -CUDART_INF_F;
      if (in) {
        const float t0 = __fadd_rn(lp_stay, Mo);
        const float t1 = __fadd_rn(lp_step, Mp);
        const float t2 = __fadd_rn(LP_B3, Bo);
        const float t3 = __fadd_rn(LP_B3, Bp);
        const float t4 = __fadd_rn(LP_KM, Kp);
        const float mx = fmaxf(fmaxf(fmaxf(t0, t1), fmaxf(t2, t3)), t4);
        const float mx_s = (mx == -CUDART_INF_F) ? 0.0f : mx;
        float ssum = __fadd_rn(expf(__fsub_rn(t0, mx_s)),
                               expf(__fsub_rn(t1, mx_s)));
        ssum = __fadd_rn(ssum, expf(__fsub_rn(t2, mx_s)));
        ssum = __fadd_rn(ssum, expf(__fsub_rn(t3, mx_s)));
        ssum = __fadd_rn(ssum, expf(__fsub_rn(t4, mx_s)));
        m_new = (mx == -CUDART_INF_F) ? -CUDART_INF_F
                                       : __fadd_rn(mx_s, logf(ssum));
        // pre-flank soft clip into the window's first k-mer
        if (j == 0 && (allow_pre || i == 0)) m_new = logaddexp(m_new, pre);
        const float a = __fmul_rn(__fsub_rn(e, sGm[j]), sGi[j]);
        const float lp_em = __fadd_rn(__fsub_rn(LOG_INV_SQRT_2PI, sGl[j]),
                                      __fmul_rn(__fmul_rn(-0.5f, a), a));
        m_new = __fadd_rn(m_new, lp_em);
        b_new = logaddexp(__fadd_rn(LP_MB, Mo), __fadd_rn(LP_BB, Bo));
      }
      float mnp = __shfl_up_sync(FULL, m_new, 1);
      float bnp = __shfl_up_sync(FULL, b_new, 1);
      if (lane == 0) {
        mnp = cMn;
        bnp = cBn;
      }
      cMn = __shfl_sync(FULL, m_new, WARP - 1);
      cBn = __shfl_sync(FULL, b_new, WARP - 1);

      // KMER_SKIP chain: inclusive log-sum-exp scan of c_j - j*lp_kk
      const float jf = static_cast<float>(j);
      const float cc = in ? logaddexp(__fadd_rn(LP_MK, mnp),
                                      __fadd_rn(LP_B3, bnp))
                          : -CUDART_INF_F;
      float p = warp_lse_scan(__fsub_rn(cc, __fmul_rn(jf, LP_KK)), lane);
      p = logaddexp(cP, p);
      cP = __shfl_sync(FULL, p, WARP - 1);
      const float k_new = (p == -CUDART_INF_F)
          ? -CUDART_INF_F : __fadd_rn(__fmul_rn(jf, LP_KK), p);

      if (in) {
        sM[j] = m_new;
        sB[j] = b_new;
        sK[j] = k_new;
        if (j == nkm - 1 && do_end) {
          const float end_add = __fadd_rn(
              logaddexp(logaddexp(m_new, b_new), k_new), pf);
          lp_end = logaddexp(lp_end, end_add);
        }
      }
    }
  }
  lp_end = __shfl_sync(FULL, lp_end, (nkm - 1) % WARP);
  if (lane == 0) out[w] = lp_end;
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream`; allocates nothing; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when a window
// row of kw k-mers cannot fit one warp's shared memory).  `consts` is a
// HOST pointer to the nine f32 constants, copied into the launch.
int f5c_hmm_forward(const void* ranks, const void* n_km, const void* ev_pool,
                    const void* ev_start, const void* stride,
                    const void* n_ev, const void* scale, const void* shift,
                    const void* var, const void* lp_stay, const void* lp_step,
                    const void* level_mean, const void* level_stdv,
                    const void* level_log_stdv, const void* consts, void* out,
                    int kw, int n_model, int allow_pre, int allow_post,
                    int n_win, void* stream) {
  cudaGetLastError();
  if (n_win <= 0) return static_cast<int>(cudaSuccess);
  HmmConsts cst;
  std::memcpy(&cst, consts, sizeof(cst));
  const size_t per_warp = static_cast<size_t>(6) * kw * sizeof(float);
  int warps = 4;
  while (warps > 1 && warps * per_warp > MAX_SMEM) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hmm_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_win + warps - 1) / warps;
  hmm_forward_kernel<<<blocks, warps * WARP, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), kw,
      static_cast<const int32_t*>(n_km), static_cast<const float*>(ev_pool),
      static_cast<const int64_t*>(ev_start),
      static_cast<const int32_t*>(stride), static_cast<const int32_t*>(n_ev),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(var), static_cast<const float*>(lp_stay),
      static_cast<const float*>(lp_step),
      static_cast<const float*>(level_mean),
      static_cast<const float*>(level_stdv),
      static_cast<const float*>(level_log_stdv), n_model,
      cst, allow_pre, allow_post,
      static_cast<float*>(out), n_win);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
