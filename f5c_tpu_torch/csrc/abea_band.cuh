// The ABEA band step shared by the unchunked fill (abea.cu) and the
// windowed fill of ultra-long reads (abea_ultra.cu), so that the two
// kernels cannot drift apart.  Algorithm reference: align.c:180-559; the
// plain PyTorch version is f5c_tpu_torch/ops/abea.py:_Band.step.
//
// A block of PAD threads owns one read; thread o is band offset o (BW
// active).  Three band rows rotate in shared memory: band bi lives in
// rows[bi % 3].  Every f32 operation is an __f*_rn intrinsic (never
// contracted into an FMA) and the library is built with --fmad=false.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace f5c_abea {

constexpr int BW = 100;
constexpr int PAD = 128;
constexpr int FROM_D = 0, FROM_U = 1, FROM_L = 2;
constexpr int HALF = BW / 2;
constexpr int LL_K0 = -1 - HALF;          // band 0's lower-left k-mer
constexpr int START_OFF = -1 - LL_K0;     // offset of cells (-1,-1), (-1,0)
constexpr float LOG_INV_SQRT_2PI = -0.918938f;

// The carried state of a read between two bands, as a record of f32
// words (ints stored as their bits): band bi-1's row, band bi-2's row,
// band bi-1's and bi-2's lower-left k-mers, the backtrace start so far.
// Layout shared with ops/abea_ultra.py.
constexpr int ST_PREV = 0, ST_PREV2 = PAD, ST_LLK = 2 * PAD,
              ST_K2 = 2 * PAD + 1, ST_BEST_E = 2 * PAD + 2,
              ST_BEST_S = 2 * PAD + 3, ST_WORDS = 2 * PAD + 4;

struct ReadIn {
  const float* ev;       // the read's events
  const int32_t* rk;     // its k-mer ranks
  int ne, nk;
  float scale, shift, lp_stay, lp_step, lp_skip, lp_trim;
};

struct Model {
  const float* mean;
  const float* stdv;
  const float* log_stdv;
  int n;
};

struct BandState {
  int ll_k;      // band bi-1's lower-left k-mer
  int k2;        // band bi-2's
  int ll_e;      // band bi-1's lower-left event (= bi - 3 - ll_k)
  float best_s;  // backtrace start: best score (thread 0 only)
  int best_e;    // and its event
};

__device__ __forceinline__ ReadIn read_in(
    int i, const float* ev_pool, const int64_t* ev_off,
    const int32_t* ev_len, const int32_t* rk_pool, const int64_t* rk_off,
    const int32_t* rk_len, const float* params) {
  ReadIn r;
  r.ev = ev_pool + ev_off[i];
  r.rk = rk_pool + rk_off[i];
  r.ne = ev_len[i];
  r.nk = rk_len[i];
  r.scale = params[6 * i + 0];
  r.shift = params[6 * i + 1];
  r.lp_stay = params[6 * i + 2];
  r.lp_step = params[6 * i + 3];
  r.lp_skip = params[6 * i + 4];
  r.lp_trim = params[6 * i + 5];
  return r;
}

__device__ __forceinline__ float lane_at(const float* row, int o) {
  return (o >= 0 && o < PAD) ? row[o] : -CUDART_INF_F;
}

// Fills band bi into rows[bi % 3] from rows[(bi-1) % 3] and
// rows[(bi-2) % 3] and returns thread o's direction (FROM_D outside the
// band).  Advances s to band bi.  Ends with one block barrier, after which
// thread 0 updates the backtrace start.
__device__ __forceinline__ int band_step(float (*rows)[PAD], int bi, int o,
                                         const ReadIn& rd, const Model& m,
                                         BandState& s) {
  const float* prev = rows[(bi - 1) % 3];
  const float* prev2 = rows[(bi - 2) % 3];
  float* cur = rows[bi % 3];
  // Suzuki's rule from the previous band's edge cells
  const float llv = prev[0], urv = prev[BW - 1];
  const bool both_ob = (llv == -CUDART_INF_F) && (urv == -CUDART_INF_F);
  const int right = both_ob ? (bi & 1) : (llv < urv ? 1 : 0);
  const int k1 = s.ll_k;
  s.ll_k += right;
  s.ll_e += 1 - right;

  const int e = s.ll_e - o;
  const int k = s.ll_k + o;
  float row = -CUDART_INF_F;
  int frm = FROM_D;
  if (o < BW && k >= 0 && k < rd.nk && e >= 0 && e < rd.ne) {
    int r = rd.rk[k];
    r = r < 0 ? 0 : (r >= m.n ? m.n - 1 : r);
    const float kms = __fadd_rn(__fmul_rn(rd.scale, m.mean[r]), rd.shift);
    const float a = __fdiv_rn(__fsub_rn(rd.ev[e], kms), m.stdv[r]);
    const float em = __fadd_rn(__fsub_rn(LOG_INV_SQRT_2PI, m.log_stdv[r]),
                               __fmul_rn(__fmul_rn(-0.5f, a), a));
    const float up = lane_at(prev, o + right);               // (k, e-1)
    const float left = lane_at(prev, o + right - 1);         // (k-1, e)
    const float diag = lane_at(prev2, o + (s.ll_k - s.k2) - 1);  // (k-1, e-1)
    const float s_d = __fadd_rn(__fadd_rn(diag, rd.lp_step), em);
    const float s_u = __fadd_rn(__fadd_rn(up, rd.lp_stay), em);
    const float s_l = __fadd_rn(left, rd.lp_skip);
    float mx = fmaxf(s_d, s_u);
    frm = (mx == s_u) ? FROM_U : FROM_D;
    mx = fmaxf(mx, s_l);
    if (mx == s_l) frm = FROM_L;
    row = mx;
  }
  // trim column: cell (k=-1, e=bi-1) while the band straddles it
  const int trim_off = -1 - s.ll_k;
  const int trim_ev = s.ll_e - trim_off;
  if (o == trim_off && trim_off < BW && trim_ev >= 0 && trim_ev < rd.ne) {
    row = __fmul_rn(rd.lp_trim, static_cast<float>(trim_ev + 1));
    frm = FROM_U;
  }
  cur[o] = row;
  s.k2 = k1;
  __syncthreads();

  if (o == 0) {
    // backtrace start: first best of last-k-mer cell + trim tail
    const int off_lc = (rd.nk - 1) - s.ll_k;
    const int e_lc = s.ll_e - off_lc;
    if (off_lc >= 0 && off_lc < BW && e_lc >= 0 && e_lc < rd.ne) {
      const float cand = __fadd_rn(
          cur[off_lc], __fmul_rn(static_cast<float>(rd.ne - e_lc),
                                 rd.lp_trim));
      if (cand > s.best_s) {
        s.best_s = cand;
        s.best_e = e_lc;
      }
    }
  }
  return frm;
}

}  // namespace f5c_abea
