// The inputs of one HMM window, built on the card from 16 bytes of window
// metadata, the 2-bit packed reference concat and the per-read table: the
// prologue of csrc/hmm.cu's forward kernel and of its rank probe.
//
// Replaces the device-side input assembly
// f5c_tpu/ops/hmm_meta.py:build_inputs (K6).  The plain version is
// f5c_tpu_torch/ops/hmm_meta.py:build_inputs, and kmer_rank() is its rank
// bit for bit, computed for one k-mer instead of as four rank planes over
// the whole concat:
//
// - base codes A0 C1 G2 T4 (c5), and the methylated codes m5 (C -> M=3
//   where the next base is G);
// - forward windows: sum_t x[p+t] * 5^(k-1-t), x = c5 or m5;
// - reverse windows: sum_u v[p+u] * 5^u, v = the complement of c5, or of
//   m5 with M -> G and a G after an M -> M;
// - the window-edge corrections of build_inputs (-2 on the last k-mer of a
//   forward methylated window ending in C followed by G, and on the first
//   k-mer of a reverse methylated window starting with G after a C);
// - positions as build_inputs takes them: the plane positions wrap at the
//   ends of the concat (torch.roll), a k-mer's start and the edge bases
//   are clamped to it.

#pragma once

#include <cstdint>

namespace hmm_in {

// read_tab columns (f5c_tpu_torch/ops/hmm_meta.py RT_*)
constexpr int RT_COLS = 8;
constexpr int RT_SCALE = 0, RT_SHIFT = 1, RT_VAR = 2, RT_LP_STAY = 3,
              RT_LP_STEP = 4, RT_RC = 5;

struct Window {
  int64_t gstart;     // the window's first base in the concat
  int64_t ev_start;   // its first event in the event pool
  int stride;         // +1, or -1: the events run downward
  int n_ev, wlen, n_km, meth, read_id;
};

// meta row w: [gstart][ev_start][n_ev * stride][wlen | meth<<15 | id<<16]
__device__ __forceinline__ Window load_window(const int4* __restrict__ meta,
                                              int w, int k) {
  const int4 m = meta[w];
  Window x;
  x.gstart = m.x;
  x.ev_start = m.y;
  x.stride = m.z < 0 ? -1 : 1;
  x.n_ev = m.z < 0 ? -m.z : m.z;
  x.wlen = m.w & 0x7FFF;
  x.meth = (m.w >> 15) & 1;
  x.read_id = (m.w >> 16) & 0xFFFF;
  x.n_km = x.wlen - (k - 1);    // <= 0: an empty window
  return x;
}

// c5 of concat position q, taken modulo the concat's n codes
__device__ __forceinline__ int code_wrap(const uint8_t* __restrict__ packed,
                                         int64_t n, int64_t q) {
  if (q < 0 || q >= n) {   // only past the ends: a 64-bit modulo is long
    q %= n;
    if (q < 0) q += n;
  }
  const int c = (packed[q >> 2] >> (2 * (q & 3))) & 3;
  return c + (c == 3);
}

// c5 of concat position q, clamped into the concat
__device__ __forceinline__ int code_clamp(const uint8_t* __restrict__ packed,
                                          int64_t n, int64_t q) {
  q = q < 0 ? 0 : (q >= n ? n - 1 : q);
  const int c = (packed[q >> 2] >> (2 * (q & 3))) & 3;
  return c + (c == 3);
}

__device__ __forceinline__ int methylated(int c, int next) {
  return (c == 1 && next == 2) ? 3 : c;
}

__device__ __forceinline__ int complement(int c) {   // A<->T, C<->G, M -> A
  return c == 0 ? 4 : (c == 1 ? 2 : (c == 2 ? 1 : 0));
}

// The rank of k-mer j of window x (0 <= j < x.n_km) on a read of strand
// rc, as build_inputs gives it; n is the concat's length in codes.
__device__ __forceinline__ int kmer_rank(const uint8_t* __restrict__ packed,
                                         int64_t n, int k, const Window& x,
                                         bool rc, int j) {
  int64_t p = x.gstart + j;
  p = p < 0 ? 0 : (p >= n ? n - 1 : p);
  // rolling codes of positions p+t-1, p+t, p+t+1 and their m5 values
  int c_prev = code_wrap(packed, n, p - 1);
  int c_cur = code_wrap(packed, n, p);
  int c_next = code_wrap(packed, n, p + 1);
  int m_prev = methylated(c_prev, c_cur);
  int m_cur = methylated(c_cur, c_next);
  int acc = 0, pw = 1;
  for (int t = 0; t < k; ++t) {
    if (!rc) {
      acc = acc * 5 + (x.meth ? m_cur : c_cur);
    } else {
      const int mv = (m_cur == 3) ? 2
          : ((m_cur == 2 && m_prev == 3) ? 3 : complement(m_cur));
      acc += (x.meth ? mv : complement(c_cur)) * pw;
      pw *= 5;
    }
    c_cur = c_next;
    c_next = code_wrap(packed, n, p + t + 2);
    m_prev = m_cur;
    m_cur = methylated(c_cur, c_next);
  }
  if (x.meth && !rc && j == x.n_km - 1) {
    const int64_t gend = x.gstart + x.wlen - 1;
    if (code_clamp(packed, n, gend) == 1
        && code_clamp(packed, n, gend + 1) == 2)
      acc -= 2;
  }
  if (x.meth && rc && j == 0) {
    if (code_clamp(packed, n, x.gstart - 1) == 1
        && code_clamp(packed, n, x.gstart) == 2)
      acc -= 2;
  }
  return acc;
}

}  // namespace hmm_in
