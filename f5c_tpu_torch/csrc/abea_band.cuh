// The ABEA band step shared by the unchunked fill (abea.cu) and the
// windowed fill of ultra-long reads (abea_ultra.cu), so that the two
// kernels cannot drift apart.  Algorithm reference: align.c:180-559; the
// plain PyTorch version is f5c_tpu_torch/ops/abea.py:_Band.step.
//
// A block of PAD threads owns one read; thread o is band offset o (BW
// active).  Three band rows rotate in shared memory: band bi lives in
// rows[bi % 3].  Every f32 operation is an __f*_rn intrinsic (never
// contracted into an FMA) and the library is built with --fmad=false.
//
// What bounds a read's fill on Hopper is the chain of dependent band
// steps: band bi places itself from band bi-1's edge cells (Suzuki's
// rule).  The step therefore reads only shared memory:
// - the read's inputs are staged by tiles of FILL_TILE bands in two rings
//   (Stage): per k-mer (kms = scale*mean + shift, stdv, LOG_INV_SQRT_2PI -
//   log_stdv), computed once per k-mer with the very operations of the
//   cell's formula, and the events.  In FILL_TILE bands the lower-left
//   corner moves by at most FILL_TILE k-mers and events, so a tile reaches
//   k-mers [ll_k, ll_k + T + BW) and events (ll_e - BW, ll_e + T]
//   (ops/abea.py fill_tile_reach).  The rings hold the current tile's
//   reach and the next one's; the next tile's sequence bytes and events
//   are loaded into registers when a tile starts and land while it runs;
// - the k-mer ranks are not an input: a read's sequence comes 2-bit
//   packed (ops/seq_ranks.py pack_seqs: whole 32-bit words), and the
//   staging ranks each k-mer from its words where it puts the k-mer into
//   the ring (kmer_rank: K11, f5c_tpu/ops/seq_ranks.py:72
//   ranks_from_packed, fused).  A read moves 0.25 B a base in place of a
//   4 B rank.  The next tile's k-mer stays in flight as two words: more
//   state live across the tile's bands slows them (a k-mer's bytes held
//   in 5 registers cost K3 11 % a window on the H100; PERF.md);
// - both candidate placements' neighbours and inputs are read, and both
//   placements' emissions (the correctly rounded division among them) and
//   diagonal and up sums computed, before Suzuki's rule picks one: after
//   the rule the chain only selects, adds the left move, takes two maxes
//   and stores (the emission after the rule cost ~265 ns a band; PERF.md);
// - the backtrace start is kept per thread (the thread that owns the
//   last-k-mer cell of a band scores it from its register) and reduced
//   over the block only at the end of a window, so no thread has serial
//   work after a band's barrier.  The reduction keeps the sequential
//   rule: the largest score, and of equal scores the earliest band.
// One barrier per band remains.

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

// The trace: 2 bits a band cell, TRACE_ROW bytes a band (ops/abea.py
// TRACE_ROW_BYTES, pack_trace).  A row is one uint2 for each warp of the
// block: .x holds bit 0 and .y bit 1 of the direction of cell o at bit
// o & 31 of uint2 o >> 5.
constexpr int TRACE_ROW = PAD / 4;
static_assert(TRACE_ROW % 16 == 0, "rows stay 16-byte aligned");

// Stores the band's directions (thread o's `frm`) as the trace row at
// `row`: two ballots a warp, and lane 0 of each warp stores its 8 bytes.
// Every thread of the block calls it, in a converged region.
__device__ __forceinline__ void store_trace_row(uint8_t* row, int o,
                                                int frm) {
  const unsigned lo = __ballot_sync(~0u, frm & 1);
  const unsigned hi = __ballot_sync(~0u, frm >> 1);
  if ((o & 31) == 0)
    reinterpret_cast<uint2*>(row)[o >> 5] = make_uint2(lo, hi);
}

// Staging (ops/abea.py FILL_TILE, fill_ring_slots, fill_smem_bytes).
constexpr int FILL_TILE = 128;
constexpr int RING = 512;                 // >= 2 * FILL_TILE + BW
constexpr int RING_MASK = RING - 1;
static_assert(RING >= 2 * FILL_TILE + BW, "the ring holds two tiles' reach");
static_assert(FILL_TILE <= PAD, "one staged k-mer and event per thread");
constexpr int FILL_SMEM = RING * (16 + 4) + PAD * 12;

// The carried state of a read between two bands, as a record of f32
// words (ints stored as their bits): band bi-1's row, band bi-2's row,
// band bi-1's and bi-2's lower-left k-mers, the backtrace start so far.
// Layout shared with ops/abea_ultra.py.
constexpr int ST_PREV = 0, ST_PREV2 = PAD, ST_LLK = 2 * PAD,
              ST_K2 = 2 * PAD + 1, ST_BEST_E = 2 * PAD + 2,
              ST_BEST_S = 2 * PAD + 3, ST_WORDS = 2 * PAD + 4;

struct ReadIn {
  const float* ev;       // the read's events
  const uint32_t* seq;   // the packed sequences of the batch, as words
  int64_t seq_off;       // the read's first base in them
  int ne, nk;
  int kmer;              // the model's k
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
  float best_s;  // backtrace start: best score
  int best_e;    // and its event
};

// This thread's best last-k-mer cell so far (score, band, event).
struct Cand {
  float s;
  int b;
  int e;
};

// The 32-bit words of the packed sequences (16 bases a word, the first
// in the low bits) that hold the k-mer at base `pos`: its first base's
// word and, where the k-mer runs past it (k <= 16), the next.  The
// staging loads them a tile ahead (load_kmer) and ranks them where they
// land (kmer_rank), so that the loads stay behind the tile's bands.
struct KmerWords {
  uint32_t lo, hi;
};

__device__ __forceinline__ KmerWords load_kmer(const uint32_t* seq,
                                               int64_t pos, int kmer) {
  const uint32_t* w = seq + (pos >> 4);
  return KmerWords{w[0], static_cast<int>(pos & 15) + kmer > 16 ? w[1]
                                                               : 0u};
}

// K11: the rank of the k-mer at base `pos` from its words, sum_j
// code[pos+j] << 2(k-1-j) (align.c:36-47; the plain version is
// ops/seq_ranks.py ranks_from_packed): its bases shifted down to the low
// bits, their 2-bit codes put in reverse order (the bits reversed, then
// each pair swapped back), the top 2k bits.  The fill's staging and the
// rank probe (abea.cu f5c_abea_ranks) both rank through it.
__device__ __forceinline__ int kmer_rank(KmerWords kw, int64_t pos,
                                         int kmer) {
  uint32_t r = __brev(
      __funnelshift_r(kw.lo, kw.hi, 2 * static_cast<int>(pos & 15)));
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return static_cast<int>(r >> (32 - 2 * kmer));
}

__device__ __forceinline__ ReadIn read_in(
    int i, const float* ev_pool, const int64_t* ev_off,
    const int32_t* ev_len, const uint8_t* seq, const int64_t* seq_off,
    const int32_t* rk_len, int kmer, const float* params) {
  ReadIn r;
  r.ev = ev_pool + ev_off[i];
  r.seq = reinterpret_cast<const uint32_t*>(seq);
  r.seq_off = seq_off[i];
  r.ne = ev_len[i];
  r.nk = rk_len[i];
  r.kmer = kmer;
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

// The read's inputs staged in shared memory (the layout of
// fill_smem_bytes): k-mer k at km[k & RING_MASK] = (kms, stdv,
// LOG_INV_SQRT_2PI - log_stdv, 0), event e at ev[e & RING_MASK], and the
// best-start reduction's scratch.  Loaded: k-mers [.., k_hi), events
// [.., e_hi).  Slots outside the read hold stale values that the band
// step never uses (its validity test excludes those cells).
struct Stage {
  float4* km;
  float* ev;
  float* red_s;
  int* red_b;
  int* red_e;
  int k_hi, e_hi;
  // the next tile's loads, in flight in registers
  int p_k, p_e;
  KmerWords p_kw;
  float p_ev;

  __device__ __forceinline__ void bind(unsigned char* smem) {
    km = reinterpret_cast<float4*>(smem);
    ev = reinterpret_cast<float*>(smem + RING * 16);
    red_s = reinterpret_cast<float*>(smem + RING * 20);
    red_b = reinterpret_cast<int*>(smem + RING * 20 + PAD * 4);
    red_e = reinterpret_cast<int*>(smem + RING * 20 + PAD * 8);
  }

  __device__ __forceinline__ void put_kmer(int k, int r, const ReadIn& rd,
                                           const Model& m) {
    r = r < 0 ? 0 : (r >= m.n ? m.n - 1 : r);
    km[k & RING_MASK] = make_float4(
        __fadd_rn(__fmul_rn(rd.scale, m.mean[r]), rd.shift), m.stdv[r],
        __fsub_rn(LOG_INV_SQRT_2PI, m.log_stdv[r]), 0.0f);
  }

  // Before the first band of a launch: the reach of the first tile,
  // from band base-1's lower-left corner.  Ends with a barrier.
  __device__ void init(int o, int ll_k, int ll_e, const ReadIn& rd,
                       const Model& m) {
    k_hi = ll_k + FILL_TILE + BW;
    e_hi = ll_e + FILL_TILE + 1;
    for (int k = ll_k + o; k < k_hi; k += PAD)
      if (k >= 0 && k < rd.nk) {
        const int64_t pos = rd.seq_off + k;
        put_kmer(k, kmer_rank(load_kmer(rd.seq, pos, rd.kmer), pos, rd.kmer),
                 rd, m);
      }
    for (int e = ll_e - BW + 1 + o; e < e_hi; e += PAD)
      if (e >= 0 && e < rd.ne) ev[e & RING_MASK] = rd.ev[e];
    p_k = p_e = -1;
    __syncthreads();
  }

  // At the start of a tile (band bi-1's corner ll_k, ll_e): start the
  // loads of what the next tile may reach beyond what is staged.
  __device__ __forceinline__ void prefetch(int o, int ll_k, int ll_e,
                                           const ReadIn& rd) {
    const int k = k_hi + o, e = e_hi + o;
    p_k = (k < ll_k + 2 * FILL_TILE + BW && k >= 0 && k < rd.nk) ? k : -1;
    p_e = (e < ll_e + 2 * FILL_TILE + 1 && e >= 0 && e < rd.ne) ? e : -1;
    if (p_k >= 0) p_kw = load_kmer(rd.seq, rd.seq_off + p_k, rd.kmer);
    if (p_e >= 0) p_ev = rd.ev[p_e];
    k_hi = ll_k + 2 * FILL_TILE + BW > k_hi ? ll_k + 2 * FILL_TILE + BW
                                            : k_hi;
    e_hi = ll_e + 2 * FILL_TILE + 1 > e_hi ? ll_e + 2 * FILL_TILE + 1 : e_hi;
  }

  // At the end of a tile: rank the prefetched k-mer and store it and the
  // prefetched event into the rings (the slots they take held k-mers and
  // events below the next tile's reach).  Ends with a barrier.
  __device__ __forceinline__ void land(const ReadIn& rd, const Model& m) {
    if (p_k >= 0)
      put_kmer(p_k, kmer_rank(p_kw, rd.seq_off + p_k, rd.kmer), rd, m);
    if (p_e >= 0) ev[p_e & RING_MASK] = p_ev;
    __syncthreads();
  }
};

// Fills band bi into rows[bi % 3] from rows[(bi-1) % 3] and
// rows[(bi-2) % 3] and returns thread o's direction (FROM_D outside the
// band).  Advances s to band bi (its best start is left to the block
// reduction) and updates this thread's candidate c.  Ends with one block
// barrier.
__device__ __forceinline__ int band_step(float (*rows)[PAD], int bi, int o,
                                         const ReadIn& rd, const Stage& st,
                                         BandState& s, Cand& c) {
  const float* prev = rows[(bi - 1) % 3];
  const float* prev2 = rows[(bi - 2) % 3];
  float* cur = rows[bi % 3];
  // both placements' neighbours and inputs, before Suzuki's rule
  const float p_m1 = lane_at(prev, o - 1), p_0 = prev[o],
              p_p1 = lane_at(prev, o + 1);
  const int d = s.ll_k - s.k2;
  const float q_0 = lane_at(prev2, o + d - 1), q_1 = lane_at(prev2, o + d);
  const float4 ka = st.km[(s.ll_k + o) & RING_MASK];
  const float4 kb = st.km[(s.ll_k + o + 1) & RING_MASK];
  const float ea = st.ev[(s.ll_e - o) & RING_MASK];
  const float eb = st.ev[(s.ll_e + 1 - o) & RING_MASK];
  // both placements scored before the rule: the emission and the
  // diagonal and up sums of a right move (k-mer kb, event ea) and of a
  // down move (ka, eb); the rule then only selects (the same operations
  // on the same operands: the selected values are the same bits)
  const float a_r = __fdiv_rn(__fsub_rn(ea, kb.x), kb.y);
  const float a_d = __fdiv_rn(__fsub_rn(eb, ka.x), ka.y);
  const float em_r = __fadd_rn(kb.z, __fmul_rn(__fmul_rn(-0.5f, a_r), a_r));
  const float em_d = __fadd_rn(ka.z, __fmul_rn(__fmul_rn(-0.5f, a_d), a_d));
  const float sd_r = __fadd_rn(__fadd_rn(q_1, rd.lp_step), em_r);
  const float su_r = __fadd_rn(__fadd_rn(p_p1, rd.lp_stay), em_r);
  const float sd_d = __fadd_rn(__fadd_rn(q_0, rd.lp_step), em_d);
  const float su_d = __fadd_rn(__fadd_rn(p_0, rd.lp_stay), em_d);
  // Suzuki's rule from the previous band's edge cells
  const float llv = prev[0], urv = prev[BW - 1];
  const bool both_ob = (llv == -CUDART_INF_F) && (urv == -CUDART_INF_F);
  const int right = both_ob ? (bi & 1) : (llv < urv ? 1 : 0);
  const int k1 = s.ll_k;
  s.ll_k += right;
  s.ll_e += 1 - right;

  const int e = s.ll_e - o;
  const int k = s.ll_k + o;
  // diag (k-1, e-1) in band bi-2 and up (k, e-1) in band bi-1, scored;
  // left (k-1, e) in band bi-1.  Branch-free, so that the scores above
  // stay ahead of the rule; a cell outside the band keeps -inf, FROM_D.
  const bool valid = o < BW && k >= 0 && k < rd.nk && e >= 0 && e < rd.ne;
  const float s_d = right ? sd_r : sd_d;
  const float s_u = right ? su_r : su_d;
  const float s_l = __fadd_rn(right ? p_0 : p_m1, rd.lp_skip);
  float mx = fmaxf(s_d, s_u);
  int best = (mx == s_u) ? FROM_U : FROM_D;
  mx = fmaxf(mx, s_l);
  if (mx == s_l) best = FROM_L;
  float row = valid ? mx : -CUDART_INF_F;
  int frm = valid ? best : FROM_D;
  // trim column: cell (k=-1, e=bi-1) while the band straddles it
  const int trim_off = -1 - s.ll_k;
  const int trim_ev = s.ll_e - trim_off;
  if (o == trim_off && trim_off < BW && trim_ev >= 0 && trim_ev < rd.ne) {
    row = __fmul_rn(rd.lp_trim, static_cast<float>(trim_ev + 1));
    frm = FROM_U;
  }
  // backtrace start: first best of last-k-mer cell + trim tail, scored
  // by the thread that holds the cell
  const int off_lc = (rd.nk - 1) - s.ll_k;
  const int e_lc = s.ll_e - off_lc;
  if (o == off_lc && off_lc < BW && e_lc >= 0 && e_lc < rd.ne) {
    const float cand = __fadd_rn(
        row, __fmul_rn(static_cast<float>(rd.ne - e_lc), rd.lp_trim));
    if (cand > c.s) {
      c.s = cand;
      c.b = bi;
      c.e = e_lc;
    }
  }
  cur[o] = row;
  s.k2 = k1;
  __syncthreads();
  return frm;
}

// The block's best candidate since the last reduction, folded into
// s.best_s / s.best_e with the sequential rule (strict >: an earlier
// window keeps a tie); every thread's candidate restarts.  Every thread
// gets the result.  Two barriers.
__device__ __forceinline__ void reduce_best(int o, const Stage& st,
                                            BandState& s, Cand& c) {
  st.red_s[o] = c.s;
  st.red_b[o] = c.b;
  st.red_e[o] = c.e;
  __syncthreads();
  float bs = -CUDART_INF_F;
  int bb = 0x7fffffff, be = -1;
  for (int j = 0; j < PAD; ++j) {
    const float cs = st.red_s[j];
    const int cb = st.red_b[j];
    if (cs > bs || (cs == bs && cs != -CUDART_INF_F && cb < bb)) {
      bs = cs;
      bb = cb;
      be = st.red_e[j];
    }
  }
  if (bs > s.best_s) {
    s.best_s = bs;
    s.best_e = be;
  }
  c = Cand{-CUDART_INF_F, 0x7fffffff, -1};
  __syncthreads();
}

// Runs bands [bi, stop) of one read: the band step, the tile bookkeeping
// of the rings (`left` bands until the next tile, carried across calls),
// and `emit(bi, frm)` after each band.
template <typename Emit>
__device__ __forceinline__ void run_bands(float (*rows)[PAD], int& bi,
                                          int stop, int o, const ReadIn& rd,
                                          const Model& m, Stage& st,
                                          BandState& s, Cand& c, int& left,
                                          Emit emit) {
  for (; bi < stop; ++bi) {
    if (left == 0) {
      st.land(rd, m);
      st.prefetch(o, s.ll_k, s.ll_e, rd);
      left = FILL_TILE;
    }
    const int frm = band_step(rows, bi, o, rd, st, s, c);
    emit(bi, frm);
    --left;
  }
}

}  // namespace f5c_abea
