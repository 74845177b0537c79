// The ABEA backtrace walk of long reads as a tile-parallel walk over
// every SM (sm_90a): the unchunked walk of reads over the crossover
// (ops/abea_cuda.py TILED_MIN_BANDS; K4, f5c_tpu/ops/abea_ring.py:377
// abea_backtrace_ring) and the walk of one window of ultra-long reads
// with (k, e, n) carried (K10, f5c_tpu/ops/abea_ultra.py:306
// walk_window).  The plain PyTorch version of its three phases is
// f5c_tpu_torch/ops/abea.py walk_tiled_maps / walk_tiled_chase /
// walk_tiled_emit (abea_walk_tiled_plain; the window's
// ops/abea_ultra.py walk_window_tiled_plain).
//
// What bounds the one-warp walk (abea_walk.cuh) is its chain: one
// dependent shared-memory load a step, ~95 ns on an H100, and a read of
// 811,435 bands walks ~500,000 steps alone on one SM.  The walk only
// descends, one or two bands a step, so it enters a tile of T =
// WALK_TILE bands (rows [jT, jT + T) of the read) from the tile above at
// one of the cells of its top two rows, and the cell where it leaves the
// tile depends on nothing outside it.  So:
//
// (a) walk_maps_kernel, a block a tile of every routed read below the
//     read's start tile, MAP_ENTRIES threads: the tile's rows are staged
//     in shared memory with cp.async, and each thread walks from one
//     entry cell (row hi - 1 - sel, offset o < BW from the row's llk) to
//     where it leaves the tile, and writes that exit as a u16 entry of
//     the tile below (MAP_*: its (sel, o) and the steps, or a stop: the
//     walk ended, or left outside the mapped cells).  One more block a
//     read walks the start cell out of its tile (start_rec).  Thousands
//     of short walks side by side: the work is ~160 steps a band, spread
//     over every SM.
// (b) walk_chase_kernel, a warp a read: from the start's exit, one
//     shared-memory load a tile (the maps staged CHASE_GROUP tiles at a
//     time with cp.async, double-buffered) gives the next tile's entry
//     and the steps; it records each tile's entry and the steps before
//     it (ent: the exclusive scan of n).  The only serial part: 6,340
//     lookups on an 811,435-band read at T = 128, in place of ~500,000
//     steps.  A path that leaves a tile outside the mapped cells (never
//     on a fill's own trace) is walked cell by cell from global memory.
// (c) walk_emit_kernel, a warp a visited tile: re-walks the tile from its
//     entry (rows staged, EMIT_BELOW more under it) and writes its
//     directions at their final position n.  Bytes are written whole, by
//     an owner rule: the tile that holds a byte's first step writes it,
//     walking on past its tile (at most 3 steps) to finish it; the walk's
//     first tile also owns the byte a carried n starts in (a window that
//     continues the previous one ORs onto its low bits, as walk_tiles
//     does).  Bytes at or past `cap` are not written.  The tile where the
//     walk ends writes (k, e, n): n_out, or kst for a window.
//
// The result is bit for bit the one-warp walk's (and abea_walk_plain's):
// the same cells in the same order, the same stopping rule (k < 0, e < 0,
// and for windows e + k + 2 < base) and the same clamp of a band past the
// last row to the last row.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "abea_band.cuh"
#include "abea_walk.cuh"

namespace {

using namespace f5c_abea;

// ops/abea.py MAP_STOP, MAP_OFF, MAP_ENTRIES, EMIT_BELOW, CHASE_GROUP,
// EMIT_WARPS and the *_smem_bytes helpers.
constexpr int MAP_ENTRIES = 2 * BW;
constexpr int MAP_STOP = 1 << 15;
constexpr int MAP_OFF = 1 << 14;
constexpr int EMIT_BELOW = 6;
constexpr int CHASE_GROUP = 32;
constexpr int EMIT_WARPS = 4;
constexpr int MAP_SMEM = WALK_TILE * (TRACE_ROW + 4) + 2 * 4;
constexpr int CHASE_SMEM = 2 * CHASE_GROUP * MAP_ENTRIES * 2;
constexpr int EMIT_SMEM =
    EMIT_WARPS * (WALK_TILE + EMIT_BELOW) * (TRACE_ROW + 4);
constexpr int ENT_MAPPED = 1, ENT_EXACT = 2;
static_assert(WALK_TILE <= 128, "a map entry holds steps - 1 in 7 bits");
static_assert(MAP_ENTRIES * 2 % 16 == 0, "a tile's map is whole 16 B");

struct TiledArgs {
  const uint8_t* trace;
  const int32_t* llk;
  const int64_t* band_off;  // unchunked: read r's rows; null for a window
  const int32_t* start_e;   // unchunked: the start (rk_len[r] - 1, start_e)
  const int32_t* rk_len;
  int32_t* kst;             // a window: (k, e, n) a read, in and out
  int32_t* n_out;           // unchunked: the walk's length
  const int64_t* byte_off;
  uint8_t* out;
  const int32_t* reads;     // routed read q -> read r (null: q)
  const int32_t* tile_off;  // read q's tiles are slots [tile_off[q], [q+1])
  uint16_t* maps;           // [n_tiles * MAP_ENTRIES]
  int4* start_rec;          // [R]: (code, steps)
  int4* ent;                // [n_tiles]: (kind, a, b, n)
  int2* span;               // [R]: (j_end, j_s), the visited tiles
  int base, win, n_reads, n_tiles;
};

// One routed read: its rows (row 0 at tr / llk), output and start cell.
struct ReadView {
  int r;
  const uint8_t* tr;
  const int32_t* llk;
  int rows;
  uint8_t* out;
  int64_t cap;
};

__device__ __forceinline__ ReadView read_view(const TiledArgs& a, int q) {
  ReadView v;
  v.r = a.reads ? a.reads[q] : q;
  int64_t row0;
  if (a.band_off) {
    row0 = a.band_off[v.r];
    v.rows = static_cast<int>(a.band_off[v.r + 1] - row0);
  } else {
    row0 = static_cast<int64_t>(v.r) * a.win;
    v.rows = a.win;
  }
  v.tr = a.trace + row0 * TRACE_ROW;
  v.llk = a.llk + row0;
  v.out = a.out + a.byte_off[v.r];
  v.cap = a.byte_off[v.r + 1] - a.byte_off[v.r];
  return v;
}

// The walk's first cell (k, e, n) and its tile (-1: it does not walk).
__device__ __forceinline__ int start_cell(const TiledArgs& a,
                                          const ReadView& v, int& k, int& e,
                                          int& n) {
  if (a.band_off) {
    const int se = a.start_e[v.r];
    k = se >= 0 ? a.rk_len[v.r] - 1 : -1;
    e = se >= 0 ? se : -1;
    n = 0;
  } else {
    k = a.kst[3 * v.r];
    e = a.kst[3 * v.r + 1];
    n = a.kst[3 * v.r + 2];
  }
  const int vb = e + k + 2 - a.base;
  if (k < 0 || e < 0 || vb < 0) return -1;
  return (vb >= v.rows ? v.rows - 1 : vb) / WALK_TILE;
}

// The routed read whose tiles hold slot t.
__device__ __forceinline__ int find_read(const int32_t* tile_off, int R,
                                         int t) {
  int lo = 0, hi = R;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= t)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Rows of a read held from row `lo` on: row r's trace at tr + (r - lo) *
// TRACE_ROW, its llk at llk[r - lo].
struct Rows {
  const uint8_t* tr;
  const int32_t* llk;
  int lo;
  __device__ __forceinline__ int lk(int r) const { return llk[r - lo]; }
};

// Walks from (k, e) while the walk goes on (k >= 0, e >= 0, v = e + k +
// 2 - base >= 0), its row min(v, rows - 1) is >= `lo` and it has taken
// fewer than `limit` steps; `step(s, d)` sees step s's direction.
// Returns the steps; `ended`: the walk stopped by its rule.
template <typename Step>
__device__ __forceinline__ int walk_in(const Rows& R, int rows, int base,
                                       int lo, int& k, int& e, bool& ended,
                                       int limit, Step step) {
  for (int s = 0;; ++s) {
    const int v = e + k + 2 - base;
    if (k < 0 || e < 0 || v < 0) {
      ended = true;
      return s;
    }
    const int r = v >= rows ? rows - 1 : v;
    if (r < lo || s >= limit) {
      ended = false;
      return s;
    }
    int o = k - R.lk(r);
    o = o < 0 ? 0 : (o >= PAD ? PAD - 1 : o);
    const uint2 w =
        reinterpret_cast<const uint2*>(R.tr + (r - R.lo) * TRACE_ROW)[o >> 5];
    const unsigned up = (w.x >> (o & 31)) & 1u;    // FROM_U
    const unsigned left = (w.y >> (o & 31)) & 1u;  // FROM_L
    step(s, up | (left << 1));
    k -= 1 - static_cast<int>(up);
    e -= 1 - static_cast<int>(left);
  }
}

struct NoStep {
  __device__ __forceinline__ void operator()(int, unsigned) const {}
};

// The map code of a walk that left the tile whose low row is `lo` at
// (k, e) after `steps` steps, or ended there (ops/abea.py _exit_code).
__device__ __forceinline__ int exit_code(const Rows& R, int base, int lo,
                                         int k, int e, int steps,
                                         bool ended) {
  if (ended) return MAP_STOP | steps;
  const int rr = e + k + 2 - base;  // lo - 1 or lo - 2
  const int o = k - R.lk(rr);
  if (o >= 0 && o < BW) return o | ((lo - 1 - rr) << 7) | ((steps - 1) << 8);
  return MAP_STOP | MAP_OFF | steps;
}

// Queues the copy of rows [r0, r1) of a read (trace and llk) into
// s_tr / s_llk (row r0 first) by `nt` threads, thread `t`, and commits it.
__device__ __forceinline__ void stage_rows(const ReadView& v, int r0, int r1,
                                           uint8_t* s_tr, int32_t* s_llk,
                                           int t, int nt) {
  const int chunks = (r1 - r0) * (TRACE_ROW / 16);
  const uint8_t* src = v.tr + static_cast<int64_t>(r0) * TRACE_ROW;
  for (int c = t; c < chunks; c += nt)
    __pipeline_memcpy_async(s_tr + 16 * c, src + 16 * c, 16);
  for (int r = r0 + t; r < r1; r += nt)
    __pipeline_memcpy_async(s_llk + (r - r0), v.llk + r, 4);
  __pipeline_commit();
}

// (a) The maps of the tiles below each read's start tile, and the start
// walks (blocks n_tiles .. n_tiles + R - 1).
__global__ void __launch_bounds__(MAP_ENTRIES) walk_maps_kernel(TiledArgs a) {
  __shared__ __align__(16) uint8_t s_tr[WALK_TILE * TRACE_ROW];
  __shared__ int32_t s_llk[WALK_TILE + 2];  // rows lo - 2 .. hi - 1
  const int t = threadIdx.x;
  const bool is_start = blockIdx.x >= a.n_tiles;
  const int q = is_start ? blockIdx.x - a.n_tiles
                         : find_read(a.tile_off, a.n_reads, blockIdx.x);
  const ReadView v = read_view(a, q);
  int k0, e0, n0;
  const int js = start_cell(a, v, k0, e0, n0);
  const int j = is_start ? js : blockIdx.x - a.tile_off[q];
  if (is_start && js < 0) {
    if (t == 0) a.start_rec[q] = make_int4(MAP_STOP, 0, 0, 0);
    return;
  }
  if (!is_start && j >= js) return;  // at or above the start: no map
  const int lo = j * WALK_TILE;
  const int hi = lo + WALK_TILE < v.rows ? lo + WALK_TILE : v.rows;
  const int r0 = lo >= 2 ? lo - 2 : 0;
  stage_rows(v, lo, hi, s_tr, s_llk + 2, t, blockDim.x);
  if (t < lo - r0) __pipeline_memcpy_async(s_llk + 2 - (lo - r0) + t,
                                           v.llk + r0 + t, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const Rows R{s_tr, s_llk + 2, lo};
  bool ended;
  if (is_start) {
    if (t == 0) {
      int k = k0, e = e0;
      const int s = walk_in(R, v.rows, a.base, lo, k, e, ended, INT_MAX,
                            NoStep{});
      int code = exit_code(R, a.base, lo, k, e, 1, ended);
      if (code & MAP_STOP) code &= ~0x3fff;  // the steps are apart
      a.start_rec[q] = make_int4(code, s, 0, 0);
    }
    return;
  }
  if (t < MAP_ENTRIES) {
    const int sel = t >= BW ? 1 : 0;
    const int o = t - sel * BW;
    const int er = hi - 1 - sel;
    int k = R.lk(er) + o;
    int e = er + a.base - 2 - k;
    const int s = walk_in(R, v.rows, a.base, lo, k, e, ended, INT_MAX,
                          NoStep{});
    a.maps[static_cast<int64_t>(blockIdx.x) * MAP_ENTRIES + t] =
        static_cast<uint16_t>(exit_code(R, a.base, lo, k, e, s, ended));
  }
}

__device__ __forceinline__ int map_steps(int code) {
  return (code & MAP_STOP) ? (code & 0x3fff) : (code >> 8) + 1;
}

// Queues the copy of the maps of tiles [glo, ghi] (those >= 0) of a read
// whose slots start at t0 into `dst` (tile glo first), and commits it.
__device__ __forceinline__ void stage_maps(const uint16_t* maps, int t0,
                                           int glo, int ghi, uint16_t* dst,
                                           int lane) {
  const int g0 = glo < 0 ? 0 : glo;
  if (g0 <= ghi) {
    const int chunks = (ghi - g0 + 1) * (MAP_ENTRIES * 2 / 16);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        maps + static_cast<int64_t>(t0 + g0) * MAP_ENTRIES);
    uint8_t* d = reinterpret_cast<uint8_t*>(dst + (g0 - glo) * MAP_ENTRIES);
    for (int c = lane; c < chunks; c += 32)
      __pipeline_memcpy_async(d + 16 * c, src + 16 * c, 16);
  }
  __pipeline_commit();
}

// (b) The chase, a warp a routed read.  Every lane runs it (the same
// addresses: broadcasts) and stores the same records.
__global__ void __launch_bounds__(32) walk_chase_kernel(TiledArgs a) {
  __shared__ __align__(16) uint16_t s_map[2][CHASE_GROUP * MAP_ENTRIES];
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  const ReadView v = read_view(a, q);
  int k, e, n;
  const int js = start_cell(a, v, k, e, n);
  if (js < 0) {
    if (lane == 0) a.span[q] = make_int2(1, 0);
    return;
  }
  const int t0 = a.tile_off[q];
  const Rows G{v.tr, v.llk, 0};
  a.ent[t0 + js] = make_int4(ENT_EXACT, k, e, n);
  const int4 st = a.start_rec[q];
  int code = st.x, steps = st.y;
  int j = js, sel = 0, o = 0;
  // have: `code` is tile j's exit (then lookup is false); lookup: tile
  // j's exit is to be read from its map; mapped: tile j's entry is
  // (sel, o), else the exact cell (k, e)
  bool have = true;
  bool mapped = false;
  bool lookup = false;
  const int top = js - 1;  // the maps' tiles: top, top - 1, ..., 0
  stage_maps(a.maps, t0, top - CHASE_GROUP + 1, top, s_map[0], lane);
  stage_maps(a.maps, t0, top - 2 * CHASE_GROUP + 1, top - CHASE_GROUP,
             s_map[1], lane);
  for (int g = 0;; ++g) {
    const int buf = g & 1;
    const int glo = top - (g + 1) * CHASE_GROUP + 1;
    __pipeline_wait_prior(1);  // group g has landed (this lane's copies)
    __syncwarp();              // and every lane's
    bool done = false;
    if (!lookup || j >= glo) {
      for (;;) {
        if (have && !(code & MAP_STOP)) {  // the start's exit: a mapped cell
          n += steps;
          sel = (code >> 7) & 1;
          o = code & 127;
          --j;
          a.ent[t0 + j] = make_int4(ENT_MAPPED, sel, o, n);
          mapped = lookup = true;
          have = false;
        }
        if (lookup) {
          // the mapped chain: one shared-memory load a tile.  Every lane
          // stores the same record (no divergent branch on the chain).
          int row = j - glo;
          if (row < 0) break;  // in a group below
          code = s_map[buf][row * MAP_ENTRIES + sel * BW + o];
          while (!(code & MAP_STOP)) {
            n += (code >> 8) + 1;
            sel = (code >> 7) & 1;
            o = code & 127;
            --j;
            a.ent[t0 + j] = make_int4(ENT_MAPPED, sel, o, n);
            if (--row < 0) break;
            code = s_map[buf][row * MAP_ENTRIES + sel * BW + o];
          }
          if (row < 0) break;  // tile j's map is in a group below
          steps = code & 0x3fff;
          lookup = false;
          have = true;
        }
        if (have) {
          if (!(code & MAP_OFF)) {
            n += steps;
            done = true;
            break;
          }
          if (mapped) {  // the entry's cell, exactly
            const int er = j * WALK_TILE + WALK_TILE - 1 - sel;
            k = G.lk(er) + o;
            e = er + a.base - 2 - k;
          }
        }
        // cell by cell out of tile j, from global memory
        bool ended;
        n += walk_in(G, v.rows, a.base, j * WALK_TILE, k, e, ended, INT_MAX,
                     NoStep{});
        if (ended) {
          done = true;
          break;
        }
        const int er = e + k + 2 - a.base;
        o = k - G.lk(er);
        sel = j * WALK_TILE - 1 - er;
        --j;
        mapped = o >= 0 && o < BW;
        a.ent[t0 + j] = mapped ? make_int4(ENT_MAPPED, sel, o, n)
                               : make_int4(ENT_EXACT, k, e, n);
        lookup = mapped;
        have = false;
      }
    }
    if (done || glo <= 0) break;  // tile 0's exits all end the walk
    __syncwarp();  // every lane is done with this buffer
    stage_maps(a.maps, t0, top - (g + 3) * CHASE_GROUP + 1,
               top - (g + 2) * CHASE_GROUP, s_map[buf], lane);
  }
  __pipeline_wait_prior(0);  // no copy outlives the block
  if (lane == 0) a.span[q] = make_int2(j, js);
}

// (c) Emission, a warp a tile slot; lane 0 walks (the others stage).
__global__ void __launch_bounds__(32 * EMIT_WARPS) walk_emit_kernel(
    TiledArgs a) {
  constexpr int ROWS = WALK_TILE + EMIT_BELOW;
  __shared__ __align__(16) uint8_t smem[EMIT_SMEM];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * EMIT_WARPS + w;
  if (slot >= a.n_tiles) return;
  const int q = find_read(a.tile_off, a.n_reads, slot);
  const int j = slot - a.tile_off[q];
  const int2 sp = a.span[q];
  if (j < sp.x || j > sp.y) return;
  const ReadView v = read_view(a, q);
  const int lo = j * WALK_TILE;
  const int hi = lo + WALK_TILE < v.rows ? lo + WALK_TILE : v.rows;
  const int slo = lo >= EMIT_BELOW ? lo - EMIT_BELOW : 0;
  uint8_t* s_tr = smem + w * ROWS * TRACE_ROW;
  int32_t* s_llk = reinterpret_cast<int32_t*>(
                       smem + EMIT_WARPS * ROWS * TRACE_ROW) +
                   w * ROWS;
  stage_rows(v, slo, hi, s_tr, s_llk, lane, 32);
  __pipeline_wait_prior(0);
  __syncwarp();
  if (lane != 0) return;
  const Rows R{s_tr, s_llk, slo};
  const int4 en = a.ent[slot];
  int k = en.y, e = en.z;
  if (en.x == ENT_MAPPED) {
    const int er = hi - 1 - en.y;
    k = R.lk(er) + en.z;
    e = er + a.base - 2 - k;
  }
  const int n0 = en.w;
  const bool first = j == sp.y;
  const int own_from = first ? (n0 & ~3) : ((n0 + 3) & ~3);
  uint8_t* out = v.out;
  const int64_t cap = v.cap;
  unsigned acc = 0;
  if (first && (n0 & 3) != 0 && (n0 >> 2) < cap) acc = out[n0 >> 2];
  auto put = [&](int p, unsigned d) {
    if (p < own_from) return;
    acc |= d << (2 * (p & 3));
    if ((p & 3) == 3) {
      if ((p >> 2) < cap) out[p >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
  };
  bool ended;
  const int s = walk_in(R, v.rows, a.base, lo, k, e, ended, INT_MAX,
                        [&](int i, unsigned d) { put(n0 + i, d); });
  int p = n0 + s;
  const bool owns_last = (p & 3) != 0 && ((p - 1) & ~3) >= own_from;
  if (!ended && owns_last) {  // finish the byte past the tile
    int kc = k, ec = e;
    bool endc;
    const int n1 = p;
    p += walk_in(R, v.rows, a.base, INT_MIN / 2, kc, ec, endc, 4 - (p & 3),
                 [&](int i, unsigned d) { put(n1 + i, d); });
  }
  if (owns_last && (p & 3) != 0 && (p >> 2) < cap)
    out[p >> 2] = static_cast<uint8_t>(acc);
  if (ended) {
    if (a.band_off) {
      a.n_out[v.r] = p;
    } else {
      a.kst[3 * v.r] = k;
      a.kst[3 * v.r + 1] = e;
      a.kst[3 * v.r + 2] = p;
    }
  }
}

}  // namespace

extern "C" {

// The tiled walk of `n_reads` routed reads (`reads`, or every read of a
// window when null) on `stream`: phases (a), (b), (c) as the bits of
// `phases` ask (7: all; the phases apart are for timing).  Unchunked:
// `band_off`, `start_e`, `rk_len`, `n_out` set and `kst` null; a window:
// `kst` set, the others null, `win` rows a read from band `base`.  The
// scratch (`maps`, `start_rec`, `ent`, `span`) and `tile_off` are the
// wrapper's (ops/abea_cuda.py tiled_scratch).  The three shared-memory
// sizes are the wrapper's (ops/abea.py walk_*_smem_bytes); sizes other
// than the kernels' are refused.  Allocates nothing; returns
// cudaGetLastError() after the launches.
int f5c_abea_walk_tiled(const void* trace, const void* llk,
                        const void* band_off, const void* start_e,
                        const void* rk_len, void* kst, void* n_out,
                        const void* byte_off, void* out, const void* reads,
                        const void* tile_off, void* maps, void* start_rec,
                        void* ent, void* span, int base, int win,
                        int n_reads, int n_tiles, int phases, int map_smem,
                        int chase_smem, int emit_smem, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (map_smem != MAP_SMEM || chase_smem != CHASE_SMEM ||
      emit_smem != EMIT_SMEM || (band_off == nullptr) == (kst == nullptr) ||
      (band_off != nullptr && (start_e == nullptr || rk_len == nullptr ||
                               n_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  TiledArgs a;
  a.trace = static_cast<const uint8_t*>(trace);
  a.llk = static_cast<const int32_t*>(llk);
  a.band_off = static_cast<const int64_t*>(band_off);
  a.start_e = static_cast<const int32_t*>(start_e);
  a.rk_len = static_cast<const int32_t*>(rk_len);
  a.kst = static_cast<int32_t*>(kst);
  a.n_out = static_cast<int32_t*>(n_out);
  a.byte_off = static_cast<const int64_t*>(byte_off);
  a.out = static_cast<uint8_t*>(out);
  a.reads = static_cast<const int32_t*>(reads);
  a.tile_off = static_cast<const int32_t*>(tile_off);
  a.maps = static_cast<uint16_t*>(maps);
  a.start_rec = static_cast<int4*>(start_rec);
  a.ent = static_cast<int4*>(ent);
  a.span = static_cast<int2*>(span);
  a.base = base;
  a.win = win;
  a.n_reads = n_reads;
  a.n_tiles = n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_reads > 0) {
    if (phases & 1) {
      walk_maps_kernel<<<n_tiles + n_reads, MAP_ENTRIES, 0, s>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (phases & 2) {
      walk_chase_kernel<<<n_reads, 32, 0, s>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if ((phases & 4) && n_tiles > 0)
      walk_emit_kernel<<<(n_tiles + EMIT_WARPS - 1) / EMIT_WARPS,
                         32 * EMIT_WARPS, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
