// The ABEA backtrace walk shared by the unchunked walk (abea.cu) and the
// walk across one window of ultra-long reads (abea_ultra.cu), so that the
// two kernels cannot drift apart.  The plain PyTorch versions are
// f5c_tpu_torch/ops/abea.py:abea_walk_plain and
// ops/abea_ultra.py:walk_window_plain.
//
// One warp walks one read.  What bounds a walk is its chain of dependent
// steps: a step reads the band's lower-left k-mer, then the trace byte it
// locates, and the next step's band depends on that byte.  From global
// memory that is two round trips a step.  The walk only descends -- from
// band bi to bi-1 (a stay or a skip) or bi-2 (a step) -- so the rows it
// needs are known ahead: the warp stages them by tiles of WALK_TILE bands
// (WALK_TILE x 128 contiguous trace bytes plus WALK_TILE llk words) into a
// double-buffered ring in shared memory with cp.async, 16 bytes a lane,
// and walks the resident tile while the one below it lands.  A step is
// then two dependent shared-memory loads.  Every lane walks (the same
// addresses: a broadcast, no divergence); lane 0 stores the output.
// Tile t covers bands [top - (t+1)T + 1, top - tT] below the start band
// top (ops/abea.py walk_tile_reach): a step of at most two bands leaves a
// tile into the one below it.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "abea_band.cuh"

namespace f5c_abea {

constexpr int WALK_TILE = 128;
constexpr int WALK_SMEM = 2 * WALK_TILE * (PAD + 4);

// Queues the copy of rows [lo, lo + WALK_TILE) (those >= 0) of `tr` and
// `llk` into buffer `buf`, and commits it as one group (possibly empty).
__device__ __forceinline__ void stage_walk_tile(
    const uint8_t* tr, const int32_t* llk, int lo, uint8_t* s_tr,
    int32_t* s_llk, int lane) {
  const int r0 = lo < 0 ? 0 : lo;
  const int hi = lo + WALK_TILE;  // exclusive
  if (r0 < hi) {
    const int chunks = (hi - r0) * (PAD / 16);
    const uint8_t* src = tr + static_cast<int64_t>(r0) * PAD;
    uint8_t* dst = s_tr + (r0 - lo) * PAD;
    for (int c = lane; c < chunks; c += 32)
      __pipeline_memcpy_async(dst + 16 * c, src + 16 * c, 16);
    for (int r = r0 + lane; r < hi; r += 32)
      __pipeline_memcpy_async(s_llk + (r - lo), llk + r, 4);
  }
  __pipeline_commit();
}

// Walks the rows of `tr` / `llk` (row j = band base + j, `rows` of them;
// a band past the last row reads the last row) from (k, e) while k >= 0,
// e >= 0 and e + k + 2 >= base, writing direction n to bits 2(n%4) of
// dst[n/4] (bytes below `cap`).  A walk that starts with n % 4 != 0
// continues the byte the previous window's walk left partly written.
// Updates k, e, n in every lane.  `smem` is WALK_SMEM bytes.
__device__ __forceinline__ void walk_tiles(const uint8_t* tr,
                                           const int32_t* llk, int rows,
                                           int base, int& k, int& e, int& n,
                                           uint8_t* dst, int64_t cap,
                                           unsigned char* smem, int lane) {
  uint8_t* s_tr = smem;
  int32_t* s_llk =
      reinterpret_cast<int32_t*>(smem + 2 * WALK_TILE * PAD);
  unsigned acc = ((n & 3) != 0 && (n >> 2) < cap) ? dst[n >> 2] : 0u;
  if (k >= 0 && e >= 0 && e + k + 2 >= base) {
    int top = e + k + 2 - base;
    top = top >= rows ? rows - 1 : top;
    stage_walk_tile(tr, llk, top - WALK_TILE + 1, s_tr, s_llk, lane);
    stage_walk_tile(tr, llk, top - 2 * WALK_TILE + 1, s_tr + WALK_TILE * PAD,
                    s_llk + WALK_TILE, lane);
    for (int t = 0;; ++t) {
      const int buf = t & 1;
      const int lo = top - (t + 1) * WALK_TILE + 1;
      const uint8_t* b_tr = s_tr + buf * WALK_TILE * PAD;
      const int32_t* b_llk = s_llk + buf * WALK_TILE;
      __pipeline_wait_prior(1);  // tile t has landed (this lane's copies)
      __syncwarp();              // and every lane's
      bool walking = true;
      for (;;) {
        walking = k >= 0 && e >= 0 && e + k + 2 >= base;
        if (!walking) break;
        int r = e + k + 2 - base;
        r = r >= rows ? rows - 1 : r;
        if (r < lo) break;  // into the tile below
        int o = k - b_llk[r - lo];
        o = o < 0 ? 0 : (o >= PAD ? PAD - 1 : o);
        const int f = b_tr[(r - lo) * PAD + o];
        acc |= static_cast<unsigned>(f) << (2 * (n & 3));
        if ((n & 3) == 3) {
          if (lane == 0 && (n >> 2) < cap)
            dst[n >> 2] = static_cast<uint8_t>(acc);
          acc = 0;
        }
        k -= (f != FROM_U);
        e -= (f != FROM_L);
        ++n;
      }
      if (!walking) break;
      __syncwarp();  // every lane is done with this buffer
      stage_walk_tile(tr, llk, top - (t + 3) * WALK_TILE + 1,
                      s_tr + buf * WALK_TILE * PAD, s_llk + buf * WALK_TILE,
                      lane);
    }
    __pipeline_wait_prior(0);  // no copy outlives the block
  }
  if (lane == 0 && (n & 3) != 0 && (n >> 2) < cap)
    dst[n >> 2] = static_cast<uint8_t>(acc);
}

}  // namespace f5c_abea
