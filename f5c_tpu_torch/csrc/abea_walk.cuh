// The ABEA backtrace walk shared by the unchunked walk (abea.cu) and the
// walk across one window of ultra-long reads (abea_ultra.cu), so that the
// two kernels cannot drift apart.  The plain PyTorch versions are
// f5c_tpu_torch/ops/abea.py:abea_walk_plain and
// ops/abea_ultra.py:walk_window_plain.
//
// One warp walks one read.  What bounds a walk is its chain of dependent
// steps: a step reads the band's lower-left k-mer, then the trace cell it
// locates, and the next step's band depends on that cell.  From global
// memory that is two round trips a step.  The walk only descends -- from
// band bi to bi-1 (a stay or a skip) or bi-2 (a step) -- so the rows it
// needs are known ahead: the warp stages them by tiles of WALK_TILE bands
// (WALK_TILE x TRACE_ROW contiguous bytes of the 2-bit trace plus
// WALK_TILE llk words) into a double-buffered ring in shared memory with
// cp.async, 16 bytes a lane, and walks the resident tile while the one
// below it lands.  The step's band is one or two below the current one,
// so the llk words of both are loaded beside the current cell's trace
// bytes and the step picks one when its direction is known: a step is
// then one dependent shared-memory load, the 8 bytes of the row that
// hold the cell's two bits (the 2-bit trace makes the bit extraction a
// longer chain than a byte load; without the llk loads taken off the
// chain the walk was 6-8 % slower than with one byte a cell, with them it
// is 12-13 % faster, on an H100; PERF.md).  Every lane walks (the same addresses: a
// broadcast, no divergence); lane 0 stores the output.
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
constexpr int WALK_SMEM = 2 * WALK_TILE * (TRACE_ROW + 4);

// Queues the copy of rows [lo, lo + WALK_TILE) (those >= 0) of `tr` and
// `llk` into buffer `buf`, and commits it as one group (possibly empty).
__device__ __forceinline__ void stage_walk_tile(
    const uint8_t* tr, const int32_t* llk, int lo, uint8_t* s_tr,
    int32_t* s_llk, int lane) {
  const int r0 = lo < 0 ? 0 : lo;
  const int hi = lo + WALK_TILE;  // exclusive
  if (r0 < hi) {
    const int chunks = (hi - r0) * (TRACE_ROW / 16);
    const uint8_t* src = tr + static_cast<int64_t>(r0) * TRACE_ROW;
    uint8_t* dst = s_tr + (r0 - lo) * TRACE_ROW;
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
      reinterpret_cast<int32_t*>(smem + 2 * WALK_TILE * TRACE_ROW);
  unsigned acc = ((n & 3) != 0 && (n >> 2) < cap) ? dst[n >> 2] : 0u;
  if (k >= 0 && e >= 0 && e + k + 2 >= base) {
    int top = e + k + 2 - base;
    top = top >= rows ? rows - 1 : top;
    stage_walk_tile(tr, llk, top - WALK_TILE + 1, s_tr, s_llk, lane);
    stage_walk_tile(tr, llk, top - 2 * WALK_TILE + 1,
                    s_tr + WALK_TILE * TRACE_ROW, s_llk + WALK_TILE, lane);
    for (int t = 0;; ++t) {
      const int buf = t & 1;
      const int lo = top - (t + 1) * WALK_TILE + 1;
      const uint8_t* b_tr = s_tr + buf * WALK_TILE * TRACE_ROW;
      const int32_t* b_llk = s_llk + buf * WALK_TILE;
      __pipeline_wait_prior(1);  // tile t has landed (this lane's copies)
      __syncwarp();              // and every lane's
      bool walking = k >= 0 && e >= 0 && e + k + 2 >= base;
      int r = e + k + 2 - base;
      r = r >= rows ? rows - 1 : r;
      if (walking && r >= lo) {
        int lk = b_llk[r - lo];
        for (;;) {
          // the llk of both rows the step may go to, loaded beside the
          // cell (below the tile: never used, the step leaves the tile;
          // still inside `smem`)
          const int l1 = b_llk[r - 1 - lo], l2 = b_llk[r - 2 - lo];
          int o = k - lk;
          o = o < 0 ? 0 : (o >= PAD ? PAD - 1 : o);
          const uint2 w = reinterpret_cast<const uint2*>(
              b_tr + (r - lo) * TRACE_ROW)[o >> 5];
          const unsigned up = (w.x >> (o & 31)) & 1u;    // FROM_U
          const unsigned left = (w.y >> (o & 31)) & 1u;  // FROM_L
          acc |= (up | (left << 1)) << (2 * (n & 3));
          if ((n & 3) == 3) {
            if (lane == 0 && (n >> 2) < cap)
              dst[n >> 2] = static_cast<uint8_t>(acc);
            acc = 0;
          }
          k -= 1 - static_cast<int>(up);
          e -= 1 - static_cast<int>(left);
          ++n;
          walking = k >= 0 && e >= 0 && e + k + 2 >= base;
          if (!walking) break;
          int rn = e + k + 2 - base;
          rn = rn >= rows ? rows - 1 : rn;
          // rn is r - 1, r - 2, or r where a band past the last row reads
          // the last row
          lk = rn == r - 1 ? l1 : (rn == r - 2 ? l2 : lk);
          r = rn;
          if (r < lo) break;  // into the tile below
        }
      }
      if (!walking) break;
      __syncwarp();  // every lane is done with this buffer
      stage_walk_tile(tr, llk, top - (t + 3) * WALK_TILE + 1,
                      s_tr + buf * WALK_TILE * TRACE_ROW,
                      s_llk + buf * WALK_TILE, lane);
    }
    __pipeline_wait_prior(0);  // no copy outlives the block
  }
  if (lane == 0 && (n & 3) != 0 && (n >> 2) < cap)
    dst[n >> 2] = static_cast<uint8_t>(acc);
}

}  // namespace f5c_abea
