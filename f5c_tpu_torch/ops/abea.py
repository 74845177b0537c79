"""ABEA (adaptive banded event alignment): constants, the ragged data
layout shared with the CUDA kernels, and the plain PyTorch version.

Counterpart of ``f5c_tpu/ops/abea_ring.py:abea_align_device_ring``
(contract) and ``f5c_tpu/ops/abea.py:abea_fill`` +
``abea_backtrace_packed`` (the XLA path this plain version is ported
from).  Algorithm reference: align.c:180-559.

Layout, per read i of a batch of B (every offset int64, nothing padded to
a common length):

- events ``ev_pool[ev_off[i] : ev_off[i] + ev_len[i]]`` (f32);
- k-mer ranks ``rk_pool[rk_off[i] : rk_off[i] + rk_len[i]]`` (i32,
  ``rk_len`` = n_kmers).  The kernels take the sequences in their place:
  ``seq_packed`` (u8, 4 bases a byte: ``seq_ranks.pack_seqs``) with read
  i's first base at ``seq_off[i]`` (int64) and the model's k, and rank
  each k-mer where they stage it (K11 fused); their plain version ranks
  the buffer with ``seq_ranks.ranks_from_packed`` and reads those ranks
  at ``rk_off = seq_off`` (``abea_fill_packed_plain``);
- ``params[i]`` = (scale, shift, lp_stay, lp_step, lp_skip, lp_trim) f32;
- bands ``band_off[i] .. band_off[i+1]``, n_bands = n_events + n_kmers + 2.
  Row ``band_off[i] + bi`` of ``trace`` (u8 [n_bands, TRACE_ROW_BYTES])
  holds the directions of band bi's PAD cells, 2 bits a cell (0 =
  step/diag, 1 = stay/up, 2 = skip/left; 0 outside the band).  Cell o
  is k-mer ``llk[band_off[i] + bi] + o``, event ``bi - 2 - llk[...] - o``.
  A row is four 8-byte groups, one for each warp of the fill's 128
  threads: group ``o >> 5`` is two little-endian u32 words, the first
  holding bit 0 and the second bit 1 of the direction of cell o at bit
  ``o & 31`` (what ``__ballot_sync`` over a warp's 32 cells gives).
  ``pack_trace`` / ``unpack_trace`` convert from and to one byte a cell;
  the JAX fill packs its trace to 2 bits too (by quads of bands);
- ``start_e[i]``: the backtrace's first event (-1 when none);
- the walk's 2-bit directions, 4 per byte with the first step in the low
  bits, at ``flat[byte_off[i] : byte_off[i+1]]`` (capacity
  ceil((n_events + n_kmers)/4)), and its length ``n[i]`` -- exactly what
  native ``decode_qc_postalign`` consumes.

The walk has two plain versions with one result: ``abea_walk_plain``,
step by step, and ``abea_walk_tiled_plain``, the three phases of the
tile-parallel walk of csrc/abea_walk_tiled.cu (``walk_tiled_maps``,
``walk_tiled_chase``, ``walk_tiled_emit``; the comment above
MAP_STOP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ABEA_EPSILON_SKIP, ABEA_LP_TRIM_P, ALN_BANDWIDTH
from .seq_ranks import ranks_from_packed

# f5c_tpu/ops/abea.py:40-46
BW = ALN_BANDWIDTH           # 100 active band offsets
PAD = 128                    # cells a band row holds (one CUDA block)
FROM_D, FROM_U, FROM_L = 0, 1, 2
LOG_INV_SQRT_2PI = float(np.float32(-0.918938))
NEG_INF = float("-inf")
HALF = BW // 2
LL_K0 = -1 - HALF            # band 0's lower-left k-mer (-51)
START_OFF = -1 - LL_K0       # band offset of cells (k=-1, e=-1) and (-1, 0)


TRACE_ROW_BYTES = PAD // 4   # a band's trace row: 2 bits a cell


def pack_trace(dirs: torch.Tensor) -> torch.Tensor:
    """Directions u8 [..., PAD] (0, 1 or 2 a cell) -> the packed trace
    rows u8 [..., TRACE_ROW_BYTES] of the layout above: byte
    8w + 4p + j holds bit p of cells 32w + 8j .. 32w + 8j + 7, the first
    in the low bit."""
    lead = dirs.shape[:-1]
    d = dirs.reshape(*lead, 4, 4, 8).to(torch.int32)   # warp, byte, bit
    w = 1 << torch.arange(8, dtype=torch.int32, device=dirs.device)
    planes = torch.stack([((d & 1) * w).sum(-1), ((d >> 1) * w).sum(-1)],
                         dim=-2)                       # warp, plane, byte
    return planes.to(torch.uint8).reshape(*lead, TRACE_ROW_BYTES)


def unpack_trace(rows: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_trace``: u8 [..., PAD] directions."""
    lead = rows.shape[:-1]
    b = rows.reshape(*lead, 4, 2, 4, 1).to(torch.int32)
    bits = (b >> torch.arange(8, dtype=torch.int32, device=rows.device)) & 1
    d = bits[..., 0, :, :] | (bits[..., 1, :, :] << 1)
    return d.to(torch.uint8).reshape(*lead, PAD)


def trace_cell(rows: torch.Tensor, row: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """The direction (int64) of cell ``o`` of row ``row`` of the packed
    trace ``rows`` u8 [n, TRACE_ROW_BYTES], elementwise over ``row`` and
    ``o`` (0 <= o < PAD)."""
    byte = (o >> 5) * 8 + ((o & 31) >> 3)
    bit = o & 7
    lo = (rows[row, byte].long() >> bit) & 1
    hi = (rows[row, byte + 4].long() >> bit) & 1
    return lo | (hi << 1)


# The CUDA kernels stage their inputs in shared memory by tiles of bands
# (csrc/abea_band.cuh, csrc/abea_walk.cuh); the functions below are the
# reach of a tile, from which the wrappers size that memory.
FILL_TILE = 128      # bands per staged tile of the fill kernels
WALK_TILE = 128      # bands per staged tile of the walk kernels


def fill_tile_reach(ll_k: int, ll_e: int, tile: int = FILL_TILE):
    """The k-mers ``[k_lo, k_hi)`` and events ``[e_lo, e_hi)`` that bands
    b .. b+tile-1 of the fill can read, given band b-1's lower-left k-mer
    ``ll_k`` and event ``ll_e``.  Each band moves its lower-left corner by
    one k-mer or one event (Suzuki's rule), so band b+j has
    ll_k <= k_ll <= ll_k + j + 1 and ll_e <= e_ll <= ll_e + j + 1, and its
    cells are (k_ll + o, e_ll - o) for o < BW."""
    return ll_k, ll_k + tile + BW, ll_e - BW + 1, ll_e + tile + 1


def fill_ring_slots(tile: int = FILL_TILE) -> int:
    """Slots of the fill's k-mer and event rings: a power of two that holds
    the reach of the current tile and the next one, so that the next
    tile's inputs load while the current one runs (two tiles' reach:
    2 * tile + BW, from fill_tile_reach)."""
    k_lo, k_hi, _, _ = fill_tile_reach(0, 0, 2 * tile)
    return 1 << (k_hi - k_lo - 1).bit_length()


def fill_smem_bytes(tile: int = FILL_TILE) -> int:
    """Dynamic shared memory of a fill block: the k-mer ring (kms, stdv,
    log-term, pad as float4), the event ring (f32), the best-start
    reduction (PAD x (f32, i32, i32))."""
    return fill_ring_slots(tile) * (16 + 4) + PAD * 12


def walk_tile_reach(top: int, tile: int = WALK_TILE):
    """The bands ``[lo, hi]`` of a walk tile whose top band is ``top``.
    The walk only descends, by one band (a stay or a skip) or two (a
    step), so from a tile's top it leaves the tile at band lo - 1 or
    lo - 2, both in the tile below, whose top is lo - 1."""
    return top - tile + 1, top


def walk_smem_bytes(tile: int = WALK_TILE) -> int:
    """Dynamic shared memory of a walk block: two tiles (double-buffered)
    of packed trace rows (TRACE_ROW_BYTES) and lower-left k-mers (i32)."""
    return 2 * tile * (TRACE_ROW_BYTES + 4)


# The tiled walk (csrc/abea_walk_tiled.cu) cuts a read's trace into tiles
# of WALK_TILE rows from row 0: tile j holds rows [jT, jT + T).  The walk
# only descends, one or two bands a step, so it enters tile j (from the
# tile above) at one of the cells of its top two rows, and where it
# leaves the tile depends on nothing outside it.  Three phases:
# (a) maps: for each entry cell (row hi - 1 - sel, offset o < BW from the
#     row's llk) of every tile below the start's, walk to where the path
#     leaves the tile, and encode that exit as an entry of the tile below
#     (MAP_* below); the start cell gets such a walk of its own;
# (b) the chase: from the start, follow the maps from tile to tile, and
#     record each tile's entry and the steps before it (an exclusive scan);
# (c) emission: re-walk each visited tile from its entry and write its
#     directions at their final position; the tile that holds a byte's
#     first step writes the byte (walking on past its tile to finish it),
#     the walk's first tile also the byte a carried position starts in.
# A path that leaves a tile outside the mapped cells (never on a fill's
# own trace: a finite cell points at a finite one, which lies in its
# band) is chased cell by cell.
MAP_STOP = 1 << 15       # the walk ended in the tile (steps in bits 0-13)
MAP_OFF = 1 << 14        # ... or left it outside the mapped cells
MAP_ENTRIES = 2 * BW     # entry cells of a tile: its top two rows, o < BW
EMIT_BELOW = 6           # rows under a tile that finishing a byte may read
CHASE_GROUP = 32         # tiles' maps a chase stage holds
EMIT_WARPS = 4           # tiles an emission block walks (a warp each)


def walk_map_reach(j: int, tile: int = WALK_TILE):
    """Rows a map block of tile j reads: trace and llk of [lo, hi), and
    the llk of the two rows under it (its exits), so (lo - 2, lo, hi)."""
    return j * tile - 2, j * tile, j * tile + tile


def walk_emit_reach(j: int, tile: int = WALK_TILE):
    """Rows an emission warp of tile j reads, [lo - EMIT_BELOW, hi): a
    byte finished past the tile takes at most 3 steps, 6 rows."""
    return j * tile - EMIT_BELOW, j * tile + tile


def walk_map_smem_bytes(tile: int = WALK_TILE) -> int:
    """Shared memory of a map block: the tile's trace rows and llk, and
    the llk of the two rows under it."""
    return tile * (TRACE_ROW_BYTES + 4) + 2 * 4


def walk_chase_smem_bytes(group: int = CHASE_GROUP) -> int:
    """Shared memory of a chase block: two stages of ``group`` tiles'
    maps (u16 entries)."""
    return 2 * group * MAP_ENTRIES * 2


def walk_emit_smem_bytes(tile: int = WALK_TILE) -> int:
    """Shared memory of an emission block: EMIT_WARPS tiles' rows of
    ``walk_emit_reach``, trace and llk."""
    return EMIT_WARPS * (tile + EMIT_BELOW) * (TRACE_ROW_BYTES + 4)


def walk_tiles_of(rows, tile: int = WALK_TILE):
    """Tiles of reads of ``rows`` rows each: ceil(rows / tile)."""
    return -(-rows // tile)


def _walk_in(tr, lk, row0, rows, base, lo, k, e, active, limit, record=None):
    """Lockstep walk of many cells, each of its read (``row0`` its row 0,
    ``rows`` its rows): from (k, e) while ``active``, the walk goes on
    (k >= 0, e >= 0, v = e + k + 2 - base >= 0) and its row min(v,
    rows - 1) >= ``lo``, at most ``limit`` steps (each, or None).  Returns
    (k, e, steps, ended); ``record(s, live, d)`` sees each step."""
    steps = torch.zeros_like(k)
    s = 0
    while True:
        v = e + k + 2 - base
        walking = (k >= 0) & (e >= 0) & (v >= 0)
        live = active & walking & (torch.minimum(v, rows - 1) >= lo)
        if limit is not None:
            live &= steps < limit
        if not bool(live.any()):
            return k, e, steps, active & ~walking
        r = row0 + torch.minimum(v, rows - 1).clamp(min=0)
        o = (k - lk[r].long()).clamp(0, PAD - 1)
        d = torch.where(live, trace_cell(tr, r, o), 0)
        if record is not None:
            record(s, live, d)
        k = k - (live & (d != FROM_U)).long()
        e = e - (live & (d != FROM_L)).long()
        steps = steps + live.long()
        s += 1


def _exit_code(lk, row0, base, lo, k, e, steps, ended):
    """The MAP_* code of walks that left their tile (whose low row is
    ``lo``) at (k, e), or ended there."""
    rr = e + k + 2 - base                      # lo - 1 or lo - 2
    o = k - lk[(row0 + rr).clamp(0, lk.shape[0] - 1)].long()
    on = ~ended & (o >= 0) & (o < BW)
    cont = o.clamp(0, 127) | ((lo - 1 - rr).clamp(0, 1) << 7) \
        | ((steps - 1).clamp(min=0) << 8)
    stop = MAP_STOP | torch.where(ended, 0, MAP_OFF) | steps
    return torch.where(on, cont, stop)


def _walk_start_cell(view):
    """Each read's first cell, its start tile j_s (-1: no walk)."""
    k, e = view["k0"], view["e0"]
    v = e + k + 2 - view["base"]
    walking = (k >= 0) & (e >= 0) & (v >= 0)
    js = torch.minimum(v, view["rows"] - 1) // view["tile"]
    return torch.where(walking, js, -1)


def walk_tiled_maps(tr, lk, view):
    """Phase (a): the map of every tile below its read's start tile,
    int32 [n_tiles, 2, BW] (0 elsewhere), and the start walks' records
    int64 [R, 2] (code, steps)."""
    T, base = view["tile"], view["base"]
    dev = lk.device
    tile_off = view["tile_off"]
    R = tile_off.shape[0] - 1
    n_tiles = int(tile_off[-1]) if R else 0
    maps = torch.zeros((n_tiles, 2, BW), dtype=torch.int32, device=dev)
    js = _walk_start_cell(view)
    q = torch.repeat_interleave(torch.arange(R, device=dev),
                                tile_off[1:] - tile_off[:-1])
    j = torch.arange(n_tiles, device=dev) - tile_off[:-1][q]
    need = j < js[q]
    tq, tj = q[need], j[need]
    if tq.numel():
        sel = torch.arange(2, device=dev).repeat_interleave(BW)
        o = torch.arange(BW, device=dev).repeat(2)
        qq = tq[:, None].expand(-1, MAP_ENTRIES)
        lo = (tj * T)[:, None].expand(-1, MAP_ENTRIES)
        r0 = view["row0"][qq]
        rows = view["rows"][qq]
        er = lo + T - 1 - sel
        k = lk[r0 + er].long() + o
        e = er + base - 2 - k
        k, e, steps, ended = _walk_in(tr, lk, r0, rows, base, lo, k, e,
                                      torch.ones_like(k, dtype=torch.bool),
                                      None)
        code = _exit_code(lk, r0, base, lo, k, e, steps, ended)
        maps[need] = code.reshape(-1, 2, BW).to(torch.int32)
    # the start walks: from each read's first cell out of its start tile
    k, e = view["k0"].clone(), view["e0"].clone()
    lo = js.clamp(min=0) * T
    k, e, steps, ended = _walk_in(tr, lk, view["row0"], view["rows"], base,
                                  lo, k, e, js >= 0, None)
    # the code without its step fields, the steps apart: with the
    # last-row clamp a start walk may take more steps than a tile has rows
    code = _exit_code(lk, view["row0"], base, lo, k, e, torch.ones_like(k),
                      ended | (js < 0))
    code = torch.where((code & MAP_STOP) != 0, code & ~0x3fff, code)
    start = torch.stack([code, steps], dim=1)
    return maps, start


def _walk_one(tr, lk, row0, rows, base, lo, k, e):
    """One cell's walk out of a tile (the chase's cell-by-cell path):
    (k, e, steps, ended) as Python ints."""
    t = torch.tensor
    dev = lk.device
    out = _walk_in(tr, lk, t([row0], device=dev), t([rows], device=dev),
                   base, lo, t([k], device=dev), t([e], device=dev),
                   t([True], device=dev), None)
    return tuple(int(x[0]) for x in out)


ENT_MAPPED, ENT_EXACT = 1, 2


def map_steps(code: int) -> int:
    """The steps of a tile map's entry."""
    return code & 0x3fff if code & MAP_STOP else (code >> 8) + 1


def walk_tiled_chase(tr, lk, view, maps, start):
    """Phase (b): from each read's start, follow the maps from tile to
    tile.  Returns the entries int64 [n_tiles, 4] (kind, a, b, n): kind
    ENT_MAPPED (a, b) = (sel, o), ENT_EXACT (a, b) = (k, e), n the steps
    before the tile (rows of tiles not visited: 0), and the spans int64
    [R, 2] (j_end, j_s) of the visited tiles (j_end > j_s: no walk)."""
    T, base = view["tile"], view["base"]
    tile_off = view["tile_off"].tolist()
    R = len(tile_off) - 1
    ent = [[0, 0, 0, 0] for _ in range(tile_off[-1] if R else 0)]
    span = []
    js_all = _walk_start_cell(view).tolist()
    mp = maps.reshape(-1, MAP_ENTRIES).tolist()
    st = start.tolist()
    row0s, rowss = view["row0"].tolist(), view["rows"].tolist()
    k0s, e0s, n0s = (view[x].tolist() for x in ("k0", "e0", "n0"))
    llk = lk.tolist()
    for q in range(R):
        js, t0, row0 = js_all[q], tile_off[q], row0s[q]
        if js < 0:
            span.append([1, 0])
            continue
        j, k, e, n = js, k0s[q], e0s[q], n0s[q]
        ent[t0 + j] = [ENT_EXACT, k, e, n]
        code, steps = st[q]           # the start tile's exit, walked in (a)
        while True:
            if code is not None:
                if not code & MAP_STOP:
                    n += steps
                    sel, o = (code >> 7) & 1, code & 127
                    j -= 1
                    ent[t0 + j] = [ENT_MAPPED, sel, o, n]
                    code = mp[t0 + j][sel * BW + o]
                    steps = map_steps(code)
                    continue
                if not code & MAP_OFF:
                    n += steps
                    break
                if ent[t0 + j][0] == ENT_MAPPED:   # its cell, exactly
                    er = j * T + T - 1 - sel
                    k = llk[row0 + er] + o
                    e = er + base - 2 - k
            # cell by cell out of tile j
            k, e, s, ended = _walk_one(tr, lk, row0, rowss[q], base, j * T,
                                       k, e)
            n += s
            if ended:
                break
            er = e + k + 2 - base
            o, sel = k - llk[row0 + er], j * T - 1 - er
            j -= 1
            if 0 <= o < BW:
                ent[t0 + j] = [ENT_MAPPED, sel, o, n]
                code = mp[t0 + j][sel * BW + o]
                steps = map_steps(code)
            else:
                ent[t0 + j] = [ENT_EXACT, k, e, n]
                code = None
        span.append([j, js])
    return (torch.tensor(ent, dtype=torch.int64).reshape(-1, 4),
            torch.tensor(span, dtype=torch.int64).reshape(-1, 2))


def walk_tiled_emit(tr, lk, view, ent, span, flat):
    """Phase (c): re-walk each visited tile from its entry and write its
    directions into ``flat`` (a copy) by the owner rule above.  Returns
    (flat', k, e, n) with each read's final cell and length (the start's
    where it does not walk)."""
    T, base = view["tile"], view["base"]
    dev = lk.device
    tile_off = view["tile_off"]
    R = tile_off.shape[0] - 1
    n_tiles = ent.shape[0]
    flat = flat.clone()
    kf, ef, nf = view["k0"].clone(), view["e0"].clone(), view["n0"].clone()
    q = torch.repeat_interleave(torch.arange(R, device=dev),
                                tile_off[1:] - tile_off[:-1])
    j = torch.arange(n_tiles, device=dev) - tile_off[:-1][q]
    span = span.to(dev)
    vis = (j >= span[q, 0]) & (j <= span[q, 1])
    if not bool(vis.any()):
        return flat, kf, ef, nf
    ent = ent.to(dev)[vis]
    q, j = q[vis], j[vis]
    row0, rows = view["row0"][q], view["rows"][q]
    lo = j * T
    er = lo + T - 1 - ent[:, 1]
    mapped = ent[:, 0] == ENT_MAPPED
    km = lk[(row0 + er).clamp(max=lk.shape[0] - 1)].long() + ent[:, 2]
    k = torch.where(mapped, km, ent[:, 1])
    e = torch.where(mapped, er + base - 2 - km, ent[:, 2])
    n0 = ent[:, 3]
    first = j == span[q, 1]
    own_from = torch.where(first, n0 & ~3, (n0 + 3) & ~3)
    cap, b0 = view["cap"][q], view["out_off"][q]
    pos_l, bits_l = [], []

    def recorder(pos0):
        """Keeps step s's bits at position pos0 + s where the tile owns
        the byte (and it lies below cap)."""
        def record(s, live, d):
            pos = pos0 + s
            use = live & (pos >= own_from) & ((pos >> 2) < cap)
            pos_l.append((b0 + (pos >> 2))[use])
            bits_l.append((d << (2 * (pos & 3)))[use])
        return record

    on = torch.ones_like(k, dtype=torch.bool)
    k, e, steps, ended = _walk_in(tr, lk, row0, rows, base, lo, k, e, on,
                                  None, recorder(n0))
    n1 = n0 + steps
    # finish the last byte begun in the tile: up to 3 steps past it
    more = ~ended & ((n1 & 3) != 0) & (((n1 - 1) & ~3) >= own_from)
    _walk_in(tr, lk, row0, rows, base, torch.full_like(lo, -(1 << 40)), k,
             e, more, (4 - (n1 & 3)) & 3, recorder(n1))
    acc = torch.zeros(flat.shape[0], dtype=torch.int64, device=dev)
    acc.index_add_(0, torch.cat(pos_l), torch.cat(bits_l))
    # the bytes each tile owns: [own_from / 4, (n1 - 1) / 4]
    first_b = own_from >> 2
    cnt = torch.where(n1 > own_from, ((n1 - 1) >> 2) - first_b + 1, 0)
    cnt = torch.minimum(cnt, (cap - first_b).clamp(min=0))
    tid = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev),
                                  cnt)
    b = first_b[tid] + torch.arange(tid.shape[0], device=dev) \
        - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    g = b0[tid] + b
    keep = first[tid] & (b == (n0[tid] >> 2)) & ((n0[tid] & 3) != 0)
    old = torch.where(keep, flat[g].long(), 0)
    flat[g] = (acc[g] | old).to(torch.uint8)
    # the final cell, from the tile where the walk ends
    kf[q[ended]], ef[q[ended]], nf[q[ended]] = k[ended], e[ended], n1[ended]
    return flat, kf, ef, nf


def walk_tiled_plain(tr, lk, view, flat):
    """The three phases on ``view`` (see ``tiled_view``): (flat', k, e, n)."""
    maps, start = walk_tiled_maps(tr, lk, view)
    ent, span = walk_tiled_chase(tr, lk, view, maps, start)
    return walk_tiled_emit(tr, lk, view, ent, span, flat)


def tiled_view(row0, rows, base, k0, e0, n0, out_off, cap,
               tile: int = WALK_TILE) -> dict:
    """The reads of a tiled walk (int64 tensors [R]): row 0 of each in the
    trace, its rows, its first cell (k0, e0, n0) and its output (``flat``
    at ``out_off``, ``cap`` bytes); tile q's first slot in ``tile_off``."""
    if not 2 <= tile <= 128:
        raise ValueError(f"tile {tile} outside 2..128 (the map's fields)")
    t = walk_tiles_of(rows, tile)
    tile_off = torch.zeros(rows.shape[0] + 1, dtype=torch.int64,
                           device=rows.device)
    torch.cumsum(t, 0, out=tile_off[1:])
    return dict(row0=row0, rows=rows, base=base, k0=k0, e0=e0, n0=n0,
                out_off=out_off, cap=cap, tile=tile, tile_off=tile_off)


def abea_walk_tiled_plain(trace, llk, band_off, start_e, rk_len, byte_off,
                          tile: int = WALK_TILE):
    """The tiled walk (the plain version of csrc/abea_walk_tiled.cu) with
    the contract of ``abea_walk_plain``: (flat packed dirs u8
    [byte_off[-1]], n i32 [B])."""
    dev = trace.device
    ok = start_e >= 0
    band_off, byte_off = band_off.long(), byte_off.long()
    view = tiled_view(band_off[:-1], band_off[1:] - band_off[:-1], 0,
                      torch.where(ok, rk_len.long() - 1, -1),
                      torch.where(ok, start_e.long(), -1),
                      torch.zeros_like(band_off[:-1]), byte_off[:-1],
                      byte_off[1:] - byte_off[:-1], tile)
    flat = torch.zeros(int(byte_off[-1]), dtype=torch.uint8, device=dev)
    flat, _, _, n = walk_tiled_plain(trace, llk, view, flat)
    return flat, n.to(torch.int32)


def read_params(ev_len: np.ndarray, rk_len: np.ndarray, scale: np.ndarray,
                shift: np.ndarray) -> np.ndarray:
    """Per-read f32 [B, 6] (scale, shift, lp_stay, lp_step, lp_skip,
    lp_trim), computed as the JAX runner does
    (runner.py:_abea_group_meta)."""
    epk = ev_len.astype(np.float64) / rk_len.astype(np.float64)
    p_stay = 1.0 - 1.0 / (epk + 1.0)
    out = np.empty((ev_len.shape[0], 6), np.float32)
    out[:, 0] = scale
    out[:, 1] = shift
    out[:, 2] = np.log(p_stay)
    out[:, 3] = np.log(1.0 - ABEA_EPSILON_SKIP - p_stay)
    out[:, 4] = np.log(ABEA_EPSILON_SKIP)
    out[:, 5] = np.log(ABEA_LP_TRIM_P)
    return out


def ragged_offsets(lengths: np.ndarray) -> np.ndarray:
    """int64 [B+1] exclusive prefix sum."""
    off = np.zeros(lengths.shape[0] + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    return off


def band_offsets(ev_len: np.ndarray, rk_len: np.ndarray) -> np.ndarray:
    return ragged_offsets(ev_len.astype(np.int64) + rk_len + 2)


def byte_offsets(ev_len: np.ndarray, rk_len: np.ndarray) -> np.ndarray:
    return ragged_offsets((ev_len.astype(np.int64) + rk_len + 3) // 4)


def _shift(row: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[b, o] = row[b, o + s[b]] for s in {-1, 0, 1}; -inf outside."""
    B = row.shape[0]
    ninf = row.new_full((B, 1), NEG_INF)
    padded = torch.cat([ninf, row, ninf], dim=1)
    idx = torch.arange(PAD, device=row.device) + 1 + s[:, None]
    return padded.gather(1, idx)


class _Band:
    """The band recurrence for a batch of reads: the per-read inputs and
    one band step.  Shared by the unchunked fill below and the windowed
    fill of ops/abea_ultra.py, as csrc/abea_band.cuh is by their kernels.
    """

    def __init__(self, ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                 level_mean, level_stdv, level_log_stdv, params, band_off):
        dev = ev_pool.device
        self.ev_pool, self.ev_off = ev_pool, ev_off
        self.rk_pool, self.rk_off = rk_pool, rk_off
        self.tables = (level_mean, level_stdv, level_log_stdv)
        self.ne = ev_len.long()
        self.nk = rk_len.long()
        self.nb = band_off[1:] - band_off[:-1]
        self.offs = torch.arange(PAD, device=dev)
        (self.scale, self.shift, self.lp_stay, self.lp_step, self.lp_skip,
         self.lp_trim) = (params[:, j:j + 1] for j in range(6))
        self.ninf = torch.tensor(NEG_INF, device=dev)

    def step(self, bi: int, prev, prev2, ll_k, k2, ll_e, best_s, best_e):
        """Band ``bi`` of every read from bands bi-1 (``prev``, lower-left
        k-mer ``ll_k`` and event ``ll_e``) and bi-2 (``prev2``, ``k2``).
        Returns (row, frm, ll_k, ll_e, best_s, best_e) of band bi; the
        backtrace start only moves for reads with bi < n_bands."""
        ne, nk, offs, ninf = self.ne, self.nk, self.offs, self.ninf
        level_mean, level_stdv, level_log_stdv = self.tables
        n_model = level_mean.shape[0]
        # Suzuki's rule from the previous band's edge cells
        ll, ur = prev[:, 0], prev[:, BW - 1]
        both_ob = torch.isneginf(ll) & torch.isneginf(ur)
        right = torch.where(both_ob, torch.full_like(both_ob, bi % 2 == 1),
                            ll < ur)
        r_i = right.long()
        ll_k = ll_k + r_i
        ll_e = ll_e + (1 - r_i)

        ev_idx = ll_e[:, None] - offs
        km_idx = ll_k[:, None] + offs
        valid = ((km_idx >= 0) & (km_idx < nk[:, None]) & (ev_idx >= 0)
                 & (ev_idx < ne[:, None]) & (offs < BW))
        ev = self.ev_pool[self.ev_off[:, None]
                          + torch.minimum(ev_idx.clamp(min=0),
                                          ne[:, None] - 1)]
        rank = self.rk_pool[self.rk_off[:, None]
                            + torch.minimum(km_idx.clamp(min=0),
                                            nk[:, None] - 1)]
        rank = rank.long().clamp(0, n_model - 1)
        kms = self.scale * level_mean[rank] + self.shift
        a = (ev - kms) / level_stdv[rank]
        em = (LOG_INV_SQRT_2PI - level_log_stdv[rank]) + (-0.5 * a) * a

        up = _shift(prev, r_i)               # (k, e-1) in band bi-1
        left = _shift(prev, r_i - 1)         # (k-1, e) in band bi-1
        diag = _shift(prev2, ll_k - k2 - 1)  # (k-1, e-1) in band bi-2
        score_d = (diag + self.lp_step) + em
        score_u = (up + self.lp_stay) + em
        score_l = left + self.lp_skip
        max_s = torch.maximum(score_d, score_u)
        frm = torch.where(max_s == score_u, FROM_U, FROM_D)
        max_s = torch.maximum(max_s, score_l)
        frm = torch.where(max_s == score_l, FROM_L, frm)
        row = torch.where(valid, max_s, ninf)
        frm = torch.where(valid, frm, 0)

        # trim column: cell (k=-1, e=bi-1) while the band straddles it
        trim_off = -1 - ll_k
        trim_ev = ll_e - trim_off
        trim_ok = ((trim_off >= 0) & (trim_off < BW) & (trim_ev >= 0)
                   & (trim_ev < ne))
        is_trim = (offs == trim_off[:, None]) & trim_ok[:, None]
        row = torch.where(is_trim,
                          self.lp_trim * (trim_ev + 1).float()[:, None], row)
        frm = torch.where(is_trim, FROM_U, frm)

        # backtrace start: first best of last-k-mer cell + trim tail
        off_lc = (nk - 1) - ll_k
        e_lc = ll_e - off_lc
        lcv = row.gather(1, off_lc.clamp(0, PAD - 1)[:, None])[:, 0]
        cand = lcv + (ne - e_lc).float() * self.lp_trim[:, 0]
        okc = ((off_lc >= 0) & (off_lc < BW) & (e_lc >= 0) & (e_lc < ne)
               & (bi < self.nb))
        cand = torch.where(okc, cand, ninf)
        upd = cand > best_s
        best_s = torch.where(upd, cand, best_s)
        best_e = torch.where(upd, e_lc, best_e)
        return row, frm, ll_k, ll_e, best_s, best_e


def abea_fill_plain(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                    level_mean, level_stdv, level_log_stdv, params,
                    band_off):
    """Band fill for every read, batched: a Python loop over bands.
    Returns (trace u8 [n_bands_total, TRACE_ROW_BYTES], packed, llk i32
    [n_bands_total], start_e i32 [B])."""
    dev = ev_pool.device
    B = ev_len.shape[0]
    band = _Band(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                 level_mean, level_stdv, level_log_stdv, params, band_off)
    nb = band.nb
    NB = int(nb.max()) if B else 0

    band0 = torch.full((B, PAD), NEG_INF, device=dev)
    band0[:, START_OFF] = 0.0
    band1 = torch.full((B, PAD), NEG_INF, device=dev)
    band1[:, START_OFF] = params[:, 5]
    trace = torch.zeros((B, max(NB, 2), PAD), dtype=torch.uint8, device=dev)
    trace[:, 1, START_OFF] = FROM_U
    llk = torch.full((B, max(NB, 2)), LL_K0, dtype=torch.int64, device=dev)

    prev2, prev = band0, band1
    k2 = torch.full((B,), LL_K0, dtype=torch.int64, device=dev)  # band bi-2
    ll_k = k2.clone()                                             # band bi-1
    ll_e = torch.full((B,), HALF, dtype=torch.int64, device=dev)
    best_s = torch.full((B,), NEG_INF, device=dev)
    best_e = torch.full((B,), -1, dtype=torch.int64, device=dev)

    for bi in range(2, NB):
        row, frm, ll_k_new, ll_e, best_s, best_e = band.step(
            bi, prev, prev2, ll_k, k2, ll_e, best_s, best_e)
        trace[:, bi] = frm.to(torch.uint8)
        llk[:, bi] = ll_k_new
        prev2, prev = prev, row
        k2, ll_k = ll_k, ll_k_new

    keep = torch.arange(trace.shape[1], device=dev)[None, :] < nb[:, None]
    return (pack_trace(trace[keep]), llk[keep].to(torch.int32),
            best_e.to(torch.int32))


def abea_fill_packed_plain(ev_pool, ev_off, ev_len, seq_packed, seq_off,
                           rk_len, k: int, level_mean, level_stdv,
                           level_log_stdv, params, band_off):
    """The plain version of the fill kernel, which ranks the packed
    sequences itself: ``ranks_from_packed`` (K11's plain version), then
    ``abea_fill_plain`` on those ranks at ``seq_off``."""
    return abea_fill_plain(ev_pool, ev_off, ev_len,
                           ranks_from_packed(seq_packed, k), seq_off, rk_len,
                           level_mean, level_stdv, level_log_stdv, params,
                           band_off)


def abea_walk_plain(trace, llk, band_off, start_e, rk_len, byte_off):
    """Backtrace walk from (n_kmers-1, start_e) while k >= 0 and e >= 0
    over the packed ``trace`` [n_bands, TRACE_ROW_BYTES], batched over
    reads; returns (flat packed dirs u8 [byte_off[-1]], n i32 [B])."""
    dev = trace.device
    B = start_e.shape[0]
    nk = rk_len.long()
    nb = band_off[1:] - band_off[:-1]
    cap = byte_off[1:] - byte_off[:-1]
    steps = 4 * int(cap.max()) if B else 0
    ok = start_e >= 0
    k = torch.where(ok, nk - 1, -1)
    e = torch.where(ok, start_e.long(), -1)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    dirs = torch.zeros((B, steps), dtype=torch.int64, device=dev)
    b0 = band_off[:-1]
    for s in range(steps):
        active = (k >= 0) & (e >= 0)
        bi = torch.minimum((e + k + 2).clamp(min=0), nb - 1)
        o = (k - llk[b0 + bi].long()).clamp(0, PAD - 1)
        f = trace_cell(trace, b0 + bi, o)
        f = torch.where(active, f, 0)
        dirs[:, s] = f
        k = k - (active & (f != FROM_U)).long()
        e = e - (active & (f != FROM_L)).long()
        n = n + active.long()
    d4 = dirs.reshape(B, -1, 4)
    packed = (d4[..., 0] | (d4[..., 1] << 2) | (d4[..., 2] << 4)
              | (d4[..., 3] << 6)).to(torch.uint8)
    keep = (torch.arange(packed.shape[1], device=dev)[None, :]
            < cap[:, None])
    return packed[keep], n.to(torch.int32)
