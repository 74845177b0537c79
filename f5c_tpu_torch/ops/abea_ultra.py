"""ABEA for ultra-long reads: the band fill over windows of bands with a
carried state, the backtrace walk across one window, and the function that
pairs them.  The plain PyTorch versions of the kernels of
``csrc/abea_ultra.cu``.

Counterpart of ``f5c_tpu/ops/abea_ultra.py`` (``fill_window``,
``walk_window``, ``align_ultra_read``).  The unchunked fill stores a
read's whole trace, n_bands x TRACE_ROW_BYTES (2 bits a band cell, 32 B
a band) plus a 4-byte lower-left k-mer a band; here a read's trace is
rebuilt one window of ``win`` bands at a time, so device memory is
O(win) per read, at the cost of a second fill:

- forward: one fill over the whole read with no trace, writing the state
  at the end of every window (a checkpoint of ``STATE_WORDS`` f32, ~1 KB);
  the last one holds the backtrace start;
- backward: from the last window to the first, re-fill the window from
  its checkpoint with the trace on, then walk it carrying (k, e, n).

The result is bit-identical to the unchunked fill and walk
(``ops/abea.py``) for any window size: every band step is the same
(``_Band.step``), and the walk visits the same cells.  Two TPU
workarounds are not carried over: one read copied across 8 sublanes, and
windows that must be a multiple of the kernel's reload group.

The state record of a read (f32 words; ints stored as their bits), as
``csrc/abea_band.cuh`` lays it out: ``[0, 128)`` band bi-1's row,
``[128, 256)`` band bi-2's row, then band bi-1's and bi-2's lower-left
k-mers, the backtrace start's event and its score.
"""

from __future__ import annotations

import numpy as np
import torch

from .abea import (LL_K0, NEG_INF, PAD, FROM_L, FROM_U, START_OFF,
                   TRACE_ROW_BYTES, _Band, band_offsets, byte_offsets,
                   pack_trace, ragged_offsets, trace_cell)
from .seq_ranks import ranks_from_packed

ST_LLK, ST_K2, ST_BEST_E, ST_BEST_S = 2 * PAD, 2 * PAD + 1, 2 * PAD + 2, \
    2 * PAD + 3
STATE_WORDS = 2 * PAD + 4
WIN_BANDS = 1 << 16          # align_ultra_read's default window


def n_windows(n_bands: int, win: int) -> int:
    """Windows of ``win`` bands covering bands 2 .. n_bands-1 (bands 0
    and 1 are the initial state)."""
    return max(1, -(-(n_bands - 2) // win))


def _pack_state(prev, prev2, ll_k, k2, best_e, best_s) -> torch.Tensor:
    st = torch.empty((prev.shape[0], STATE_WORDS), dtype=torch.float32,
                     device=prev.device)
    st[:, :PAD] = prev
    st[:, PAD:2 * PAD] = prev2
    si = st.view(torch.int32)
    si[:, ST_LLK] = ll_k.to(torch.int32)
    si[:, ST_K2] = k2.to(torch.int32)
    si[:, ST_BEST_E] = best_e.to(torch.int32)
    st[:, ST_BEST_S] = best_s
    return st


def initial_state(params: torch.Tensor) -> torch.Tensor:
    """State records [B, STATE_WORDS] before band 2: bands 0 and 1 hold the
    start cell (k=-1, e=-1) and the first trim cell (csrc/abea.cu)."""
    B, dev = params.shape[0], params.device
    band0 = torch.full((B, PAD), NEG_INF, device=dev)
    band0[:, START_OFF] = 0.0
    band1 = torch.full((B, PAD), NEG_INF, device=dev)
    band1[:, START_OFF] = params[:, 5]
    k0 = torch.full((B,), LL_K0, dtype=torch.int32, device=dev)
    return _pack_state(band1, band0, k0, k0,
                       torch.full((B,), -1, dtype=torch.int32, device=dev),
                       torch.full((B,), NEG_INF, device=dev))


def fill_window_plain(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                      level_mean, level_stdv, level_log_stdv, params,
                      band_off, state, base: int, win: int, n_win: int,
                      trace: bool):
    """Run ``n_win`` windows of ``win`` bands from band ``base`` for every
    read (ABEA layout: ops/abea.py), starting from ``state`` (records
    [B, STATE_WORDS] at band ``base``).  Bands at or past a read's end
    are not run.  Returns (states f32 [B, n_win, STATE_WORDS], the state
    at the end of each window; with ``trace``, the packed trace u8
    [B, n_win * win, TRACE_ROW_BYTES] and llk i32 [B, n_win * win] of
    bands base .. base + n_win*win - 1 in the layout of ops/abea.py, 0
    past a read's end; else None, None)."""
    dev = ev_pool.device
    B = ev_len.shape[0]
    band = _Band(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                 level_mean, level_stdv, level_log_stdv, params, band_off)
    nb_max = int(band.nb.max()) if B else 0
    prev = state[:, :PAD].clone()
    prev2 = state[:, PAD:2 * PAD].clone()
    si = state.view(torch.int32)
    ll_k = si[:, ST_LLK].long()
    k2 = si[:, ST_K2].long()
    best_e = si[:, ST_BEST_E].long()
    best_s = state[:, ST_BEST_S].clone()
    ll_e = base - 3 - ll_k
    out = torch.empty((B, n_win, STATE_WORDS), dtype=torch.float32,
                      device=dev)
    tr = lk = None
    if trace:
        tr = torch.zeros((B, n_win * win, PAD), dtype=torch.uint8,
                         device=dev)
        lk = torch.zeros((B, n_win * win), dtype=torch.int32, device=dev)
    for j in range(n_win):
        for bi in range(base + j * win, min(base + (j + 1) * win, nb_max)):
            row, frm, ll_k_new, ll_e_new, best_s, best_e = band.step(
                bi, prev, prev2, ll_k, k2, ll_e, best_s, best_e)
            alive = bi < band.nb
            a = alive[:, None]
            prev2, prev = (torch.where(a, prev, prev2),
                           torch.where(a, row, prev))
            k2 = torch.where(alive, ll_k, k2)
            ll_k = torch.where(alive, ll_k_new, ll_k)
            ll_e = torch.where(alive, ll_e_new, ll_e)
            if trace:
                tr[:, bi - base] = torch.where(a, frm, 0).to(torch.uint8)
                lk[:, bi - base] = torch.where(alive, ll_k_new, 0).to(
                    torch.int32)
        out[:, j] = _pack_state(prev, prev2, ll_k, k2, best_e, best_s)
    return out, None if tr is None else pack_trace(tr), lk


def fill_window_packed_plain(ev_pool, ev_off, ev_len, seq_packed, seq_off,
                             rk_len, k: int, *rest):
    """The plain version of the window fill kernel, which ranks the packed
    sequences itself: ``ranks_from_packed`` (K11's plain version), then
    ``fill_window_plain`` on those ranks at ``seq_off``; ``rest`` as
    ``fill_window_plain`` takes it after ``rk_len``."""
    return fill_window_plain(ev_pool, ev_off, ev_len,
                             ranks_from_packed(seq_packed, k), seq_off,
                             rk_len, *rest)


def walk_window_plain(trace, llk, base: int, kst, flat, byte_off):
    """Backtrace walk down one window (the packed trace u8
    [B, win, TRACE_ROW_BYTES], llk i32 [B, win] of bands
    base .. base+win-1) for every read, from its carried
    ``kst`` i32 [B, 3] = (k, e, n), while k >= 0, e >= 0 and
    e + k + 2 >= base.  Direction n goes to bits 2(n%4) of byte n//4 of
    the read's output in ``flat`` (u8, layout of ops/abea.py).  Returns
    (kst', flat') as new tensors."""
    dev = trace.device
    B, win = trace.shape[0], trace.shape[1]
    k, e, n = (kst[:, j].long() for j in range(3))
    flat = flat.clone()
    b0 = byte_off[:-1]
    cap = byte_off[1:] - b0
    rows = torch.arange(B, device=dev)
    flat_tr = trace.reshape(B * win, TRACE_ROW_BYTES)
    for _ in range(win):
        active = (k >= 0) & (e >= 0) & (e + k + 2 >= base)
        if not bool(active.any()):
            break
        b = (e + k + 2 - base).clamp(0, win - 1)
        o = (k - llk[rows, b].long()).clamp(0, PAD - 1)
        f = torch.where(active, trace_cell(flat_tr, rows * win + b, o), 0)
        wr = active & ((n >> 2) < cap)
        pos = (b0 + (n >> 2))[wr]
        flat[pos] = flat[pos] | (f << (2 * (n & 3)))[wr].to(torch.uint8)
        k = k - (active & (f != FROM_U)).long()
        e = e - (active & (f != FROM_L)).long()
        n = n + active.long()
    return torch.stack([k, e, n], dim=1).to(torch.int32), flat


def walk_start(start_e: torch.Tensor, rk_len: torch.Tensor) -> torch.Tensor:
    """(k, e, n) at the backtrace start: the last k-mer at ``start_e``, or
    (-1, -1, 0) for a read with no start."""
    ok = start_e >= 0
    k = torch.where(ok, rk_len.to(torch.int32) - 1, -1)
    e = torch.where(ok, start_e, -1)
    return torch.stack([k, e, torch.zeros_like(k)], dim=1).to(
        torch.int32).contiguous()


def align_windowed(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                   level_mean, level_stdv, level_log_stdv, params, band_off,
                   byte_off, n_bytes: int, n_bands_max: int, win: int,
                   fill=fill_window_plain, walk=walk_window_plain):
    """ABEA by windows of ``win`` bands: the contract of
    ``abea_cuda.abea_align`` (flat packed dirs, start_e, n) with O(win)
    trace memory per read.  ``n_bands_max`` is the longest read's band
    count, from the host, so no window waits for the device.  ``fill``
    and ``walk`` are the plain versions or the kernel wrappers
    (ops/abea_ultra_cuda.py); ``rk_pool`` and ``rk_off`` go to ``fill``
    as given (the kernel wrapper's are the packed sequences and their
    base offsets)."""
    args = (ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len, level_mean,
            level_stdv, level_log_stdv, params, band_off)
    # a window longer than the longest read only wastes trace memory; any
    # window size gives the same bits
    win = max(1, min(win, n_bands_max - 2))
    nw = n_windows(n_bands_max, win)
    state0 = initial_state(params)
    ckpt, _, _ = fill(*args, state0, 2, win, nw, False)
    start_e = ckpt[:, -1].view(torch.int32)[:, ST_BEST_E].contiguous()
    kst = walk_start(start_e, rk_len)
    flat = torch.zeros(n_bytes, dtype=torch.uint8, device=ev_pool.device)
    for w in range(nw - 1, -1, -1):
        state = state0 if w == 0 else ckpt[:, w - 1].contiguous()
        base = 2 + w * win
        _, trace, llk = fill(*args, state, base, win, 1, True)
        kst, flat = walk(trace, llk, base, kst, flat, byte_off)
    return flat, start_e, kst[:, 2].contiguous()


def align_ultra_plain(reads, level_mean, level_stdv, level_log_stdv,
                      win: int = WIN_BANDS, device=None):
    """Windowed ABEA for a list of reads, each (events f32, ranks i32,
    params f32[6] = scale, shift, lp_stay, lp_step, lp_skip, lp_trim),
    through the plain versions.  Returns per read what the JAX package's
    ``align_ultra_read`` returns: (directions packed 4 per byte with the
    first step in the low bits, n_pairs, start_e) -- what native
    ``decode_qc_postalign`` consumes."""
    ev_len = np.array([r[0].shape[0] for r in reads], np.int32)
    rk_len = np.array([r[1].shape[0] for r in reads], np.int32)
    band_off = band_offsets(ev_len, rk_len)
    byte_off = byte_offsets(ev_len, rk_len)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    flat, start_e, n = align_windowed(
        t(np.concatenate([r[0] for r in reads]).astype(np.float32)),
        t(ragged_offsets(ev_len)[:-1]), t(ev_len),
        t(np.concatenate([r[1] for r in reads]).astype(np.int32)),
        t(ragged_offsets(rk_len)[:-1]), t(rk_len),
        t(level_mean), t(level_stdv), t(level_log_stdv),
        t(np.stack([np.asarray(r[2], np.float32) for r in reads])),
        t(band_off), t(byte_off), int(byte_off[-1]),
        int(np.diff(band_off).max()), win)
    flat, start_e, n = (x.cpu().numpy() for x in (flat, start_e, n))
    return [(flat[byte_off[i]:byte_off[i] + (int(n[i]) + 3) // 4].copy(),
             int(n[i]), int(start_e[i])) for i in range(len(reads))]
