"""Wrappers of the ultra-long-read ABEA kernels: a CUDA tensor goes to
``csrc/abea_ultra.cu``, a CPU tensor to the plain PyTorch version of
``ops/abea_ultra.py``.  Counterpart of ``f5c_tpu/ops/abea_ultra.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on torch's current stream and counts the launch in
``launches``.  There is no fallback: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .abea import PAD
from .abea_ultra import (STATE_WORDS, align_windowed, fill_window_plain,
                         walk_window_plain)

launches = {"abea_fill_window": 0, "abea_walk_window": 0}


def abea_fill_window(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                     level_mean, level_stdv, level_log_stdv, params,
                     band_off, state, base: int, win: int, n_win: int,
                     trace: bool):
    """``n_win`` windows of ``win`` bands from band ``base``, from the
    state records ``state`` [B, STATE_WORDS]; the contract of
    ``abea_ultra.fill_window_plain``.  Returns (states
    [B, n_win, STATE_WORDS], trace u8 [B, n_win*win, 128] or None,
    llk i32 [B, n_win*win] or None)."""
    dev = ev_pool.device
    B = ev_len.shape[0]
    for name, t, dt, nd in (
            ("ev_pool", ev_pool, torch.float32, 1),
            ("ev_off", ev_off, torch.int64, 1),
            ("ev_len", ev_len, torch.int32, 1),
            ("rk_pool", rk_pool, torch.int32, 1),
            ("rk_off", rk_off, torch.int64, 1),
            ("rk_len", rk_len, torch.int32, 1),
            ("level_mean", level_mean, torch.float32, 1),
            ("level_stdv", level_stdv, torch.float32, 1),
            ("level_log_stdv", level_log_stdv, torch.float32, 1),
            ("params", params, torch.float32, 2),
            ("band_off", band_off, torch.int64, 1),
            ("state", state, torch.float32, 2)):
        _build.check_tensor(name, t, dt, nd, dev)
    if (ev_off.shape[0] != B or rk_off.shape[0] != B
            or rk_len.shape[0] != B or band_off.shape[0] != B + 1
            or params.shape != (B, 6) or state.shape != (B, STATE_WORDS)):
        raise ValueError("abea_fill_window: per-read arrays disagree on B")
    if not (level_mean.shape == level_stdv.shape == level_log_stdv.shape):
        raise ValueError("abea_fill_window: model tables differ in length")
    if base < 2 or win < 1 or n_win < 1 or base + n_win * win >= 2**31:
        raise ValueError(f"abea_fill_window: bad window base={base} "
                         f"win={win} n_win={n_win}")
    if dev.type == "cpu":
        return fill_window_plain(ev_pool, ev_off, ev_len, rk_pool, rk_off,
                                 rk_len, level_mean, level_stdv,
                                 level_log_stdv, params, band_off, state,
                                 base, win, n_win, trace)
    if dev.type != "cuda":
        raise ValueError(f"abea_fill_window: unsupported device {dev}")
    out = torch.empty((B, n_win, STATE_WORDS), dtype=torch.float32,
                      device=dev)
    tr = lk = None
    if trace:
        tr = torch.empty((B, n_win * win, PAD), dtype=torch.uint8,
                         device=dev)
        lk = torch.empty((B, n_win * win), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.f5c_abea_fill_window(
        ev_pool.data_ptr(), ev_off.data_ptr(), ev_len.data_ptr(),
        rk_pool.data_ptr(), rk_off.data_ptr(), rk_len.data_ptr(),
        level_mean.data_ptr(), level_stdv.data_ptr(),
        level_log_stdv.data_ptr(), params.data_ptr(), band_off.data_ptr(),
        state.data_ptr(), out.data_ptr(),
        tr.data_ptr() if trace else None, lk.data_ptr() if trace else None,
        level_mean.shape[0], B, base, win, n_win, _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_fill_window", err)
    launches["abea_fill_window"] += 1
    return out, tr, lk


def abea_walk_window(trace, llk, base: int, kst, flat, byte_off):
    """Walk one window (trace u8 [B, win, 128], llk i32 [B, win] of bands
    base .. base+win-1) from ``kst`` i32 [B, 3] = (k, e, n) into the
    ragged 2-bit output ``flat``; the contract of
    ``abea_ultra.walk_window_plain``.  Returns (kst', flat') as new
    tensors (the kernel updates copies in place)."""
    dev = trace.device
    B = kst.shape[0]
    for name, t, dt, nd in (
            ("trace", trace, torch.uint8, 3),
            ("llk", llk, torch.int32, 2),
            ("kst", kst, torch.int32, 2),
            ("flat", flat, torch.uint8, 1),
            ("byte_off", byte_off, torch.int64, 1)):
        _build.check_tensor(name, t, dt, nd, dev)
    if (trace.shape[0] != B or trace.shape[2] != PAD
            or llk.shape != trace.shape[:2] or kst.shape[1] != 3
            or byte_off.shape[0] != B + 1):
        raise ValueError("abea_walk_window: inconsistent shapes")
    if dev.type == "cpu":
        return walk_window_plain(trace, llk, base, kst, flat, byte_off)
    if dev.type != "cuda":
        raise ValueError(f"abea_walk_window: unsupported device {dev}")
    kst, flat = kst.clone(), flat.clone()
    lib = _build.library()
    err = lib.f5c_abea_walk_window(
        trace.data_ptr(), llk.data_ptr(), kst.data_ptr(),
        byte_off.data_ptr(), flat.data_ptr(), base, trace.shape[1], B,
        _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_walk_window", err)
    launches["abea_walk_window"] += 1
    return kst, flat


def abea_align_windowed(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                        level_mean, level_stdv, level_log_stdv, params,
                        band_off, byte_off, n_bytes: int, n_bands_max: int,
                        win: int):
    """ABEA by windows through the wrappers above: the contract of
    ``abea_cuda.abea_align`` with O(win) trace memory per read."""
    return align_windowed(ev_pool, ev_off, ev_len, rk_pool, rk_off, rk_len,
                          level_mean, level_stdv, level_log_stdv, params,
                          band_off, byte_off, n_bytes, n_bands_max, win,
                          fill=abea_fill_window, walk=abea_walk_window)
