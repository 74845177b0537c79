"""Wrappers of the ultra-long-read ABEA kernels: a CUDA tensor goes to
``csrc/abea_ultra.cu``, a CPU tensor to the plain PyTorch version of
``ops/abea_ultra.py``.  Counterpart of ``f5c_tpu/ops/abea_ultra.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on torch's current stream of the tensors' device (under
``_build.device_guard``) and counts the launch in ``launches``.  There is no fallback: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .abea import (TRACE_ROW_BYTES, WALK_TILE, fill_smem_bytes,
                   walk_smem_bytes, walk_tiles_of)
from .abea_cuda import check_seqs, walk_tiled_launch
from .abea_ultra import (STATE_WORDS, align_windowed,
                         fill_window_packed_plain, walk_window_plain)

# "abea_walk_window" counts the tiled window walk (the windowed path's);
# "abea_walk_window_warp" the one-warp window walk, a yardstick
launches = {"abea_fill_window": 0, "abea_walk_window": 0,
            "abea_walk_window_warp": 0}


def abea_fill_window(ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len,
                     k: int, level_mean, level_stdv, level_log_stdv, params,
                     band_off, state, base: int, win: int, n_win: int,
                     trace: bool, routes: bool = False):
    """``n_win`` windows of ``win`` bands from band ``base``, from the
    state records ``state`` [B, STATE_WORDS]; the reads' sequences come
    2-bit packed as ``abea_cuda.abea_fill`` takes them (``seq_packed`` u8,
    ``seq_off`` i64 [B], ``rk_len`` i32 [B], ``k``), and the kernel ranks
    the k-mers itself.  The contract of ``abea_ultra.fill_window_plain``;
    on the CPU, ``abea_ultra.fill_window_packed_plain``.  Returns (states
    [B, n_win, STATE_WORDS], the packed trace u8
    [B, n_win*win, TRACE_ROW_BYTES] or None, llk i32 [B, n_win*win] or
    None); with ``routes`` (on the card only) also the kernel's report
    i32 [B], as ``abea_cuda.abea_fill`` gives it, for the inputs this
    launch staged."""
    dev = ev_pool.device
    B = ev_len.shape[0]
    for name, t, dt, nd in (
            ("ev_pool", ev_pool, torch.float32, 1),
            ("ev_off", ev_off, torch.int64, 1),
            ("ev_len", ev_len, torch.int32, 1),
            ("level_mean", level_mean, torch.float32, 1),
            ("level_stdv", level_stdv, torch.float32, 1),
            ("level_log_stdv", level_log_stdv, torch.float32, 1),
            ("params", params, torch.float32, 2),
            ("band_off", band_off, torch.int64, 1),
            ("state", state, torch.float32, 2)):
        _build.check_tensor(name, t, dt, nd, dev)
    check_seqs("abea_fill_window", seq_packed, seq_off, rk_len, k, dev, B)
    if (ev_off.shape[0] != B or band_off.shape[0] != B + 1
            or params.shape != (B, 6) or state.shape != (B, STATE_WORDS)):
        raise ValueError("abea_fill_window: per-read arrays disagree on B")
    if not (level_mean.shape == level_stdv.shape == level_log_stdv.shape):
        raise ValueError("abea_fill_window: model tables differ in length")
    if base < 2 or win < 1 or n_win < 1 or base + n_win * win >= 2**31:
        raise ValueError(f"abea_fill_window: bad window base={base} "
                         f"win={win} n_win={n_win}")
    if dev.type == "cpu":
        if routes:
            raise ValueError("abea_fill_window: routes are the kernel's "
                             "report")
        return fill_window_packed_plain(
            ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len, k,
            level_mean, level_stdv, level_log_stdv, params, band_off, state,
            base, win, n_win, trace)
    if dev.type != "cuda":
        raise ValueError(f"abea_fill_window: unsupported device {dev}")
    out = torch.empty((B, n_win, STATE_WORDS), dtype=torch.float32,
                      device=dev)
    tr = lk = None
    if trace:
        tr = torch.empty((B, n_win * win, TRACE_ROW_BYTES),
                         dtype=torch.uint8, device=dev)
        lk = torch.empty((B, n_win * win), dtype=torch.int32, device=dev)
    guarded = torch.empty(B, dtype=torch.int32, device=dev) if routes \
        else None
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_abea_fill_window_routed(
            ev_pool.data_ptr(), ev_off.data_ptr(), ev_len.data_ptr(),
            seq_packed.data_ptr(), seq_off.data_ptr(), rk_len.data_ptr(),
            level_mean.data_ptr(), level_stdv.data_ptr(),
            level_log_stdv.data_ptr(), params.data_ptr(),
            band_off.data_ptr(), state.data_ptr(), out.data_ptr(),
            tr.data_ptr() if trace else None,
            lk.data_ptr() if trace else None,
            guarded.data_ptr() if routes else None, k, level_mean.shape[0],
            B, base, win, n_win, fill_smem_bytes(),
            _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_fill_window_routed", err)
    launches["abea_fill_window"] += 1
    return (out, tr, lk, guarded) if routes else (out, tr, lk)


def abea_walk_window(trace, llk, base: int, kst, flat, byte_off,
                     route: str = "tiled", phases: int = 7, scratch=None):
    """Walk one window (the packed trace u8 [B, win, TRACE_ROW_BYTES],
    llk i32 [B, win] of bands base .. base+win-1; a trace of one byte a
    cell is refused) from ``kst`` i32 [B, 3] = (k, e, n) into the
    ragged 2-bit output ``flat``; the contract of
    ``abea_ultra.walk_window_plain``.  On the card the tiled walk
    (csrc/abea_walk_tiled.cu; ``phases`` and ``scratch`` as
    ``abea_cuda.walk_tiled_launch`` takes them), or with ``route="warp"``
    the one-warp walk (csrc/abea_ultra.cu).  Returns (kst', flat') as new
    tensors (the kernels update copies in place)."""
    dev = trace.device
    B = kst.shape[0]
    for name, t, dt, nd in (
            ("trace", trace, torch.uint8, 3),
            ("llk", llk, torch.int32, 2),
            ("kst", kst, torch.int32, 2),
            ("flat", flat, torch.uint8, 1),
            ("byte_off", byte_off, torch.int64, 1)):
        _build.check_tensor(name, t, dt, nd, dev)
    if (trace.shape[0] != B or trace.shape[2] != TRACE_ROW_BYTES
            or llk.shape != trace.shape[:2] or kst.shape[1] != 3
            or byte_off.shape[0] != B + 1):
        raise ValueError("abea_walk_window: inconsistent shapes")
    if route not in ("tiled", "warp"):
        raise ValueError(f"abea_walk_window: unknown route {route!r}")
    if dev.type == "cpu":
        return walk_window_plain(trace, llk, base, kst, flat, byte_off)
    if dev.type != "cuda":
        raise ValueError(f"abea_walk_window: unsupported device {dev}")
    kst, flat = kst.clone(), flat.clone()
    win = trace.shape[1]
    if route == "tiled":
        J = walk_tiles_of(win, WALK_TILE)
        tile_off = torch.arange(B + 1, dtype=torch.int32, device=dev) * J
        walk_tiled_launch(trace, llk, byte_off, flat, tile_off, B * J,
                          kst=kst, base=base, win=win, phases=phases,
                          scratch=scratch)
        launches["abea_walk_window"] += 1
        return kst, flat
    lib = _build.library()
    with _build.device_guard(dev):
        span = _build.span_start(dev)
        err = lib.f5c_abea_walk_window(
            trace.data_ptr(), llk.data_ptr(), kst.data_ptr(),
            byte_off.data_ptr(), flat.data_ptr(), base, win, B,
            walk_smem_bytes(), _build.stream_handle(dev))
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_abea_walk_window", err)
    launches["abea_walk_window_warp"] += 1
    return kst, flat


def abea_align_windowed(ev_pool, ev_off, ev_len, seq_packed, seq_off,
                        rk_len, k: int, level_mean, level_stdv,
                        level_log_stdv, params, band_off, byte_off,
                        n_bytes: int, n_bands_max: int, win: int):
    """ABEA by windows through the wrappers above (the arguments of
    ``abea_fill_window`` up to ``band_off``): the contract of
    ``abea_cuda.abea_align`` with O(win) trace memory per read."""

    def fill(ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len, *rest):
        return abea_fill_window(ev_pool, ev_off, ev_len, seq_packed,
                                seq_off, rk_len, k, *rest)

    return align_windowed(ev_pool, ev_off, ev_len, seq_packed, seq_off,
                          rk_len, level_mean, level_stdv, level_log_stdv,
                          params, band_off, byte_off, n_bytes, n_bands_max,
                          win, fill=fill, walk=abea_walk_window)
