"""ABEA wrappers: a CUDA tensor goes to the hand-written kernels of
``csrc/abea.cu``, a CPU tensor to the plain PyTorch version of
``ops/abea.py``.  Counterpart of ``f5c_tpu/ops/abea_ring.py``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on torch's current stream of the tensors' device (under
``_build.device_guard``) and counts the launch in ``launches``.  There is no fallback: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .abea import (TRACE_ROW_BYTES, abea_fill_packed_plain,
                   abea_walk_plain, fill_smem_bytes, walk_smem_bytes)
from .seq_ranks import ranks_at_kmers

launches = {"abea_fill": 0, "abea_walk": 0}
KMER_MAX = 15        # a k-mer's bases lie in two words; its rank in an i32


def check_seqs(fn: str, seq_packed, seq_off, rk_len, k, dev, B) -> None:
    """The packed-sequence arguments of the fill kernels and the rank
    probe: ``seq_packed`` u8 [4n] (whole 32-bit words, 4-byte aligned:
    the kernels read it by words; ``seq_ranks.pack_seqs`` pads it so),
    ``seq_off`` i64 [B], ``rk_len`` i32 [B] on ``dev``, and
    1 <= k <= KMER_MAX."""
    for name, t, dt in (("seq_packed", seq_packed, torch.uint8),
                        ("seq_off", seq_off, torch.int64),
                        ("rk_len", rk_len, torch.int32)):
        _build.check_tensor(name, t, dt, 1, dev)
    if seq_packed.shape[0] % 4 or seq_packed.data_ptr() % 4:
        raise ValueError(f"{fn}: seq_packed is not whole 4-byte-aligned "
                         "32-bit words")
    if seq_off.shape[0] != B or rk_len.shape[0] != B:
        raise ValueError(f"{fn}: per-read arrays disagree on B")
    if not 1 <= k <= KMER_MAX:
        raise ValueError(f"{fn}: k = {k} outside 1..{KMER_MAX}")


def abea_fill(ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len, k: int,
              level_mean, level_stdv, level_log_stdv, params, band_off,
              n_bands: int):
    """Band fill (layout: ops/abea.py) of reads whose sequences come 2-bit
    packed (``seq_packed`` u8 from ``seq_ranks.pack_seqs``, whole 32-bit
    words; read i's first base at ``seq_off[i]`` i64, ``rk_len`` i32 its
    k-mers, ``k`` the model's): the kernel ranks the k-mers itself (K11
    fused); on the CPU, ``abea_fill_packed_plain``.  ``n_bands`` is ``band_off[-1]``,
    passed from the host so that sizing the outputs never waits for the
    device.  Returns (the packed trace u8 [n_bands, TRACE_ROW_BYTES],
    llk i32 [n_bands], start_e i32 [B])."""
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
            ("band_off", band_off, torch.int64, 1)):
        _build.check_tensor(name, t, dt, nd, dev)
    check_seqs("abea_fill", seq_packed, seq_off, rk_len, k, dev, B)
    if (ev_off.shape[0] != B or band_off.shape[0] != B + 1
            or params.shape != (B, 6)):
        raise ValueError("abea_fill: per-read arrays disagree on B")
    if not (level_mean.shape == level_stdv.shape == level_log_stdv.shape):
        raise ValueError("abea_fill: model tables differ in length")
    if dev.type == "cpu":
        if int(band_off[-1]) != n_bands:
            raise ValueError("abea_fill: n_bands != band_off[-1]")
        return abea_fill_packed_plain(ev_pool, ev_off, ev_len, seq_packed,
                                      seq_off, rk_len, k, level_mean,
                                      level_stdv, level_log_stdv, params,
                                      band_off)
    if dev.type != "cuda":
        raise ValueError(f"abea_fill: unsupported device {dev}")
    trace = torch.empty((n_bands, TRACE_ROW_BYTES), dtype=torch.uint8,
                        device=dev)
    llk = torch.empty(n_bands, dtype=torch.int32, device=dev)
    start_e = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_abea_fill(
            ev_pool.data_ptr(), ev_off.data_ptr(), ev_len.data_ptr(),
            seq_packed.data_ptr(), seq_off.data_ptr(), rk_len.data_ptr(),
            level_mean.data_ptr(), level_stdv.data_ptr(),
            level_log_stdv.data_ptr(), params.data_ptr(),
            band_off.data_ptr(), trace.data_ptr(), llk.data_ptr(),
            start_e.data_ptr(), k, level_mean.shape[0], B,
            fill_smem_bytes(), _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_fill", err)
    launches["abea_fill"] += 1
    return trace, llk, start_e


def abea_ranks(seq_packed, seq_off, rk_len, k: int):
    """The rank probe: the k-mer ranks the fill kernels compute where they
    stage their inputs (``abea_band.cuh`` ``kmer_rank``), i32
    [4 * len(seq_packed)], read i's k-mer p at ``seq_off[i] + p``, 0 at
    every other base; on the CPU, ``seq_ranks.ranks_at_kmers``.  Not
    counted as a launch."""
    dev = seq_packed.device
    check_seqs("abea_ranks", seq_packed, seq_off, rk_len, k, dev,
               seq_off.shape[0])
    if dev.type == "cpu":
        return ranks_at_kmers(seq_packed, seq_off, rk_len, k)
    if dev.type != "cuda":
        raise ValueError(f"abea_ranks: unsupported device {dev}")
    out = torch.zeros(4 * seq_packed.shape[0], dtype=torch.int32,
                      device=dev)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_abea_ranks(
            seq_packed.data_ptr(), seq_off.data_ptr(), rk_len.data_ptr(),
            out.data_ptr(), k, seq_off.shape[0], _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_ranks", err)
    return out


def abea_walk(trace, llk, band_off, start_e, rk_len, byte_off,
              n_bytes: int):
    """Backtrace walk over the packed ``trace`` u8 [n_bands,
    TRACE_ROW_BYTES] into the ragged 2-bit output (layout: ops/abea.py);
    a trace of one byte a cell is refused.  ``n_bytes`` is
    ``byte_off[-1]``, passed from the host.  Returns (flat u8 [n_bytes],
    n i32 [B])."""
    dev = trace.device
    B = start_e.shape[0]
    for name, t, dt, nd in (
            ("trace", trace, torch.uint8, 2),
            ("llk", llk, torch.int32, 1),
            ("band_off", band_off, torch.int64, 1),
            ("start_e", start_e, torch.int32, 1),
            ("rk_len", rk_len, torch.int32, 1),
            ("byte_off", byte_off, torch.int64, 1)):
        _build.check_tensor(name, t, dt, nd, dev)
    if (trace.shape[1] != TRACE_ROW_BYTES or llk.shape[0] != trace.shape[0]
            or band_off.shape[0] != B + 1 or rk_len.shape[0] != B
            or byte_off.shape[0] != B + 1):
        raise ValueError("abea_walk: inconsistent shapes")
    if dev.type == "cpu":
        if int(byte_off[-1]) != n_bytes:
            raise ValueError("abea_walk: n_bytes != byte_off[-1]")
        return abea_walk_plain(trace, llk, band_off, start_e, rk_len,
                               byte_off)
    if dev.type != "cuda":
        raise ValueError(f"abea_walk: unsupported device {dev}")
    flat = torch.zeros(n_bytes, dtype=torch.uint8, device=dev)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_abea_walk(
            trace.data_ptr(), llk.data_ptr(), band_off.data_ptr(),
            start_e.data_ptr(), rk_len.data_ptr(), byte_off.data_ptr(),
            flat.data_ptr(), n.data_ptr(), B, walk_smem_bytes(),
            _build.stream_handle(dev))
    _build.check_error(lib, "f5c_abea_walk", err)
    launches["abea_walk"] += 1
    return flat, n


def abea_align(ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len,
               k: int, level_mean, level_stdv, level_log_stdv, params,
               band_off, byte_off, n_bands: int, n_bytes: int):
    """One ABEA device step: fill then walk (the arguments of
    ``abea_fill``, then ``byte_off`` i64 [B+1] and ``n_bytes``).  The
    contract of the JAX package's abea_align_device_ring (flat packed
    dirs, start_e, n) on ragged per-read inputs."""
    trace, llk, start_e = abea_fill(
        ev_pool, ev_off, ev_len, seq_packed, seq_off, rk_len, k, level_mean,
        level_stdv, level_log_stdv, params, band_off, n_bands)
    flat, n = abea_walk(trace, llk, band_off, start_e, rk_len, byte_off,
                        n_bytes)
    return flat, start_e, n
