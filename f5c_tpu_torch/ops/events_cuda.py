"""Event detection (K9): a CUDA tensor goes to the hand-written kernels of
``csrc/events.cu``, a CPU tensor to the plain PyTorch version
``ops/events_device.py:detect_events_plain``.  Counterpart of
``f5c_tpu/ops/events_device.py`` (``detect_events_device``,
``detect_events_batch``).

The wrapper checks device, dtype, shape and contiguity, allocates the
scratch (28 bytes a sample; the host wrapper bounds a call's samples by
``SAMPLE_BUDGET``) and the outputs, launches on torch's current
stream of the tensors' device (under ``_build.device_guard``) and counts
the call in ``launches``.  The peak scan runs one block
a read, its chunks of samples side by side to an exact fixed point
(``events_device.peak_scan_chunked`` is its plain model); the block's
threads follow the launch's longest read (``events_device.peak_threads``).
The wrapper reads the event counts, and the scan's rounds, back once, to
size the compact output; every read, however many events it has, is
detected on the card.  There is no fallback: a CUDA tensor launches the
kernels or raises.  ``peaks_from_tracks`` runs the peak scan alone on
given tracks (the probe the tests and chip_smoke.py hold to
``events_device.peak_scan``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import HostCopy, h2d
from . import _build
from .events_device import (MAX_THREADS, detect_events_plain, peak_chunk,
                            peak_scan_chunked, peak_threads)

launches = {"events": 0}
# the most samples that detect_events_batch gives one call: the scratch
# is 28 bytes a sample, so under 1 GB of device memory a call
SAMPLE_BUDGET = 1 << 25
# reads whose block redid its prefix sums in sample order (the scan's
# order rounded somewhere), summed over the calls
fixed_reads = {"events": 0}
# the peak scan's rounds to its fixed point: the most in a read, and the
# sum over reads and the reads, summed over the calls
rounds = {"max": 0, "sum": 0, "reads": 0}


def _padded(n: int) -> int:
    """A track slab's floats: the kernel reads it in aligned groups of 8."""
    return -(-max(n, 1) // 8) * 8


def detect_events(pa_pool, sig_off, rna: bool = False):
    """Events of a ragged batch of pA signals (layout: ops/events_device.py):
    ``pa_pool`` f32 [S], ``sig_off`` i64 [B+1].  Returns (ev_off i64
    [B+1], start i64 [E], length f32 [E], mean f32 [E], stdv f32 [E]), on
    the input's device.  The longest read, read back from ``sig_off``,
    sizes the peak scan's blocks; the events do not depend on it."""
    dev = pa_pool.device
    _build.check_tensor("pa_pool", pa_pool, torch.float32, 1, dev)
    _build.check_tensor("sig_off", sig_off, torch.int64, 1, dev)
    if sig_off.shape[0] < 1:
        raise ValueError("detect_events: sig_off needs B + 1 entries")
    if dev.type == "cpu":
        return detect_events_plain(pa_pool, sig_off, rna)
    if dev.type != "cuda":
        raise ValueError(f"detect_events: unsupported device {dev}")
    B = sig_off.shape[0] - 1
    S_n = pa_pool.shape[0]
    f64, f32, i32, i64 = torch.float64, torch.float32, torch.int32, \
        torch.int64
    s = torch.empty(S_n + B, dtype=f64, device=dev)
    q = torch.empty(S_n + B, dtype=f64, device=dev)
    max_len = int((sig_off[1:] - sig_off[:-1]).max()) if B else 0
    t1 = torch.empty(_padded(S_n), dtype=f32, device=dev)
    t2 = torch.empty(_padded(S_n), dtype=f32, device=dev)
    bnd = torch.empty(S_n + 2 * B, dtype=i32, device=dev)
    n_ev, fixed, rnd = (torch.empty(B, dtype=i32, device=dev)
                        for _ in range(3))
    lib = _build.library()
    with _build.device_guard(dev):
        stream = _build.stream_handle(dev)
        span = _build.span_start(dev)
        err = lib.f5c_events_detect(
            pa_pool.data_ptr(), sig_off.data_ptr(), s.data_ptr(),
            q.data_ptr(), t1.data_ptr(), t2.data_ptr(), bnd.data_ptr(),
            n_ev.data_ptr(), fixed.data_ptr(), rnd.data_ptr(), B, int(rna),
            peak_threads(max_len), stream)
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_detect", err)
    counts = torch.stack([n_ev, fixed, rnd]).cpu().numpy().astype(np.int64)
    fixed_reads["events"] += int(counts[1].sum())
    _count_rounds(counts[2])
    ev_off_h = np.zeros(B + 1, np.int64)
    np.cumsum(counts[0], out=ev_off_h[1:])
    E = int(ev_off_h[-1])
    ev_off = torch.from_numpy(ev_off_h).to(dev)
    start = torch.empty(E, dtype=i64, device=dev)
    length, mean, stdv = (torch.empty(E, dtype=f32, device=dev)
                          for _ in range(3))
    with _build.device_guard(dev):
        span = _build.span_start(dev)
        err = lib.f5c_events_assemble(
            s.data_ptr(), q.data_ptr(), sig_off.data_ptr(), bnd.data_ptr(),
            ev_off.data_ptr(), start.data_ptr(), length.data_ptr(),
            mean.data_ptr(), stdv.data_ptr(), B, stream)
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_assemble", err)
    launches["events"] += 1
    return ev_off, start, length, mean, stdv


def _count_rounds(r: np.ndarray) -> None:
    if r.shape[0]:
        rounds["max"] = max(rounds["max"], int(r.max()))
        rounds["sum"] += int(r.sum())
        rounds["reads"] += int(r.shape[0])


def peaks_from_tracks(t1, t2, sig_off, rna: bool = False, chunk: int = 0):
    """The peak scan alone (the probe): ``t1``, ``t2`` f32 [S] t-stat
    tracks and ``sig_off`` i64 [B+1] in the layout of detect_events.
    ``chunk`` > 0 pins the chunk length (at most MAX_THREADS chunks a
    read); 0 takes the kernel's own, as detect_events launches it.
    Returns (each read's peaks in emission order as a list of ints, the
    rounds a read, i64 numpy).  A CPU tensor goes to the plain model
    ``peak_scan_chunked``, chunk for chunk.  Not counted in ``launches``:
    it is no part of the main path."""
    dev = t1.device
    _build.check_tensor("t1", t1, torch.float32, 1, dev)
    _build.check_tensor("t2", t2, torch.float32, 1, dev)
    _build.check_tensor("sig_off", sig_off, torch.int64, 1, dev)
    if t2.shape != t1.shape or sig_off.shape[0] < 1:
        raise ValueError("peaks_from_tracks: tracks of one length and B + 1 "
                         "offsets")
    off = sig_off.cpu().numpy()
    lens = off[1:] - off[:-1]
    B = lens.shape[0]
    max_len = int(lens.max()) if B else 0
    if chunk > 0:
        most = max(-(-(int(n) - 1) // chunk) for n in lens) if B else 0
        if most > MAX_THREADS:
            raise ValueError(f"peaks_from_tracks: {most} chunks of {chunk} "
                             f"in a read, over {MAX_THREADS}")
        threads = max(32, -(-most // 32) * 32)
    else:
        threads = peak_threads(max_len)
    if dev.type == "cpu":
        a, b = t1.tolist(), t2.tolist()
        peaks, rnd = [], []
        for o, n in zip(off[:-1], lens):
            o, n = int(o), int(n)
            p, r = peak_scan_chunked(a[o:o + n], b[o:o + n], n, rna,
                                     chunk or peak_chunk(n, threads))
            peaks.append(p)
            rnd.append(r)
        return peaks, np.array(rnd, np.int64)
    if dev.type != "cuda":
        raise ValueError(f"peaks_from_tracks: unsupported device {dev}")
    S_n = t1.shape[0]
    pad = [torch.zeros(_padded(S_n), dtype=torch.float32, device=dev)
           for _ in range(2)]
    pad[0][:S_n] = t1
    pad[1][:S_n] = t2
    bnd = torch.empty(S_n + 2 * B, dtype=torch.int32, device=dev)
    n_ev, rnd = (torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(2))
    lib = _build.library()
    with _build.device_guard(dev):
        span = _build.span_start(dev)
        err = lib.f5c_events_peaks(
            pad[0].data_ptr(), pad[1].data_ptr(), sig_off.data_ptr(),
            bnd.data_ptr(), n_ev.data_ptr(), rnd.data_ptr(), B, int(rna),
            chunk, threads, _build.stream_handle(dev))
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_peaks", err)
    bnd_h, ne = bnd.cpu().numpy(), n_ev.cpu().numpy()
    peaks = [bnd_h[o + 2 * i + 1:o + 2 * i + ne[i]].tolist()
             for i, o in enumerate(off[:-1])]
    return peaks, rnd.cpu().numpy().astype(np.int64)


def detect_events_batch(pas: list, rna: bool, device: torch.device):
    """Host wrapper: the events of each pA signal in ``pas`` (f32 numpy),
    detected on ``device``; returns per-read (start i64, length f32, mean
    f32, stdv f32) numpy arrays, the dtypes of ``native.detect_events``.
    Consecutive reads go to one call of ``detect_events`` until they pass
    ``SAMPLE_BUDGET`` samples (a longer read goes alone).  The signals go
    up through pinned memory and the events come back the same way."""
    groups, size = [[]], 0
    for p in pas:
        if groups[-1] and size + p.shape[0] > SAMPLE_BUDGET:
            groups.append([])
            size = 0
        groups[-1].append(p)
        size += p.shape[0]
    return [t for g in groups for t in _detect_group(g, rna, device)]


def _detect_group(pas: list, rna: bool, device: torch.device):
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    slab = (np.concatenate(pas).astype(np.float32, copy=False) if pas
            else np.zeros(0, np.float32))
    eo, start, length, mean, stdv = HostCopy(list(detect_events(
        h2d(slab, device), h2d(off, device), rna))).wait()
    return [(start[a:b].copy(), length[a:b].copy(), mean[a:b].copy(),
             stdv[a:b].copy()) for a, b in zip(eo[:-1], eo[1:])]
