"""Event detection (K9): a CUDA tensor goes to the hand-written kernels of
``csrc/events.cu``, a CPU tensor to the plain PyTorch version
``ops/events_device.py:detect_events_plain``.  Counterpart of
``f5c_tpu/ops/events_device.py`` (``detect_events_device``,
``detect_events_batch``).

The wrapper checks device, dtype, shape and contiguity, allocates the
scratch (28 bytes a sample; the host wrapper bounds a call's samples by
``SAMPLE_BUDGET``) and the outputs, launches on torch's current
stream and counts the call in ``launches``.  It reads the event counts
back once, to size the compact output; every read, however many events it
has, is detected on the card.  There is no fallback: a CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import HostCopy, h2d
from . import _build
from .events_device import detect_events_plain

launches = {"events": 0}
# the most samples that detect_events_batch gives one call: the scratch
# is 28 bytes a sample, so under 1 GB of device memory a call
SAMPLE_BUDGET = 1 << 25
# reads whose block redid its prefix sums in sample order (the scan's
# order rounded somewhere), summed over the calls
fixed_reads = {"events": 0}


def detect_events(pa_pool, sig_off, rna: bool = False):
    """Events of a ragged batch of pA signals (layout: ops/events_device.py):
    ``pa_pool`` f32 [S], ``sig_off`` i64 [B+1].  Returns (ev_off i64
    [B+1], start i64 [E], length f32 [E], mean f32 [E], stdv f32 [E]), on
    the input's device."""
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
    t1 = torch.empty(max(S_n, 1), dtype=f32, device=dev)
    t2 = torch.empty(max(S_n, 1), dtype=f32, device=dev)
    bnd = torch.empty(S_n + 2 * B, dtype=i32, device=dev)
    n_ev = torch.empty(B, dtype=i32, device=dev)
    fixed = torch.empty(B, dtype=i32, device=dev)
    lib = _build.library()
    stream = _build.stream_handle(dev)
    span = _build.span_start(dev)
    err = lib.f5c_events_detect(
        pa_pool.data_ptr(), sig_off.data_ptr(), s.data_ptr(), q.data_ptr(),
        t1.data_ptr(), t2.data_ptr(), bnd.data_ptr(), n_ev.data_ptr(),
        fixed.data_ptr(), B, int(rna), stream)
    _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_detect", err)
    counts = torch.stack([n_ev, fixed]).cpu().numpy().astype(np.int64)
    fixed_reads["events"] += int(counts[1].sum())
    ev_off_h = np.zeros(B + 1, np.int64)
    np.cumsum(counts[0], out=ev_off_h[1:])
    E = int(ev_off_h[-1])
    ev_off = torch.from_numpy(ev_off_h).to(dev)
    start = torch.empty(E, dtype=i64, device=dev)
    length, mean, stdv = (torch.empty(E, dtype=f32, device=dev)
                          for _ in range(3))
    span = _build.span_start(dev)
    err = lib.f5c_events_assemble(
        s.data_ptr(), q.data_ptr(), sig_off.data_ptr(), bnd.data_ptr(),
        ev_off.data_ptr(), start.data_ptr(), length.data_ptr(),
        mean.data_ptr(), stdv.data_ptr(), B, stream)
    _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_assemble", err)
    launches["events"] += 1
    return ev_off, start, length, mean, stdv


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
