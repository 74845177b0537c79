"""Event detection on the device: the ragged layout shared with the CUDA
kernels of ``csrc/events.cu``, and their plain PyTorch version.

Counterpart of ``f5c_tpu/ops/events_device.py`` (``detect_events_device``
and its host wrapper ``detect_events_batch``).  Algorithm: the port's host
detector, ``native/src/f5chost.cpp`` (``f5c_detect_events``, events.c
222-513), operation for operation:

1. exclusive prefix sums of the signal and of its f32 squares, in f64 and
   in sample order (events.c:302-312);
2. two windowed Welch t-stat tracks, zero outside [w, n - w) and wholly
   zero when n < 2w (events.c:324-373; the mixed f32/f64 rounding points
   of ``tstat_at``);
3. the coupled short/long peak detectors, one pass over the samples with
   the short detector first within a sample (events.c:380-452; the host
   detector splits it into two passes with the same result);
4. events between consecutive peaks: start, length, mean, stdv
   (events.c:466-513).

The JAX op's two-float arithmetic is not carried over: it stood in for
f64, which the TPU lacks.

Layout, per read i of a batch of B: samples ``pa_pool[sig_off[i] :
sig_off[i+1]]`` (f32 pA), no padding; events ``ev_off[i] .. ev_off[i+1]``
of the outputs start (i64), length, mean, stdv (f32).  A read's events are
at most its samples + 1, the bound the host detector sizes its buffers to.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (DNA_PEAK_HEIGHT, DNA_THRESHOLD1, DNA_THRESHOLD2,
                         DNA_WINDOW1, DNA_WINDOW2, RNA_PEAK_HEIGHT,
                         RNA_THRESHOLD1, RNA_THRESHOLD2, RNA_WINDOW1,
                         RNA_WINDOW2)

FLT_MAX = float(np.finfo(np.float32).max)
FLT_MIN = float(np.finfo(np.float32).tiny)


def detector_params(rna: bool):
    """(w1, w2, threshold1, threshold2, peak_height), thresholds as f32
    values (f5c_detect_events)."""
    f = np.float32
    if rna:
        return (RNA_WINDOW1, RNA_WINDOW2, float(f(RNA_THRESHOLD1)),
                float(f(RNA_THRESHOLD2)), float(f(RNA_PEAK_HEIGHT)))
    return (DNA_WINDOW1, DNA_WINDOW2, float(f(DNA_THRESHOLD1)),
            float(f(DNA_THRESHOLD2)), float(f(DNA_PEAK_HEIGHT)))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (sqrtf, __fsqrt_rn).  torch's
    vectorised CPU sqrt is not: it is an ulp off on about 0.7 % of f32
    inputs, so this takes NumPy's, the IEEE operation."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def prefix_sums(x: torch.Tensor):
    """Exclusive prefix sums (f64 [n+1]) of f32 samples and of their f32
    squares, accumulated in sample order (torch's CPU cumsum is a
    sequential loop, as the host detector's)."""
    n = x.shape[0]
    s = torch.zeros(n + 1, dtype=torch.float64)
    q = torch.zeros(n + 1, dtype=torch.float64)
    torch.cumsum(x.double(), 0, out=s[1:])
    torch.cumsum((x * x).double(), 0, out=q[1:])
    return s, q


def tstat_track(s: torch.Tensor, q: torch.Tensor, n: int, w: int):
    """One windowed t-stat track (f32 [n]), f5chost.cpp tstat_at."""
    t = torch.zeros(n, dtype=torch.float32)
    if n < 2 * w or w < 2:
        return t
    i = torch.arange(w, n - w)
    wf = torch.tensor(float(w), dtype=torch.float32)
    wd = float(w)
    sum1 = s[i] - s[i - w]
    sumsq1 = q[i] - q[i - w]
    sum2 = (s[i + w] - s[i]).float()
    sumsq2 = (q[i + w] - q[i]).float()
    mean1 = (sum1 / wd).float()
    mean2 = sum2 / wf
    cv = (((sumsq1 / wd) - (mean1 * mean1).double())
          + (sumsq2 / wf).double()) - (mean2 * mean2).double()
    cvf = cv.float()
    cvf = torch.where(cvf < FLT_MIN, torch.tensor(FLT_MIN), cvf)
    delta = mean2 - mean1
    sq = sqrt_rn(cvf / wf)
    t[i] = (delta.double().abs() / sq.double()).float()
    return t


def peak_scan(t1: list, t2: list, n: int, rna: bool) -> list:
    """The two coupled peak detectors over the t-stat tracks (python
    floats holding f32 values), the reference's per-sample loop
    (events.c:380-452): peak positions in emission order.  ``v - pv >
    ph`` is an f32 comparison: the f64 difference of two f32 values
    rounds to f32 as the direct f32 difference would, and it exceeds ph
    after that rounding exactly when it reaches ph's f32 successor or
    rounds above ph."""
    w1, w2, th1, th2, ph = detector_params(rna)
    nxt = float(np.nextafter(np.float32(ph), np.float32(np.inf)))
    f32 = np.float32
    h1, h2 = w1 // 2, w2 // 2
    peaks = []
    pp0 = pp1 = -1
    pv0 = pv1 = FLT_MAX
    val0 = val1 = False
    masked1 = 0
    for i in range(1, n):
        v = t1[i]
        if pp0 == -1:
            if v < pv0:
                pv0 = v
            else:
                d = v - pv0
                if d > ph and (d >= nxt or float(f32(d)) > ph):
                    pv0 = v
                    pp0 = i
        else:
            if v > pv0:
                pv0 = v
                pp0 = i
            if pv0 > th1:
                # the short detector resets and masks the long one
                masked1 = pp0 + w1
                pp1 = -1
                pv1 = FLT_MAX
                val1 = False
            d = pv0 - v
            if d > ph and (d >= nxt or float(f32(d)) > ph) and pv0 > th1:
                val0 = True
            if val0 and i - pp0 > h1:
                peaks.append(pp0)
                pp0 = -1
                pv0 = v
                val0 = False
        if masked1 >= i:
            continue
        v = t2[i]
        if pp1 == -1:
            if v < pv1:
                pv1 = v
            else:
                d = v - pv1
                if d > ph and (d >= nxt or float(f32(d)) > ph):
                    pv1 = v
                    pp1 = i
        else:
            if v > pv1:
                pv1 = v
                pp1 = i
            d = pv1 - v
            if d > ph and (d >= nxt or float(f32(d)) > ph) and pv1 > th2:
                val1 = True
            if val1 and i - pp1 > h2:
                peaks.append(pp1)
                pp1 = -1
                pv1 = v
                val1 = False
    return peaks


def events_from_bounds(s, q, bounds: torch.Tensor):
    """Events between consecutive bounds (f5c_events_from_peaks):
    (start i64, length, mean, stdv f32)."""
    starts, ends = bounds[:-1], bounds[1:]
    length = (ends - starts).float()
    mean = (s[ends] - s[starts]).float() / length
    dsq = (q[ends] - q[starts]).float()
    var = dsq / length - mean * mean
    stdv = sqrt_rn(torch.where(var > 0, var, torch.zeros_like(var)))
    return starts.clone(), length, mean, stdv


def detect_events_plain(pa_pool, sig_off, rna: bool):
    """Plain PyTorch version of csrc/events.cu: per read, the prefix sums,
    the t-stat tracks, the peak scan and the events, on the host (the
    sums and the scan are sequential), returned on ``pa_pool``'s device:
    (ev_off i64 [B+1], start i64 [E], length, mean, stdv f32 [E])."""
    dev = pa_pool.device
    pa = pa_pool.cpu()
    off = sig_off.cpu().tolist()
    w1, w2 = detector_params(rna)[:2]
    parts = []
    ev_off = [0]
    for b in range(len(off) - 1):
        x = pa[off[b]:off[b + 1]]
        n = x.shape[0]
        s, q = prefix_sums(x)
        t1 = tstat_track(s, q, n, w1).tolist()
        t2 = tstat_track(s, q, n, w2).tolist()
        peaks = [p for p in peak_scan(t1, t2, n, rna) if 0 < p < n]
        bounds = torch.tensor([0] + peaks + [n], dtype=torch.int64)
        parts.append(events_from_bounds(s, q, bounds))
        ev_off.append(ev_off[-1] + bounds.shape[0] - 1)
    if parts:
        outs = [torch.cat([p[j] for p in parts]) for j in range(4)]
    else:
        outs = [torch.zeros(0, dtype=torch.int64)] + [
            torch.zeros(0, dtype=torch.float32)] * 3
    return tuple(t.to(dev) for t in [torch.tensor(ev_off), *outs])
