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

import functools
import struct

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


def tracks_plain(pa_pool, sig_off, rna: bool):
    """The two t-stat tracks of a ragged batch (f32 [S] each, on the
    CPU), in the layout of csrc/events.cu's T1 and T2: what
    ``events_cuda.peaks_from_tracks`` takes."""
    pa = pa_pool.cpu()
    off = sig_off.cpu().tolist()
    w1, w2 = detector_params(rna)[:2]
    t1 = torch.zeros(pa.shape[0], dtype=torch.float32)
    t2 = torch.zeros(pa.shape[0], dtype=torch.float32)
    for a, b in zip(off[:-1], off[1:]):
        s, q = prefix_sums(pa[a:b])
        t1[a:b] = tstat_track(s, q, b - a, w1)
        t2[a:b] = tstat_track(s, q, b - a, w2)
    return t1, t2


# the detectors' state: (pp0, pv0, val0, pp1, pv1, val1, masked1)
PEAK_INIT = (-1, FLT_MAX, False, -1, FLT_MAX, False, 0)
# the chunked peak scan of csrc/events.cu: at least MIN_CHUNK samples a
# chunk, at most MAX_THREADS chunks (threads) a read
MIN_CHUNK = 32
MAX_THREADS = 1024


@functools.lru_cache(maxsize=2)
def _peak_params(rna: bool) -> tuple:
    """(w1, th1, th2, ph, ph's f32 successor, w1 // 2, w2 // 2)."""
    w1, w2, th1, th2, ph = detector_params(rna)
    nxt = float(np.nextafter(np.float32(ph), np.float32(np.inf)))
    return w1, th1, th2, ph, nxt, w1 // 2, w2 // 2


def peak_run(t1: list, t2: list, n: int, rna: bool, state: tuple, lo: int,
             hi: int, out: list) -> tuple:
    """The two coupled peak detectors over samples [lo, hi) of the t-stat
    tracks (python floats holding f32 values) from ``state``, the
    reference's per-sample loop (events.c:380-452): appends the peaks
    emitted, in emission order, to ``out`` and returns the end state.
    ``v - pv > ph`` is an f32 comparison: the f64 difference of two f32
    values rounds to f32 as the direct f32 difference would, and it
    exceeds ph after that rounding exactly when it reaches ph's f32
    successor or rounds above ph.  A mask that ends before ``hi`` masks
    no later sample, so the end state holds it as 0, the initial mask."""
    w1, th1, th2, ph, nxt, h1, h2 = _peak_params(rna)
    f32 = np.float32
    pp0, pv0, val0, pp1, pv1, val1, masked1 = state
    for i in range(lo, hi):
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
                if 0 < pp0 < n:
                    out.append(pp0)
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
                if 0 < pp1 < n:
                    out.append(pp1)
                pp1 = -1
                pv1 = v
                val1 = False
    return (pp0, pv0, val0, pp1, pv1, val1, masked1 if masked1 >= hi else 0)


def peak_scan(t1: list, t2: list, n: int, rna: bool) -> list:
    """The peak positions of a read in emission order: one ``peak_run``
    over samples [1, n) from the initial state."""
    peaks = []
    peak_run(t1, t2, n, rna, PEAK_INIT, 1, n, peaks)
    return peaks


def _bits(state: tuple) -> tuple:
    """A state as the kernel compares it: every field, pv as f32 bits."""
    return state[:1] + (struct.pack("<f", state[1]),) + state[2:4] + (
        struct.pack("<f", state[4]),) + state[5:]


def peak_threads(max_len: int) -> int:
    """csrc/events.cu's threads a block for a launch whose longest read
    has ``max_len`` samples: the largest power of two that leaves chunks
    of at least MIN_CHUNK samples, within [32, MAX_THREADS]."""
    c = max_len // MIN_CHUNK
    return min(MAX_THREADS, max(32, 1 << (c.bit_length() - 1) if c else 0))


def peak_chunk(n: int, threads: int) -> int:
    """The kernel's chunk length for a read of ``n`` samples in a block
    of ``threads``: samples [1, n) in at most ``threads`` chunks of at
    least MIN_CHUNK samples (one chunk when fewer)."""
    m = n - 1
    if m <= 0:
        return 1
    return -(-m // min(threads, max(1, m // MIN_CHUNK)))


def peak_scan_chunked(t1: list, t2: list, n: int, rna: bool, chunk: int):
    """A plain model of csrc/events.cu's chunk-parallel peak scan: returns
    (the peaks, in order, the rounds).  Chunk c holds samples [1 + c *
    chunk, 1 + (c + 1) * chunk) of [1, n).  Round 1 runs every chunk from
    the initial state; each later round re-runs, from its predecessor's
    end state of the round before, every chunk whose start state changed
    (the kernel checks them all; only a chunk whose predecessor re-ran can
    change), until none changes.  After round r chunks 0..r-1 are exact,
    so the fixed point comes within one round a chunk, on any input.
    From the fixed point's start states each chunk's emissions are
    counted (its last run's), offset by an exclusive scan of the counts
    and written by one more run of the chunk."""
    spans = [(lo, min(lo + chunk, n)) for lo in range(1, n, chunk)]
    starts = [PEAK_INIT] * len(spans)
    ends, counts = [None] * len(spans), [0] * len(spans)

    def run(c, out):
        ends[c] = peak_run(t1, t2, n, rna, starts[c], *spans[c], out)
        counts[c] = len(out)

    for c in range(len(spans)):
        run(c, [])
    rounds, ran = 1, range(len(spans))
    while True:
        new = {c + 1: ends[c] for c in ran if c + 1 < len(spans)
               and _bits(ends[c]) != _bits(starts[c + 1])}
        if not new:
            break
        rounds += 1
        for c, st in new.items():
            starts[c] = st
        for c in new:
            run(c, [])
        ran = list(new)
    peaks = []
    for c in range(len(spans)):
        out = []
        peak_run(t1, t2, n, rna, starts[c], *spans[c], out)
        if len(out) != counts[c]:
            raise AssertionError(f"chunk {c}: count and write disagree")
        peaks += out
    return peaks, rounds


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
        bounds = torch.tensor([0] + peak_scan(t1, t2, n, rna) + [n],
                              dtype=torch.int64)
        parts.append(events_from_bounds(s, q, bounds))
        ev_off.append(ev_off[-1] + bounds.shape[0] - 1)
    if parts:
        outs = [torch.cat([p[j] for p in parts]) for j in range(4)]
    else:
        outs = [torch.zeros(0, dtype=torch.int64)] + [
            torch.zeros(0, dtype=torch.float32)] * 3
    return tuple(t.to(dev) for t in [torch.tensor(ev_off), *outs])
