"""Frozen copy of f5c_tpu/ops/events_ref.py at commit 5f95a86, part of the
benchmark's plain reference; imports rewritten to stand alone.

Event detection — NumPy reference implementation.

Segments a raw nanopore current trace (pA, float32) into "events": runs of
samples with approximately constant level, one per pore translocation step.
Algorithm (scrappie-style, see reference src/events.c):

1. prefix sums & sums-of-squares (float64 accumulators),
2. two windowed Welch t-statistic tracks (short & long window),
3. a two-detector peak-picking state machine over the t-stat tracks,
4. events = (start, length, mean, stdv) between consecutive peaks.

Note: the reference's ``getevents`` calls its trim helper but discards the
result (events.c:562-573 passes ``rt`` by value), so detection always runs
over the full signal; we reproduce that behaviour (no trim).

This module is the correctness oracle for the native host event detector
(``native/src/f5chost.cpp:f5c_detect_events``, the production path); it is
validated against the reference's ``--print-events`` fixture
(test/ecoli_2kb_region/single_read/read1.events.exp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import (
    DNA_PEAK_HEIGHT,
    DNA_THRESHOLD1,
    DNA_THRESHOLD2,
    DNA_WINDOW1,
    DNA_WINDOW2,
    RNA_PEAK_HEIGHT,
    RNA_THRESHOLD1,
    RNA_THRESHOLD2,
    RNA_WINDOW1,
    RNA_WINDOW2,
)

FLT_MAX = np.float32(np.finfo(np.float32).max)


@dataclass
class EventTable:
    start: np.ndarray   # int64 sample index
    length: np.ndarray  # float32 number of samples
    mean: np.ndarray    # float32 pA
    stdv: np.ndarray    # float32 pA

    @property
    def n(self) -> int:
        return int(self.start.shape[0])


def compute_sum_sumsq(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exclusive prefix sum / sum-of-squares with float64 accumulators."""
    d32 = data.astype(np.float32)
    n = d32.shape[0]
    sums = np.zeros(n + 1, dtype=np.float64)
    sumsqs = np.zeros(n + 1, dtype=np.float64)
    np.cumsum(d32.astype(np.float64), out=sums[1:])
    # the square is a float32 multiply in the reference (events.c:310),
    # only the accumulation is double
    np.cumsum((d32 * d32).astype(np.float64), out=sumsqs[1:])
    return sums, sumsqs


def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, d_length: int,
                  w_length: int) -> np.ndarray:
    """Windowed Welch t-statistic between the w samples before and after i.

    Mirrors the reference's mixed float/double arithmetic: window sums are
    float64, the left/right means and the deltas are rounded to float32
    before combining, the final t value is stored as float32.
    """
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w_length or w_length < 2:
        return tstat
    w = np.float32(w_length)
    idx = np.arange(w_length, d_length - w_length + 1)
    sum1 = sums[idx] - np.where(idx > w_length, sums[idx - w_length], 0.0)
    sumsq1 = sumsqs[idx] - np.where(idx > w_length, sumsqs[idx - w_length], 0.0)
    sum2 = (sums[idx + w_length] - sums[idx]).astype(np.float32)
    sumsq2 = (sumsqs[idx + w_length] - sumsqs[idx]).astype(np.float32)
    mean1 = (sum1 / w).astype(np.float32)
    mean2 = (sum2 / w).astype(np.float32)
    combined_var = (
        sumsq1 / w - (mean1 * mean1).astype(np.float64)
        + (sumsq2 / w).astype(np.float64) - (mean2 * mean2).astype(np.float64)
    ).astype(np.float32)
    combined_var = np.maximum(combined_var, np.float32(np.finfo(np.float32).tiny))
    delta_mean = mean2 - mean1
    t = np.abs(delta_mean.astype(np.float64)) / np.sqrt(
        (combined_var / w).astype(np.float32)
    )
    tstat[idx] = t.astype(np.float32)
    # boundary fudge: first/last w samples forced to zero (events.c:341-344)
    tstat[:w_length] = 0.0
    tstat[d_length - w_length:] = 0.0
    return tstat


def short_long_peak_detector(tstat1: np.ndarray, tstat2: np.ndarray,
                             threshold1: float, threshold2: float,
                             window1: int, window2: int,
                             peak_height: float) -> np.ndarray:
    """Two coupled peak detectors over the t-stat tracks (events.c:380-452).

    Sequential state machine; the short detector can mask the long one.
    Returns the array of peak positions (ascending).
    """
    n = tstat1.shape[0]
    peak_height = np.float32(peak_height)
    sig = (tstat1, tstat2)
    thresh = (np.float32(threshold1), np.float32(threshold2))
    wlen = (window1, window2)
    masked_to = [0, 0]
    peak_pos = [-1, -1]
    peak_value = [FLT_MAX, FLT_MAX]
    valid_peak = [False, False]

    peaks = []
    for i in range(n):
        for k in (0, 1):
            # masked_to starts at 0, so sample 0 is always skipped
            if masked_to[k] >= i:
                continue
            current_value = sig[k][i]
            if peak_pos[k] == -1:
                if current_value < peak_value[k]:
                    peak_value[k] = current_value
                elif current_value - peak_value[k] > peak_height:
                    peak_value[k] = current_value
                    peak_pos[k] = i
            else:
                if current_value > peak_value[k]:
                    peak_value[k] = current_value
                    peak_pos[k] = i
                if k == 0 and peak_value[0] > thresh[0]:
                    masked_to[1] = peak_pos[0] + wlen[0]
                    peak_pos[1] = -1
                    peak_value[1] = FLT_MAX
                    valid_peak[1] = False
                if (peak_value[k] - current_value > peak_height
                        and peak_value[k] > thresh[k]):
                    valid_peak[k] = True
                if valid_peak[k] and i - peak_pos[k] > wlen[k] // 2:
                    peaks.append(peak_pos[k])
                    peak_pos[k] = -1
                    peak_value[k] = current_value
                    valid_peak[k] = False
    return np.asarray(peaks, dtype=np.int64)


def events_from_peaks(peaks: np.ndarray, sums: np.ndarray, sumsqs: np.ndarray,
                      nsample: int) -> EventTable:
    """Build (start, length, mean, stdv) from peak boundaries (events.c:466-513)."""
    # the reference drops peaks at position 0 or >= nsample when counting
    peaks = peaks[(peaks > 0) & (peaks < nsample)]
    bounds = np.concatenate([[0], peaks, [nsample]]).astype(np.int64)
    starts = bounds[:-1]
    ends = bounds[1:]
    lengths = (ends - starts).astype(np.float32)
    means = ((sums[ends] - sums[starts]).astype(np.float32) / lengths)
    deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
    var = deltasqr / lengths - means * means
    stdv = np.sqrt(np.maximum(var, np.float32(0.0)))
    return EventTable(start=starts, length=lengths, mean=means, stdv=stdv)


def detect_events(signal_pa: np.ndarray, rna: bool = False) -> EventTable:
    """Full event-detection pipeline over a pA-scaled float32 signal."""
    if rna:
        w1, w2 = RNA_WINDOW1, RNA_WINDOW2
        t1, t2 = RNA_THRESHOLD1, RNA_THRESHOLD2
        ph = RNA_PEAK_HEIGHT
    else:
        w1, w2 = DNA_WINDOW1, DNA_WINDOW2
        t1, t2 = DNA_THRESHOLD1, DNA_THRESHOLD2
        ph = DNA_PEAK_HEIGHT
    n = signal_pa.shape[0]
    sums, sumsqs = compute_sum_sumsq(signal_pa)
    tstat1 = compute_tstat(sums, sumsqs, n, w1)
    tstat2 = compute_tstat(sums, sumsqs, n, w2)
    peaks = short_long_peak_detector(tstat1, tstat2, t1, t2, w1, w2, ph)
    return events_from_peaks(peaks, sums, sumsqs, n)
