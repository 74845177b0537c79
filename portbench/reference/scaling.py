"""Frozen copy of f5c_tpu/ops/scaling.py at commit 5f95a86, part of the
benchmark's plain reference; imports rewritten to stand alone.

Vectorised postalign + recalibration (host fast path).

Same semantics as the loop-faithful versions in ``abea_ref`` (which remain
the test oracle), but NumPy-vectorised: the batch layer runs these over
device-returned ABEA pairs without per-event Python loops.
"""

from __future__ import annotations

import numpy as np

from .abea import PostalignResult, Scalings


def postalign_np(pairs: np.ndarray, ranks: np.ndarray,
                 n_kmers: int) -> PostalignResult:
    """Aligned pairs (ascending) -> base-to-event map + calibration records.

    Equivalent to abea_ref.postalign but O(n) numpy.
    """
    k_idx = pairs[:, 0].astype(np.int64)
    e_idx = pairs[:, 1].astype(np.int64)
    n = k_idx.shape[0]
    start = np.full(n_kmers, -1, dtype=np.int32)
    stop = np.full(n_kmers, -1, dtype=np.int32)
    if n == 0:
        return PostalignResult(start, stop, 0.0,
                               np.zeros(0, np.uint8), np.zeros(0, np.int32),
                               np.zeros(0, np.int32))
    # pairs whose event differs from the previous pair's event
    new_event = np.ones(n, dtype=bool)
    new_event[1:] = e_idx[1:] != e_idx[:-1]
    vk = k_idx[new_event]
    ve = e_idx[new_event]
    # events per kmer appear in ascending order along the path
    big = np.iinfo(np.int32).max
    smin = np.full(n_kmers, big, dtype=np.int64)
    np.minimum.at(smin, vk, ve)
    smax = np.full(n_kmers, -1, dtype=np.int64)
    np.maximum.at(smax, vk, ve)
    has = smax >= 0
    start[has] = smin[has]
    stop[has] = smax[has]
    events_per_base = float(e_idx.max() - e_idx.min()) / n_kmers

    # calibration records: expand [start, stop] per kmer-with-events
    kk = np.nonzero(has)[0]
    lens = (smax[kk] - smin[kk] + 1).astype(np.int64)
    total = int(lens.sum())
    cal_k = np.repeat(kk, lens).astype(np.int32)
    # arange within segments
    seg_ends = np.cumsum(lens)
    seg_starts = seg_ends - lens
    offs = np.arange(total, dtype=np.int64) - np.repeat(seg_starts, lens)
    cal_e = (np.repeat(smin[kk], lens) + offs).astype(np.int32)
    r = ranks[cal_k]
    states = np.ones(total, dtype=np.uint8)
    states[1:] = (r[1:] != r[:-1]).astype(np.uint8)
    return PostalignResult(start, stop, events_per_base, states, cal_k,
                           cal_e)


def recalibrate_np(level_mean: np.ndarray, level_stdv: np.ndarray,
                   ranks: np.ndarray, event_means: np.ndarray,
                   post: PostalignResult,
                   min_num_events_to_rescale: int = 200
                   ) -> tuple[bool, Scalings]:
    """Weighted least-squares (shift, scale) + residual var on M events."""
    m = post.hmm_states == 1
    num_m = int(m.sum())
    if num_m < min_num_events_to_rescale:
        return False, Scalings()
    rk = ranks[post.cal_kmer_idx[m]]
    e = event_means[post.cal_event_idx[m]].astype(np.float64)
    mu = level_mean[rk].astype(np.float64)
    stdv = level_stdv[rk].astype(np.float64)
    inv_var = 1.0 / (stdv * stdv)
    A00 = inv_var.sum()
    A01 = (mu * inv_var).sum()
    A11 = (mu * mu * inv_var).sum()
    b0 = (e * inv_var).sum()
    b1 = (mu * e * inv_var).sum()
    div = A00 * A11 - A01 * A01
    shift = -(A01 * b1 - A11 * b0) / div
    scale = (A00 * b1 - A01 * b0) / div
    yi = e - shift - scale * mu
    var = np.sqrt(((yi * yi) * inv_var).sum() / num_m)
    return True, Scalings(shift=float(np.float32(shift)),
                          scale=float(np.float32(scale)),
                          var=float(np.float32(var)))
