"""Frozen copy of f5c_tpu/ops/abea_ref.py at commit 5f95a86, part of the
benchmark's plain reference; imports rewritten to stand alone, and
``align`` is the copied ``align_plain`` rearranged for speed (its
docstring says how).

Adaptive Banded Event Alignment (ABEA) — NumPy reference implementation.

Aligns a read's event sequence to its base-called k-mer sequence with a
banded DP (band width 100) whose band placement adapts per step (Suzuki's
rule: move the band down or right depending on which band edge scores
better).  Produces (kmer_idx, event_idx) aligned pairs via backtrace, plus
the method-of-moments scaling estimate, the base->event map, and the
least-squares scaling recalibration that follow it.

Semantics follow the reference CPU path (src/align.c) including its
float32/float64 mixing, tie-breaking (skip > stay > step on equal scores),
QC thresholds, and the band-placement parity rule, so outputs are
comparable to the ``adaptive.exp`` / ``est_scalings.exp`` /
``recalib_scalings.exp`` fixtures.

This is the correctness oracle for the batched Pallas kernel in ``abea.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import (
    ABEA_EPSILON_SKIP,
    ABEA_LP_TRIM_P,
    ABEA_MAX_GAP_THRESHOLD,
    ABEA_MIN_AVG_LOG_EMISSION,
    ALN_BANDWIDTH,
)

NEG_INF = np.float32(-np.inf)
LOG_INV_SQRT_2PI = np.float32(-0.918938)

FROM_D, FROM_U, FROM_L = 0, 1, 2
# bands whose emissions ``align`` computes at once
CHUNK = 64


@dataclass
class Scalings:
    shift: float = 0.0
    scale: float = 1.0
    var: float = 1.0

    @property
    def log_var(self) -> float:
        return float(np.log(np.float32(self.var)))


def estimate_scalings_using_mom(seq: str, model: Model,
                                event_means: np.ndarray,
                                debug_lines: list | None = None) -> Scalings:
    """Method-of-moments shift/scale estimate (align.c:58-106).

    shift = mean(event levels) - mean(model levels over read k-mers);
    scale = var-ratio of (shifted) event levels to model levels.
    """
    n_kmers = len(seq) - model.k + 1
    ranks = model.kmer_ranks(seq)
    levels = model.level_mean[ranks].astype(np.float64)
    ev = event_means.astype(np.float64)
    event_level_sum = ev.sum()
    kmer_level_sum = levels.sum()
    kmer_level_sq_sum = (levels * levels).sum()
    shift = event_level_sum / ev.shape[0] - kmer_level_sum / n_kmers
    event_level_sq_sum = ((ev - shift) ** 2).sum()
    scale = (event_level_sq_sum / ev.shape[0]) / (kmer_level_sq_sum / n_kmers)
    if debug_lines is not None:
        debug_lines.append(
            f"event mean: {event_level_sum / ev.shape[0]:.2f} "
            f"kmer mean: {kmer_level_sum / n_kmers:.2f} "
            f"shift: {np.float32(shift):.2f}"
        )
        debug_lines.append(
            f"event sq-mean: {event_level_sq_sum / ev.shape[0]:.2f} "
            f"kmer sq-mean: {kmer_level_sq_sum / n_kmers:.2f} "
            f"scale: {np.float32(scale):.2f}"
        )
    return Scalings(shift=float(np.float32(shift)),
                    scale=float(np.float32(scale)), var=1.0)


def _log_prob_match(event_mean_f32: np.ndarray, rank, model: Model,
                    scale32: np.float32, shift32: np.float32) -> np.ndarray:
    """float32 Gaussian log-pdf of event level vs scaled model level
    (align.c:108-154; var fixed at 1 during ABEA)."""
    gp_mean = scale32 * model.level_mean[rank] + shift32
    gp_stdv = model.level_stdv[rank]
    gp_log_stdv = model.level_log_stdv[rank]
    a = (event_mean_f32 - gp_mean) / gp_stdv
    return (LOG_INV_SQRT_2PI - gp_log_stdv
            + np.float32(-0.5) * a * a).astype(np.float32)


@dataclass
class AbeaResult:
    pairs: np.ndarray            # (n,2) int32: (kmer_idx, event_idx) ascending
    sum_emission: float          # QC: sum of emissions along the path
    n_aligned: int               # QC: path length before QC rejection
    avg_log_emission: float
    failed: bool                 # QC rejected -> pairs is empty


def align(seq: str, event_means: np.ndarray, model: Model,
          scaling: Scalings) -> AbeaResult:
    """ABEA (align.c:180-559): returns backtraced aligned pairs + QC.

    ``align_plain``'s arithmetic and order, rearranged for speed (the
    benchmark's change to the oracle; the tests hold the two equal):
    only the last three bands are kept, in float64 with two cells of
    -inf on either side, so that a band's moves read shifted slices; the
    emissions are computed CHUNK bands at a time for every cell those
    bands can reach; and a cell's move is coded FROM_D 0, FROM_U 1 and
    FROM_L 2 or 3."""
    k = model.k
    n_events = int(event_means.shape[0])
    n_kmers = len(seq) - k + 1
    bandwidth = ALN_BANDWIDTH
    half = bandwidth // 2

    events_per_kmer = n_events / n_kmers
    p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0))
    lp_skip = float(np.log(ABEA_EPSILON_SKIP))
    lp_stay = float(np.log(p_stay))
    lp_step = float(np.log(1.0 - ABEA_EPSILON_SKIP - p_stay))
    lp_trim = float(np.log(ABEA_LP_TRIM_P))

    n_bands = n_events + 1 + n_kmers + 1

    kmer_ranks = model.kmer_ranks(seq)
    ev32 = event_means.astype(np.float32)
    scale32 = np.float32(scaling.scale)
    shift32 = np.float32(scaling.shift)
    # _log_prob_match's float32 terms, by k-mer index, and the events in
    # reverse, so that a band's cells read contiguous slices of both
    gp_mean = scale32 * model.level_mean[kmer_ranks] + shift32
    gp_stdv = model.level_stdv[kmer_ranks]
    gp_c = LOG_INV_SQRT_2PI - model.level_log_stdv[kmer_ranks]
    half32 = np.float32(-0.5)
    neg_inf = float("-inf")

    # the last three bands, in float64 (the float32 scores, exact), with
    # two cells of -inf on either side; every band's trace; and each
    # band's score in the last k-mer's column, where the backtrace starts
    rows = np.full((3, bandwidth + 4), neg_inf)
    row_of = [rows[0], rows[1], rows[2]]
    trace = np.zeros((n_bands, bandwidth), dtype=np.uint8)
    trace_flat = trace.reshape(-1)
    last_col = [neg_inf] * n_bands
    ll_event = [0] * n_bands
    ll_kmer = [0] * n_bands
    ll_event[0] = half - 1
    ll_kmer[0] = -1 - half
    ll_event[1] = ll_event[0] + 1
    ll_kmer[1] = ll_kmer[0]

    rows[0, -1 - ll_kmer[0] + 2] = 0.0
    first_trim_off = ll_event[1] - 0
    rows[1, first_trim_off + 2] = float(np.float32(lp_trim))
    trace[1, first_trim_off] = FROM_U
    for bi in (0, 1):
        off = n_kmers - 1 - ll_kmer[bi]
        if 0 <= off < bandwidth:
            last_col[bi] = rows[bi, off + 2].item()

    chunk_end = 2
    for bi in range(2, n_bands):
        if bi == chunk_end:
            # the emissions of the next CHUNK bands, in float64: every
            # cell they can reach, from the k-mer where band bi - 1 lies
            b0, k0 = bi, ll_kmer[bi - 1]
            chunk_end = min(bi + CHUNK, n_bands)
            kk = np.arange(CHUNK + bandwidth)
            ki = np.clip(k0 + kk, 0, n_kmers - 1)
            ei = np.clip(np.arange(b0 - 2 - k0, b0 - 2 - k0 + CHUNK)[:, None]
                         - kk, 0, n_events - 1)
            a = ev32[ei] - gp_mean[ki]
            a /= gp_stdv[ki]
            em = a * half32
            em *= a
            em += gp_c[ki]
            emission = em.astype(np.float64).reshape(-1)
            e_stride = CHUNK + bandwidth
        prev = row_of[(bi - 1) % 3]
        prev2 = row_of[(bi - 2) % 3]
        cur = row_of[bi % 3]
        le1, lk1 = ll_event[bi - 1], ll_kmer[bi - 1]
        ll = prev.item(2)
        ur = prev.item(bandwidth + 1)
        if ll == neg_inf and ur == neg_inf:
            right = bi % 2 == 1
        else:
            right = ll < ur
        if right:
            le, lk = le1, lk1 + 1
        else:
            le, lk = le1 + 1, lk1
        ll_event[bi] = le
        ll_kmer[bi] = lk
        cur.fill(neg_inf)

        trim_off = -1 - lk
        if 0 <= trim_off < bandwidth:
            ev_idx = le - trim_off
            if 0 <= ev_idx < n_events:
                cur[trim_off + 2] = float(np.float32(lp_trim * (ev_idx + 1)))
                trace[bi, trim_off] = FROM_U

        min_off = max(-lk, le - (n_events - 1), 0)
        max_off = min(n_kmers - lk, le + 1, bandwidth)
        if min_off < max_off:
            s_up = le1 - le + 3
            s_left = lk - lk1 + 1
            s_diag = lk - ll_kmer[bi - 2] + 1
            c0 = (bi - b0) * e_stride + lk + min_off - k0
            em64 = emission[c0:c0 + max_off - min_off]
            sd = prev2[min_off + s_diag:max_off + s_diag] + lp_step
            sd += em64
            su = prev[min_off + s_up:max_off + s_up] + lp_stay
            su += em64
            sl = prev[min_off + s_left:max_off + s_left] + lp_skip
            sd = sd.astype(np.float32)
            su = su.astype(np.float32)
            sl = sl.astype(np.float32)
            upd = su >= sd          # ties pick U over D
            mx = np.maximum(su, sd)
            upl = sl >= mx          # ties pick L
            np.maximum(sl, mx, out=cur[min_off + 2:max_off + 2])
            # FROM_D 0, FROM_U 1, FROM_L 2 or 3 (the backtrace reads any
            # code above FROM_U as FROM_L)
            t0 = bi * bandwidth
            tr = trace_flat[t0 + min_off:t0 + max_off]
            np.left_shift(upl, 1, out=tr, casting="unsafe")
            tr |= upd
        off = n_kmers - 1 - lk
        if 0 <= off < bandwidth:
            last_col[bi] = cur.item(off + 2)

    # --- backtrace (align.c:412-523) ---
    curr_kmer_idx = n_kmers - 1
    max_score = -np.inf
    curr_event_idx = 0
    for event_idx in range(n_events):
        bi = (event_idx + 1) + (curr_kmer_idx + 1)
        offset = ll_event[bi] - event_idx
        if 0 <= offset < bandwidth:
            s = last_col[bi] + (n_events - event_idx) * lp_trim
            if s > max_score:
                max_score = s
                curr_event_idx = event_idx

    pairs = []
    n_aligned = 0
    curr_gap = 0
    max_gap = 0
    while curr_kmer_idx >= 0 and curr_event_idx >= 0:
        pairs.append((curr_kmer_idx, curr_event_idx))
        n_aligned += 1
        bi = (curr_event_idx + 1) + (curr_kmer_idx + 1)
        f = trace[bi, ll_event[bi] - curr_event_idx]
        if f == FROM_D:
            curr_kmer_idx -= 1
            curr_event_idx -= 1
            curr_gap = 0
        elif f == FROM_U:
            curr_event_idx -= 1
            curr_gap = 0
        else:
            curr_kmer_idx -= 1
            curr_gap += 1
            max_gap = max(curr_gap, max_gap)
    path = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    sum_emission = 0.0
    for v in _log_prob_match(ev32[path[:, 1]], kmer_ranks[path[:, 0]], model,
                             scale32, shift32).tolist():
        sum_emission += v
    pairs.reverse()
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    avg_log_emission = sum_emission / n_aligned if n_aligned else 0.0
    spanned = (pairs.shape[0] > 0 and pairs[0, 0] == 0
               and pairs[-1, 0] == n_kmers - 1)
    failed = (avg_log_emission < ABEA_MIN_AVG_LOG_EMISSION or not spanned
              or max_gap > ABEA_MAX_GAP_THRESHOLD)
    return AbeaResult(
        pairs=np.zeros((0, 2), dtype=np.int32) if failed else pairs,
        sum_emission=sum_emission, n_aligned=n_aligned,
        avg_log_emission=avg_log_emission, failed=failed)


def align_plain(seq: str, event_means: np.ndarray, model: Model,
          scaling: Scalings) -> AbeaResult:
    """ABEA (align.c:180-559): returns backtraced aligned pairs + QC.
    The oracle as copied: the tests hold ``align`` to it."""
    k = model.k
    n_events = int(event_means.shape[0])
    n_kmers = len(seq) - k + 1
    bandwidth = ALN_BANDWIDTH
    half = bandwidth // 2

    events_per_kmer = n_events / n_kmers
    p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0))
    lp_skip = np.log(ABEA_EPSILON_SKIP)
    lp_stay = np.log(p_stay)
    lp_step = np.log(1.0 - ABEA_EPSILON_SKIP - p_stay)
    lp_trim = np.log(ABEA_LP_TRIM_P)

    n_bands = n_events + 1 + n_kmers + 1

    kmer_ranks = model.kmer_ranks(seq)
    ev32 = event_means.astype(np.float32)

    bands = np.full((n_bands, bandwidth), NEG_INF, dtype=np.float32)
    trace = np.zeros((n_bands, bandwidth), dtype=np.uint8)
    # lower-left (event_idx, kmer_idx) per band
    ll_event = np.zeros(n_bands, dtype=np.int64)
    ll_kmer = np.zeros(n_bands, dtype=np.int64)
    ll_event[0] = half - 1
    ll_kmer[0] = -1 - half
    ll_event[1] = ll_event[0] + 1
    ll_kmer[1] = ll_kmer[0]

    # band 0: start cell; band 1: first trim state
    start_off = -1 - ll_kmer[0]
    bands[0, start_off] = 0.0
    first_trim_off = ll_event[1] - 0
    bands[1, first_trim_off] = np.float32(lp_trim)
    trace[1, first_trim_off] = FROM_U

    scale32 = np.float32(scaling.scale)
    shift32 = np.float32(scaling.shift)
    offsets = np.arange(bandwidth)

    for bi in range(2, n_bands):
        ll = bands[bi - 1, 0]
        ur = bands[bi - 1, bandwidth - 1]
        ll_ob = ll == NEG_INF
        ur_ob = ur == NEG_INF
        if ll_ob and ur_ob:
            right = bi % 2 == 1
        else:
            right = bool(ll < ur)
        if right:
            ll_event[bi] = ll_event[bi - 1]
            ll_kmer[bi] = ll_kmer[bi - 1] + 1
        else:
            ll_event[bi] = ll_event[bi - 1] + 1
            ll_kmer[bi] = ll_kmer[bi - 1]

        # trim state (kmer -1) column
        trim_off = -1 - ll_kmer[bi]
        if 0 <= trim_off < bandwidth:
            ev_idx = ll_event[bi] - trim_off
            if 0 <= ev_idx < n_events:
                bands[bi, trim_off] = np.float32(lp_trim * (ev_idx + 1))
                trace[bi, trim_off] = FROM_U
            else:
                bands[bi, trim_off] = NEG_INF

        kmer_min_off = 0 - ll_kmer[bi]
        kmer_max_off = n_kmers - ll_kmer[bi]
        event_min_off = ll_event[bi] - (n_events - 1)
        event_max_off = ll_event[bi] + 1
        min_off = max(kmer_min_off, event_min_off, 0)
        max_off = min(kmer_max_off, event_max_off, bandwidth)
        if min_off >= max_off:
            continue

        off = offsets[min_off:max_off]
        event_idx = ll_event[bi] - off
        kmer_idx = ll_kmer[bi] + off
        ranks = kmer_ranks[kmer_idx]

        offset_up = ll_event[bi - 1] - (event_idx - 1)
        offset_left = (kmer_idx - 1) - ll_kmer[bi - 1]
        offset_diag = (kmer_idx - 1) - ll_kmer[bi - 2]

        def gather(row, offs):
            valid = (offs >= 0) & (offs < bandwidth)
            vals = np.where(valid, bands[row, np.clip(offs, 0, bandwidth - 1)],
                            NEG_INF)
            return vals

        up = gather(bi - 1, offset_up)
        left = gather(bi - 1, offset_left)
        diag = gather(bi - 2, offset_diag)

        lp_emission = _log_prob_match(ev32[event_idx], ranks, model,
                                      scale32, shift32)
        # double-precision adds, truncated to float32 on store (align.c:382-406)
        score_d = (diag.astype(np.float64) + lp_step
                   + lp_emission.astype(np.float64)).astype(np.float32)
        score_u = (up.astype(np.float64) + lp_stay
                   + lp_emission.astype(np.float64)).astype(np.float32)
        score_l = (left.astype(np.float64) + lp_skip).astype(np.float32)

        max_score = score_d
        frm = np.full(off.shape, FROM_D, dtype=np.uint8)
        upd = score_u >= max_score      # ties pick U over D
        max_score = np.where(upd, score_u, max_score)
        frm = np.where(max_score == score_u, FROM_U, frm)
        upd = score_l >= max_score      # ties pick L
        max_score = np.where(upd, score_l, max_score)
        frm = np.where(max_score == score_l, FROM_L, frm)

        bands[bi, min_off:max_off] = max_score
        trace[bi, min_off:max_off] = frm

    # --- backtrace (align.c:412-523) ---
    curr_kmer_idx = n_kmers - 1
    max_score = -np.inf
    curr_event_idx = 0
    for event_idx in range(n_events):
        bi = (event_idx + 1) + (curr_kmer_idx + 1)
        offset = ll_event[bi] - event_idx
        if 0 <= offset < bandwidth:
            s = float(bands[bi, offset]) + (n_events - event_idx) * lp_trim
            if s > max_score:
                max_score = s
                curr_event_idx = event_idx

    pairs = []
    sum_emission = 0.0
    n_aligned = 0
    curr_gap = 0
    max_gap = 0
    while curr_kmer_idx >= 0 and curr_event_idx >= 0:
        pairs.append((curr_kmer_idx, curr_event_idx))
        rank = kmer_ranks[curr_kmer_idx]
        sum_emission += float(_log_prob_match(
            ev32[curr_event_idx], rank, model, scale32, shift32))
        n_aligned += 1
        bi = (curr_event_idx + 1) + (curr_kmer_idx + 1)
        offset = ll_event[bi] - curr_event_idx
        f = trace[bi, offset]
        if f == FROM_D:
            curr_kmer_idx -= 1
            curr_event_idx -= 1
            curr_gap = 0
        elif f == FROM_U:
            curr_event_idx -= 1
            curr_gap = 0
        else:
            curr_kmer_idx -= 1
            curr_gap += 1
            max_gap = max(curr_gap, max_gap)
    pairs.reverse()
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    avg_log_emission = sum_emission / n_aligned if n_aligned else 0.0
    spanned = (pairs.shape[0] > 0 and pairs[0, 0] == 0
               and pairs[-1, 0] == n_kmers - 1)
    failed = (avg_log_emission < ABEA_MIN_AVG_LOG_EMISSION or not spanned
              or max_gap > ABEA_MAX_GAP_THRESHOLD)
    return AbeaResult(
        pairs=np.zeros((0, 2), dtype=np.int32) if failed else pairs,
        sum_emission=sum_emission,
        n_aligned=n_aligned,
        avg_log_emission=avg_log_emission,
        failed=failed,
    )


@dataclass
class PostalignResult:
    base_to_event_start: np.ndarray  # int32[n_kmers], -1 = no event
    base_to_event_stop: np.ndarray
    events_per_base: float
    # calibration records: ('M' or 'E', kmer_idx, event_idx)
    hmm_states: np.ndarray           # uint8: 1 for M, 0 for E
    cal_kmer_idx: np.ndarray
    cal_event_idx: np.ndarray


def postalign(pairs: np.ndarray, seq: str, n_kmers: int,
              model: Model) -> PostalignResult:
    """Aligned pairs -> base-to-event map + calibration records
    (align.c:561-661)."""
    start = np.full(n_kmers, -1, dtype=np.int32)
    stop = np.full(n_kmers, -1, dtype=np.int32)
    max_event, min_event = 0, np.iinfo(np.int32).max
    prev_event = -1
    for k_idx, event_idx in pairs:
        if event_idx != prev_event:
            if start[k_idx] == -1:
                start[k_idx] = event_idx
            stop[k_idx] = event_idx
        max_event = max(max_event, event_idx)
        min_event = min(min_event, event_idx)
        prev_event = event_idx
    events_per_base = float(max_event - min_event) / n_kmers

    ranks = model.kmer_ranks(seq)
    states, cal_k, cal_e = [], [], []
    prev_rank = -1
    for ki in range(n_kmers):
        if start[ki] == -1:
            continue
        rank = int(ranks[ki])
        for event_idx in range(int(start[ki]), int(stop[ki]) + 1):
            states.append(1 if prev_rank != rank else 0)
            cal_k.append(ki)
            cal_e.append(event_idx)
            prev_rank = rank
    return PostalignResult(
        base_to_event_start=start,
        base_to_event_stop=stop,
        events_per_base=events_per_base,
        hmm_states=np.asarray(states, dtype=np.uint8),
        cal_kmer_idx=np.asarray(cal_k, dtype=np.int32),
        cal_event_idx=np.asarray(cal_e, dtype=np.int32),
    )


def recalibrate_model(model: Model, event_means: np.ndarray,
                      post: PostalignResult, seq: str,
                      min_num_events_to_rescale: int = 200
                      ) -> tuple[bool, Scalings]:
    """Weighted least squares re-fit of (shift, scale) on match-state events
    + residual var (align.c:666-773)."""
    ranks = model.kmer_ranks(seq)
    m_mask = post.hmm_states == 1
    num_m = int(m_mask.sum())
    if num_m < min_num_events_to_rescale:
        return False, Scalings()
    rk = ranks[post.cal_kmer_idx[m_mask]]
    e = event_means[post.cal_event_idx[m_mask]].astype(np.float64)
    mu = model.level_mean[rk].astype(np.float64)
    stdv = model.level_stdv[rk].astype(np.float64)
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
