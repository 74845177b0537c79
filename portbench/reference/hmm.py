"""Frozen copy of f5c_tpu/ops/hmm_ref.py at commit 5f95a86, part of the
benchmark's plain reference; imports rewritten to stand alone.

Profile-HMM forward scorer — NumPy reference implementation.

Scores a reference subsequence (optionally with methylated 'M' bases)
against a window of events using a 3-state-per-kmer profile HMM
(MATCH / BAD_EVENT / KMER_SKIP) with soft-clip flanks.  The forward
log-probability difference between the methylated and unmethylated
sequence is the methylation log-likelihood ratio.

Algorithm parity: reference src/hmm.c (nanopolish HMM).  The reference
sums logs through a 16000-entry lookup table (logsum.h, 0.001-nat
precision); we use exact logaddexp in float64 — differences are far below
the output tolerance.  The kmer-skip state forms a within-row linear chain
(K_i depends on K_{i-1} of the same row); we vectorise it as a stable
log-cumsum-exp, which is also how the batched TPU kernel parallelises it.

Row layout: rows = events (+1), blocks = kmers; M/B/K vectors per row.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    HAF_ALLOW_POST_CLIP,
    HAF_ALLOW_PRE_CLIP,
    HMM_BACKGROUND_EMISSION,
    HMM_P_BAD,
    HMM_P_SKIP,
    HMM_P_SKIP_SELF,
    TRANS_CLIP_SELF,
    TRANS_START_TO_CLIP,
)

NEG_INF = -np.inf
LOG_INV_SQRT_2PI = np.float32(-0.918938)


def _logcumsumexp(x: np.ndarray) -> np.ndarray:
    """Stable cumulative logsumexp along the last axis (float64)."""
    m = np.max(x)
    if m == NEG_INF:
        return np.full_like(x, NEG_INF)
    with np.errstate(divide="ignore"):
        return np.log(np.cumsum(np.exp(x - m))) + m


def make_flanks(num_events: int) -> tuple[np.ndarray, np.ndarray]:
    """pre_flank[i]: prob of skipping the first i events; post_flank[i]:
    prob that event i was the last aligned (hmm.c:141-214)."""
    lp_sc = np.log(TRANS_START_TO_CLIP)          # log 0.5
    lp_nsc = np.log(1 - TRANS_START_TO_CLIP)
    lp_cs = np.log(TRANS_CLIP_SELF)              # log 0.9
    lp_ncs = np.log(1 - TRANS_CLIP_SELF)
    bg = HMM_BACKGROUND_EMISSION

    pre = np.zeros(num_events + 1, dtype=np.float64)
    pre[0] = lp_nsc
    if num_events >= 1:
        pre[1] = lp_sc + bg + lp_ncs
    for i in range(2, num_events + 1):
        pre[i] = lp_cs + bg + pre[i - 1]

    post = np.zeros(num_events, dtype=np.float64)
    post[num_events - 1] = lp_nsc
    if num_events > 1:
        post[num_events - 2] = lp_sc + bg + lp_ncs
        for i in range(num_events - 3, -1, -1):
            post[i] = lp_cs + bg + post[i + 1]
    return pre, post


def block_transitions(events_per_base: float) -> dict[str, float]:
    """Per-block transition log-probs (hmm.c:240-307); identical for all
    blocks of a read."""
    p_stay = 1 - (1 / events_per_base)
    p_skip = HMM_P_SKIP
    p_bad = HMM_P_BAD
    p_bad_self = p_bad
    p_skip_self = HMM_P_SKIP_SELF

    p_mk = p_skip
    p_mb = p_bad
    p_mm_self = p_stay
    p_mm_next = 1.0 - p_mm_self - p_mk - p_mb
    p_bb = p_bad_self
    p_bk = p_bm_next = p_bm_self = (1.0 - p_bb) / 3
    p_kk = p_skip_self
    p_km = 1.0 - p_kk
    return {
        "lp_mk": np.log(p_mk), "lp_mb": np.log(p_mb),
        "lp_mm_self": np.log(p_mm_self), "lp_mm_next": np.log(p_mm_next),
        "lp_bb": np.log(p_bb), "lp_bk": np.log(p_bk),
        "lp_bm_next": np.log(p_bm_next), "lp_bm_self": np.log(p_bm_self),
        "lp_kk": np.log(p_kk), "lp_km": np.log(p_km),
    }


def window_kmer_ranks(m_seq: str, m_rc_seq: str, rc: bool,
                      model: Model) -> np.ndarray:
    """k-mer ranks for the scored strand (hmm.c:384-401): forward strand
    reads m_seq left-to-right; reverse-complement strand reads m_rc_seq
    from the back."""
    k = model.k
    n_kmers = len(m_seq) - k + 1
    if not rc:
        return model.kmer_ranks(m_seq)
    seq_len = len(m_seq)
    ranks = np.empty(n_kmers, dtype=np.int64)
    all_rc = model.kmer_ranks(m_rc_seq)
    for ki in range(n_kmers):
        ranks[ki] = all_rc[seq_len - ki - k]
    return ranks


def profile_hmm_score(m_seq: str, m_rc_seq: str, event_means: np.ndarray,
                      scaling, model: Model, event_start_idx: int,
                      event_stop_idx: int, event_stride: int, rc: bool,
                      events_per_base: float,
                      hmm_flags: int = HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP
                      ) -> float:
    """Forward log-probability of the event window given the sequence."""
    k = model.k
    n_kmers = len(m_seq) - k + 1
    e_start = event_start_idx
    n_events = abs(event_stop_idx - event_start_idx) + 1

    ranks = window_kmer_ranks(m_seq, m_rc_seq, rc, model)
    t = block_transitions(events_per_base)
    pre_flank, post_flank = make_flanks(n_events)

    # emission parameters per block (calibrated scaling, hmm.c:73-109)
    scale32 = np.float32(scaling.scale)
    shift32 = np.float32(scaling.shift)
    var32 = np.float32(scaling.var)
    log_var32 = np.float32(np.log(var32))
    gp_mean = scale32 * model.level_mean[ranks] + shift32
    gp_stdv = model.level_stdv[ranks] * var32
    gp_log_stdv = model.level_log_stdv[ranks] + log_var32

    M = np.full(n_kmers, NEG_INF)
    B = np.full(n_kmers, NEG_INF)
    K = np.full(n_kmers, NEG_INF)
    lp_end = NEG_INF
    allow_pre = bool(hmm_flags & HAF_ALLOW_PRE_CLIP)
    allow_post = bool(hmm_flags & HAF_ALLOW_POST_CLIP)

    def shift_prev(x):
        return np.concatenate([[NEG_INF], x[:-1]])

    with np.errstate(invalid="ignore", over="ignore"):
        for row in range(1, n_events + 1):
            event_idx = e_start + (row - 1) * event_stride
            ev = np.float32(event_means[event_idx])
            a = (ev - gp_mean) / gp_stdv
            lp_em = (LOG_INV_SQRT_2PI - gp_log_stdv
                     + np.float32(-0.5) * a * a).astype(np.float64)

            Mp_prev = shift_prev(M)   # prev block, prev row
            Bp_prev = shift_prev(B)
            Kp_prev = shift_prev(K)

            terms = np.stack([
                t["lp_mm_self"] + M,
                t["lp_mm_next"] + Mp_prev,
                t["lp_bm_self"] + B,
                t["lp_bm_next"] + Bp_prev,
                t["lp_km"] + Kp_prev,
            ])
            m_new = np.logaddexp.reduce(terms, axis=0)
            # soft-start into the first kmer
            if allow_pre or event_idx == e_start:
                m_new[0] = np.logaddexp(m_new[0], pre_flank[row - 1])
            m_new = m_new + lp_em

            b_new = np.logaddexp(t["lp_mb"] + M, t["lp_bb"] + B)

            # kmer-skip chain within this row:
            # K_i = logsum(c_i, K_{i-1} + lp_kk)
            c = np.logaddexp(t["lp_mk"] + shift_prev(m_new),
                             t["lp_bk"] + shift_prev(b_new))
            idx = np.arange(n_kmers)
            d = c - idx * t["lp_kk"]
            k_new = idx * t["lp_kk"] + _logcumsumexp(d)

            M, B, K = m_new, b_new, k_new

            if allow_post or row == n_events:
                pf = post_flank[row - 1]
                lp_end = np.logaddexp(lp_end, M[-1] + pf)
                lp_end = np.logaddexp(lp_end, B[-1] + pf)
                lp_end = np.logaddexp(lp_end, K[-1] + pf)

    return float(lp_end)


# --- Viterbi (eventalign re-alignment) --------------------------------------
#
# Loop-faithful port of the reference's Viterbi fill + backtrace
# (profile_hmm_fill_generic_r9 with ProfileHMMViterbiOutputR9,
# src/hmm.c:313-533 + src/eventalign.c:625-920).  This is the oracle for
# the batched device kernel in ops/hmm.py.

# movement codes (hmm.c:124-133)
HMT_FROM_SAME_M = 0
HMT_FROM_PREV_M = 1
HMT_FROM_SAME_B = 2
HMT_FROM_PREV_B = 3
HMT_FROM_PREV_K = 4
HMT_FROM_SOFT = 5

# state indices within a block (hmm.c:115-121)
PSR9_KMER_SKIP = 0
PSR9_BAD_EVENT = 1
PSR9_MATCH = 2


def profile_hmm_viterbi(m_seq: str, m_rc_seq: str, event_means: np.ndarray,
                        scaling, model: Model, e_start: int, e_end: int,
                        event_stride: int, rc: bool,
                        events_per_base: float, hmm_flags: int = 0):
    """Viterbi alignment of an event window to a sequence window.

    Returns a list of (event_idx, kmer_idx, state_char) in forward order —
    the reference's HMMAlignmentState vector (eventalign.c:818-916).
    """
    k = model.k
    n_kmers = len(m_seq) - k + 1
    n_events = abs(e_end - e_start) + 1
    n_rows = n_events + 1
    n_states = 3 * (n_kmers + 2)

    ranks = window_kmer_ranks(m_seq, m_rc_seq, rc, model)
    t = block_transitions(events_per_base)
    pre_flank, post_flank = make_flanks(n_events)

    scale32 = np.float32(scaling.scale)
    shift32 = np.float32(scaling.shift)
    var32 = np.float32(scaling.var)
    log_var32 = np.float32(np.log(var32))
    gp_mean = scale32 * model.level_mean[ranks] + shift32
    gp_stdv = model.level_stdv[ranks] * var32
    gp_log_stdv = model.level_log_stdv[ranks] + log_var32

    allow_pre = bool(hmm_flags & HAF_ALLOW_PRE_CLIP)

    vm = np.full((n_rows, n_states), NEG_INF, dtype=np.float32)
    bm = np.zeros((n_rows, n_states), dtype=np.uint8)

    def cell(row, block, state):
        return vm[row, 3 * block + state]

    with np.errstate(invalid="ignore", over="ignore"):
        for row in range(1, n_rows):
            event_idx = e_start + (row - 1) * event_stride
            ev = np.float32(event_means[event_idx])
            for block in range(1, n_kmers + 1):
                kmer_idx = block - 1
                a = (ev - gp_mean[kmer_idx]) / gp_stdv[kmer_idx]
                lp_em_m = np.float32(
                    LOG_INV_SQRT_2PI - gp_log_stdv[kmer_idx]
                    + np.float32(-0.5) * a * a)
                prev_off = 3 * (block - 1)
                curr_off = 3 * block

                # MATCH
                scores = np.array([
                    t["lp_mm_self"] + vm[row - 1, curr_off + PSR9_MATCH],
                    t["lp_mm_next"] + vm[row - 1, prev_off + PSR9_MATCH],
                    t["lp_bm_self"] + vm[row - 1, curr_off + PSR9_BAD_EVENT],
                    t["lp_bm_next"] + vm[row - 1, prev_off + PSR9_BAD_EVENT],
                    t["lp_km"] + vm[row - 1, prev_off + PSR9_KMER_SKIP],
                    pre_flank[row - 1]
                    if kmer_idx == 0 and (event_idx == e_start or allow_pre)
                    else NEG_INF,
                ], dtype=np.float32)
                mx = scores.max()
                frm = np.nonzero(scores == mx)[0][-1]  # last equal wins
                vm[row, curr_off + PSR9_MATCH] = mx + lp_em_m
                bm[row, curr_off + PSR9_MATCH] = frm

                # BAD_EVENT (emission penalty 0)
                s_m = t["lp_mb"] + vm[row - 1, curr_off + PSR9_MATCH]
                s_b = t["lp_bb"] + vm[row - 1, curr_off + PSR9_BAD_EVENT]
                if s_b >= s_m:
                    vm[row, curr_off + PSR9_BAD_EVENT] = s_b
                    bm[row, curr_off + PSR9_BAD_EVENT] = HMT_FROM_SAME_B
                else:
                    vm[row, curr_off + PSR9_BAD_EVENT] = s_m
                    bm[row, curr_off + PSR9_BAD_EVENT] = HMT_FROM_SAME_M

                # KMER_SKIP (same row, previous block; silent)
                s1 = t["lp_mk"] + vm[row, prev_off + PSR9_MATCH]
                s2 = t["lp_bk"] + vm[row, prev_off + PSR9_BAD_EVENT]
                s3 = t["lp_kk"] + vm[row, prev_off + PSR9_KMER_SKIP]
                mx = max(s1, s2, s3)
                if s3 == mx:
                    frm = HMT_FROM_PREV_K
                elif s2 == mx:
                    frm = HMT_FROM_PREV_B
                else:
                    frm = HMT_FROM_PREV_M
                vm[row, curr_off + PSR9_KMER_SKIP] = mx
                bm[row, curr_off + PSR9_KMER_SKIP] = frm

    # backtrace from the last event row, MATCH state of the last kmer block
    # (eventalign.c:824-916); walk until row 0 or a FROM_SOFT movement
    alignment = []
    row = n_rows - 1
    col = 3 * n_kmers + PSR9_MATCH
    while row > 0:
        event_idx = e_start + (row - 1) * event_stride
        block = col // 3
        kmer_idx = block - 1
        curr_ps = col % 3
        state_char = "KBM"[curr_ps]
        alignment.append((event_idx, kmer_idx, state_char))
        movement = bm[row, col]
        if movement == HMT_FROM_SOFT:
            break
        if movement in (HMT_FROM_PREV_M, HMT_FROM_PREV_B, HMT_FROM_PREV_K):
            kmer_idx -= 1
        next_ps = {HMT_FROM_SAME_M: PSR9_MATCH, HMT_FROM_PREV_M: PSR9_MATCH,
                   HMT_FROM_SAME_B: PSR9_BAD_EVENT,
                   HMT_FROM_PREV_B: PSR9_BAD_EVENT,
                   HMT_FROM_PREV_K: PSR9_KMER_SKIP}[int(movement)]
        if curr_ps != PSR9_KMER_SKIP:
            row -= 1
        col = 3 * (kmer_idx + 1) + next_ps
    alignment.reverse()
    return alignment
