"""eventalign's re-alignment of one read and its m6anet rows, in NumPy.

Frozen copies (commit 5f95a86) of the JAX package's read-level
bookkeeping (``f5c_tpu/pipeline/eventalign.py``: ``aligned_segments``,
``ClosestEvent``, ``_ReadState.start_segment``, ``_next_chunk``,
``_commit_chunk``, ``_get_end_pair``, ``_kmers_for_records`` and
``emit_m6anet_tsv``; eventalign.c:928-1521, 2186-2302), driven one read
at a time, each chunk aligned by ``viterbi``: ``hmm.profile_hmm_viterbi``
(hmm.c:313-533) with its MATCH and BAD_EVENT states computed over a row's
blocks at once and the KMER_SKIP chain block by block, in float32 as the
oracle computes it (the tests hold the two equal).
"""

from __future__ import annotations

import numpy as np

from . import hmm
from .meth import disambiguate, reverse_complement

ALIGN_STRIDE = 100    # reference bases aligned a chunk (eventalign.c:1338)
OUTPUT_STRIDE = 50    # event alignments committed a chunk (:1339)
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP = 0, 1, 2, 3, 4, 5
CEQUAL, CDIFF = 7, 8


def aligned_segments(cigar, pos: int):
    """(ref_pos, read_pos) pairs a segment, split on N ops."""
    segs, cur_r, cur_q = [], [], []
    rpos, qpos = pos, 0
    for op, ln in cigar:
        if op in (CMATCH, CEQUAL, CDIFF):
            cur_r.append(np.arange(rpos, rpos + ln))
            cur_q.append(np.arange(qpos, qpos + ln))
            rpos += ln
            qpos += ln
        elif op == CDEL:
            rpos += ln
        elif op == CREF_SKIP:
            if cur_r:
                segs.append(np.stack([np.concatenate(cur_r),
                                      np.concatenate(cur_q)], axis=1))
            cur_r, cur_q = [], []
            rpos += ln
        elif op in (CINS, CSOFT_CLIP):
            qpos += ln
    if cur_r:
        segs.append(np.stack([np.concatenate(cur_r), np.concatenate(cur_q)],
                             axis=1))
    return segs


class ClosestEvent:
    """The first event of the nearest k-mer with one (eventalign.c:971-996
    and its scan bounds)."""

    def __init__(self, b2e_start: np.ndarray):
        b2e = np.asarray(b2e_start, dtype=np.int64)
        n = b2e.shape[0]
        idx = np.arange(n)
        filled = b2e != -1
        back = np.where(filled, idx, -1)
        np.maximum.accumulate(back, out=back)
        fwd = np.where(filled, idx, n + 10)
        fwd = np.minimum.accumulate(fwd[::-1])[::-1]
        self.b2e, self.back, self.fwd, self.n = b2e, back, fwd, n

    def __call__(self, k_idx: int) -> int:
        k = int(k_idx)
        n = self.n
        if k >= 1:
            b = self.back[k]
            if b > max(0, k - 1000):
                v = int(self.b2e[b])
                if v != -1:
                    return v
        stop_after = min(k + 1000, n - 1)
        f = self.fwd[k] if k < n else n + 10
        if f < stop_after:
            return int(self.b2e[f])
        return -1


def _get_end_pair(ref_pos: np.ndarray, ref_pos_max: int,
                  pair_idx: int) -> int:
    j = int(np.searchsorted(ref_pos[pair_idx:], ref_pos_max + 1) + pair_idx)
    if j >= ref_pos.shape[0]:
        return ref_pos.shape[0] - 1
    return j - 1


def viterbi(m_seq, m_rc_seq, event_means, scaling, model, e_start, e_end,
            event_stride, rc, events_per_base):
    """``hmm.profile_hmm_viterbi`` (flags 0) as arrays (event, k-mer,
    state 0 K / 1 B / 2 M) in forward order."""
    k = model.k
    n_kmers = len(m_seq) - k + 1
    n_events = abs(e_end - e_start) + 1
    ranks = hmm.window_kmer_ranks(m_seq, m_rc_seq, rc, model)
    t = hmm.block_transitions(events_per_base)
    pre_flank, _ = hmm.make_flanks(n_events)
    f32 = np.float32
    scale32, shift32 = f32(scaling.scale), f32(scaling.shift)
    var32 = f32(scaling.var)
    gp_mean = scale32 * model.level_mean[ranks] + shift32
    gp_stdv = model.level_stdv[ranks] * var32
    gp_log_stdv = model.level_log_stdv[ranks] + f32(np.log(var32))
    ninf = f32(-np.inf)
    # rows x (blocks 0..n_kmers) of each state; block 0 stays -inf
    M = np.full((n_events + 1, n_kmers + 1), ninf, f32)
    B = np.full_like(M, ninf)
    K = np.full_like(M, ninf)
    bm_m = np.zeros((n_events + 1, n_kmers + 1), np.uint8)
    bm_b = np.zeros_like(bm_m)
    bm_k = np.zeros_like(bm_m)
    lp_kk = f32(t["lp_kk"])
    with np.errstate(invalid="ignore", over="ignore"):
        for row in range(1, n_events + 1):
            event_idx = e_start + (row - 1) * event_stride
            ev = f32(event_means[event_idx])
            a = (ev - gp_mean) / gp_stdv
            lp_em = (hmm.LOG_INV_SQRT_2PI - gp_log_stdv
                     + f32(-0.5) * a * a).astype(f32)
            pm, pb, pk = M[row - 1], B[row - 1], K[row - 1]
            first = np.full(n_kmers, ninf, f32)
            if event_idx == e_start:
                first[0] = f32(pre_flank[row - 1])
            scores = np.stack([
                (t["lp_mm_self"] + pm[1:]).astype(f32),
                (t["lp_mm_next"] + pm[:-1]).astype(f32),
                (t["lp_bm_self"] + pb[1:]).astype(f32),
                (t["lp_bm_next"] + pb[:-1]).astype(f32),
                (t["lp_km"] + pk[:-1]).astype(f32),
                first])
            mx = scores.max(axis=0)
            # the last of equal scores wins
            bm_m[row, 1:] = 5 - np.argmax((scores == mx)[::-1], axis=0)
            M[row, 1:] = mx + lp_em
            s_m = (t["lp_mb"] + pm[1:]).astype(f32)
            s_b = (t["lp_bb"] + pb[1:]).astype(f32)
            take_b = s_b >= s_m
            B[row, 1:] = np.where(take_b, s_b, s_m)
            bm_b[row, 1:] = np.where(take_b, hmm.HMT_FROM_SAME_B,
                                     hmm.HMT_FROM_SAME_M)
            s1 = (t["lp_mk"] + M[row, :-1]).astype(f32)
            s2 = (t["lp_bk"] + B[row, :-1]).astype(f32)
            krow = K[row]
            kb = bm_k[row]
            prev = krow[0]
            for blk in range(1, n_kmers + 1):
                s3 = lp_kk + prev
                a1, a2 = s1[blk - 1], s2[blk - 1]
                m3 = max(a1, a2, s3)
                kb[blk] = (hmm.HMT_FROM_PREV_K if s3 == m3 else
                           hmm.HMT_FROM_PREV_B if a2 == m3 else
                           hmm.HMT_FROM_PREV_M)
                krow[blk] = prev = m3
    bms = (bm_k, bm_b, bm_m)
    out_e, out_k, out_s = [], [], []
    row, blk, ps = n_events, n_kmers, hmm.PSR9_MATCH
    nxt = {hmm.HMT_FROM_SAME_M: hmm.PSR9_MATCH,
           hmm.HMT_FROM_PREV_M: hmm.PSR9_MATCH,
           hmm.HMT_FROM_SAME_B: hmm.PSR9_BAD_EVENT,
           hmm.HMT_FROM_PREV_B: hmm.PSR9_BAD_EVENT,
           hmm.HMT_FROM_PREV_K: hmm.PSR9_KMER_SKIP}
    while row > 0:
        out_e.append(e_start + (row - 1) * event_stride)
        out_k.append(blk - 1)
        out_s.append(ps)
        mv = int(bms[ps][row, blk])
        if mv == hmm.HMT_FROM_SOFT:
            break
        if mv in (hmm.HMT_FROM_PREV_M, hmm.HMT_FROM_PREV_B,
                  hmm.HMT_FROM_PREV_K):
            blk -= 1
        if ps != hmm.PSR9_KMER_SKIP:
            row -= 1
        ps = nxt[mv]
    return (np.array(out_e[::-1], np.int64), np.array(out_k[::-1], np.int64),
            np.array(out_s[::-1], np.uint8))


def realign(read, al: dict, ref_seq: str, model):
    """(ref positions, events, states) of one read (eventalign.c
    realign_read): chunks of ALIGN_STRIDE reference bases along each
    segment, OUTPUT_STRIDE alignments committed a chunk."""
    k = model.k
    dis = disambiguate(ref_seq)
    rc_dis = reverse_complement(dis)
    closest = ClosestEvent(al["b2e_start"])
    sc = al["scaling"]
    means = al["means"]
    epb = al["events_per_base"]
    rl = len(read.seq)
    out_ref, out_ev, out_st = [], [], []
    for pairs in aligned_segments(read.cigar, read.pos):
        hi = pairs.shape[0]
        while hi > 0 and pairs[hi - 1, 1] > rl - k:
            hi -= 1
        pairs = pairs[:hi]
        if pairs.shape[0] == 0:
            break
        ks, ke = int(pairs[0, 1]), int(pairs[-1, 1])
        if read.is_reverse:
            ks, ke = rl - ks - k, rl - ke - k
        cur_ev, last_ev = closest(ks), closest(ke)
        fwd = cur_ev < last_ev
        cur_ref, pair_idx = int(pairs[0, 0]), 0
        ref_pos = pairs[:, 0]
        while (fwd and cur_ev < last_ev) or (not fwd and cur_ev > last_ev):
            end_pair = _get_end_pair(ref_pos, cur_ref + ALIGN_STRIDE,
                                     pair_idx)
            end_ref, end_read = int(pairs[end_pair, 0]), int(pairs[end_pair,
                                                                   1])
            if read.is_reverse:
                end_read = rl - end_read - k
            s = cur_ref - read.pos
            ln = end_ref - cur_ref + 1
            if ln < 2 * k:
                break
            e_stop = closest(end_read)
            if abs(cur_ev - e_stop) < 2:
                break
            stride = 1 if cur_ev < e_stop else -1
            m_seq = dis[s:s + ln]
            m_rc = rc_dis[len(dis) - s - ln:len(dis) - s]
            ev_idx, k_idx, ps = viterbi(m_seq, m_rc, means, sc, model, cur_ev,
                                        e_stop, stride, read.is_reverse, epb)
            last_section = end_pair == pairs.shape[0] - 1
            emit = (ps != 0) & (ev_idx != cur_ev)
            if not last_section:
                emit &= np.cumsum(emit) <= OUTPUT_STRIDE
            idx = np.nonzero(emit)[0]
            if idx.shape[0] == 0:
                break
            refs = cur_ref + k_idx[idx]
            out_ref.append(refs)
            out_ev.append(ev_idx[idx])
            out_st.append(ps[idx])
            cur_ev, cur_ref = int(ev_idx[idx[-1]]), int(refs[-1])
            pair_idx = _get_end_pair(ref_pos, cur_ref, pair_idx)
    if not out_ref:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.uint8),)
    return (np.concatenate(out_ref), np.concatenate(out_ev),
            np.concatenate(out_st))


def m6anet_rows(read, al: dict, ref_seq: str, model, sample_rate: float,
                q=None) -> dict:
    """{ref position: (reference k-mer, mean, stdv, duration, start
    sample, end sample)} of one read, the m6anet rows of
    eventalign.c:2186-2302 with --signal-index, the means scaled
    (``q`` rounds each collapsed value: the control)."""
    k = model.k
    dis = disambiguate(ref_seq)
    rpos, evs, sts = realign(read, al, ref_seq, model)
    rc = read.is_reverse
    means, stdvs = al["means"], al["stdvs"]
    lens, starts = al["lengths"], al["starts"]
    sc = al["scaling"]
    n = rpos.shape[0]
    out = {}
    i = 0
    while i < n:
        pos = int(rpos[i])
        kmer = dis[pos - read.pos:pos - read.pos + k]
        length = mean = stdv = dur = 0.0
        nc = 0
        while i + nc < n and pos == rpos[i + nc]:
            j = i + nc
            model_kmer = ("N" * k if sts[j] == 1 else
                          reverse_complement(kmer) if rc else kmer)
            if kmer == model_kmer:
                e = int(evs[j])
                cur = float(int(lens[e]))
                length += cur
                mean += ((float(means[e]) - sc.shift) / sc.scale) * cur
                stdv += float(stdvs[e]) * cur
                dur += (float(lens[e]) / sample_rate) * cur
            nc += 1
        if length > 0:
            mean, stdv, dur = mean / length, stdv / length, dur / length
        if q is not None:
            mean, stdv, dur = (float(q(np.float32(v)))
                               for v in (mean, stdv, dur))
        e_i = int(evs[i])
        s0 = int(starts[e_i])
        s1 = s0 + int(lens[e_i])
        if nc > 1:
            e_j = int(evs[i + nc - 1])
            s0 = min(s0, int(starts[e_j]))
            s1 = max(s1, int(starts[e_j]) + int(lens[e_j]))
        out[pos] = (kmer, mean, stdv, dur, s0, s1)
        i += nc
    return out
