"""The work of the kernels the window drove, and its roofline bound.

``roofline`` and the constants are frozen copies of ``chip_smoke.py``
(commit 5f95a86: ``roofline``, ``bound_of``, ``HBM_BYTES_PER_S``,
``F32_OPS_PER_S``, ``ABEA_CELL_OPS``, ``HMM_CELL_OPS``), over the published
peaks of one H100 SXM.  ``fill_launch_bound`` counts what
``bound_of("abea_fill", ...)`` counts for one launch, from the reads'
sizes alone: every input read once, the trace (32 B a band) and the
band's k-mer (4 B) written once, and 13 f32 operations a cell at f5c's
band width of 100 cells.  The work is worked out from the reads the
program's batch loop handed on (sizes, and for the HMM the CpG windows
of each read's alignment), as the program groups them into launches:
waves of ``Pipeline.WAVE`` reads, longest first, and the reads routed to
the windowed fill apart.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
ABEA_CELL_OPS = 13   # f32 ops of a band cell: emission 5, scores 6, max 2
HMM_CELL_OPS = 55    # f32 ops (exp/log as one) of an HMM (k-mer, event) cell
BAND_WIDTH = 100     # f5c's band: the kernels pad it to 128 lanes
TRACE_ROW_BYTES = 32
AVG_EVENTS_PER_KMER_MAX = 15.0
HMM_META_BYTES = 16


def roofline(nbytes: float, ops: float, f64_ops: float = 0) -> float:
    """The least seconds of the card for this work: the largest of its
    bytes, f32 and f64 operations over the card's rates."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S,
               f64_ops / F64_OPS_PER_S)


def fill_launch_bound(ev_len, rk_len, n_bases, n_levels: int) -> float:
    """Bound seconds of one unchunked fill launch (K1) over reads of
    ``ev_len`` events, ``rk_len`` k-mers and ``n_bases`` bases."""
    ev_len = np.asarray(ev_len, np.int64)
    rk_len = np.asarray(rk_len, np.int64)
    B = ev_len.shape[0]
    bands = int((ev_len + rk_len + 2).sum())
    packed = max((int(np.sum(n_bases)) + 3) // 4, 1)
    packed += -packed % 4
    inputs = (4 * int(ev_len.sum()) + 8 * B + 4 * B + packed + 8 * B + 4 * B
              + 3 * 4 * n_levels + 4 * 6 * B + 8 * (B + 1))
    outputs = (TRACE_ROW_BYTES + 4) * bands + 4 * B
    return roofline(inputs + outputs, bands * BAND_WIDTH * ABEA_CELL_OPS)


def _reaches_abea(r) -> bool:
    return (r.event_means is not None
            and r.n_events / len(r.seq) < AVG_EVENTS_PER_KMER_MAX)


def waves(batch, wave: int):
    """The batch's reads in the program's waves: longest first, ``wave``
    a wave."""
    order = sorted(batch, key=lambda r: len(r.seq), reverse=True)
    return [order[i:i + wave] for i in range(0, len(order), wave)]


def fill_bound(batches, k: int, n_levels: int, wave: int,
               takes_window) -> float:
    """Bound seconds of every fill of ``batches``: each wave's unchunked
    launch, and the windowed reads' bands once (the windowed fill passes
    over them twice: a bound that leaves the second pass out stays a
    bound)."""
    total = 0.0
    for batch in batches:
        for w in waves(batch, wave):
            todo = [r for r in w if _reaches_abea(r) and not takes_window(r)]
            if todo:
                total += fill_launch_bound(
                    [r.n_events for r in todo],
                    [len(r.seq) - k + 1 for r in todo],
                    [len(r.seq) for r in todo], n_levels)
        for r in batch:
            if _reaches_abea(r) and takes_window(r):
                bands = r.n_events + len(r.seq) - k + 3
                total += roofline(0, bands * BAND_WIDTH * ABEA_CELL_OPS)
    return total


def ref_aligned_events(cigar, pos: int, is_reverse: bool, read_length: int,
                       b2e_start: np.ndarray, k: int) -> np.ndarray:
    """(ref_pos, event) pairs of a read's alignment: the vectorised
    ``event_alignment_record`` of reference/meth.py (meth.c:132-189),
    for counting windows only."""
    ref, qry = [], []
    rpos, qpos = pos, 0
    for op, ln in cigar:
        if op in (0, 7, 8):
            ref.append(np.arange(rpos, rpos + ln))
            qry.append(np.arange(qpos, qpos + ln))
            rpos += ln
            qpos += ln
        elif op in (2, 3):
            rpos += ln
        elif op in (1, 4):
            qpos += ln
    if not ref:
        return np.zeros((0, 2), np.int64)
    ref, qry = np.concatenate(ref), np.concatenate(qry)
    keep = (qry >= k) & (qry + k < read_length)
    ref, qry = ref[keep], qry[keep]
    kpos = read_length - qry - k if is_reverse else qry
    # closest k-mer with an event: the nearest at or before, within 1000,
    # else the nearest after
    n = b2e_start.shape[0]
    has = np.nonzero(b2e_start != -1)[0]
    if has.shape[0] == 0 or kpos.shape[0] == 0:
        return np.zeros((0, 2), np.int64)
    i = np.searchsorted(has, kpos, side="right") - 1
    before = np.where(i >= 0, has[np.clip(i, 0, None)], -1)
    ok_before = (i >= 0) & (before > np.maximum(0, kpos - 1000))
    j = np.clip(i + 1, 0, has.shape[0] - 1)
    after = has[j]
    ok_after = (after >= kpos) & (after < np.minimum(kpos + 1000, n - 1))
    ev = np.where(ok_before, b2e_start[np.clip(before, 0, None)],
                  np.where(ok_after, b2e_start[after], -1))
    pairs = np.stack([ref, ev], axis=1)
    if pairs[0, 1] == pairs[-1, 1]:
        return np.zeros((0, 2), np.int64)
    return pairs


def cpg_windows(ref_seq: str, pos: int, pairs: np.ndarray, k: int,
                min_sep: int = 10, max_span: int = 200):
    """(k-mers, events) of the two HMM windows of each CpG group of a read
    (meth.c:473-567, as reference/meth.py collects them)."""
    s = np.frombuffer(ref_seq.upper().encode(), np.uint8)
    cpg = np.nonzero((s[:-1] == ord("C")) & (s[1:] == ord("G")))[0]
    if cpg.shape[0] == 0 or pairs.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cut = np.nonzero(np.diff(cpg) > min_sep)[0] + 1
    first = cpg[np.concatenate([[0], cut])]
    last = cpg[np.concatenate([cut - 1, [cpg.shape[0] - 1]])]
    sub_start, sub_end = first - min_sep, last + min_sep
    ok = (sub_start > min_sep) & (last - first <= max_span)
    first, last = first[ok], last[ok]
    sub_start, sub_end = sub_start[ok], sub_end[ok]
    refs = pairs[:, 0]
    n = refs.shape[0]
    a = np.searchsorted(refs, sub_start + pos, side="left")
    b = np.searchsorted(refs, sub_end + pos, side="left")
    inside = (a < n) & (b < n)
    a, b = np.minimum(a, n - 1), np.minimum(b, n - 1)
    left = (refs[a] <= sub_start + pos) | ((a > 0) & (refs[np.maximum(
        a - 1, 0)] <= sub_start + pos))
    right = (refs[b] >= sub_end + pos) | ((b + 1 < n) & (refs[np.minimum(
        b + 1, n - 1)] >= sub_start + pos))
    e1, e2 = pairs[a, 1], pairs[b, 1]
    keep = inside & left & right & (np.abs(e2 - e1) > 10)
    n_km = (sub_end - sub_start + 1 - k + 1)[keep]
    n_ev = (np.abs(e2 - e1) + 1)[keep]
    return np.repeat(n_km, 2), np.repeat(n_ev, 2)


def hmm_bound(batches, wave: int, n_levels: int, windows_of) -> float:
    """Bound seconds of the HMM launches of ``batches``: one a wave, over
    the windows of its reads that passed postalign (``windows_of(read)``
    -> (k-mers, events) arrays)."""
    total = 0.0
    for batch in batches:
        for w in waves(batch, wave):
            ok = [r for r in w if not r.status and r.b2e_start is not None]
            if not ok:
                continue
            km, ev = zip(*(windows_of(r) for r in ok))
            km, ev = np.concatenate(km), np.concatenate(ev)
            nbytes = ((HMM_META_BYTES + 4) * km.shape[0]
                      + 4 * sum(r.n_events for r in ok) + 32 * len(ok)
                      + sum(len(r.seq) for r in ok) // 4
                      + 3 * 4 * n_levels)
            total += roofline(nbytes, int((km * ev).sum()) * HMM_CELL_OPS)
    return total
