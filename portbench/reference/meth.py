"""Frozen copy of f5c_tpu/pipeline/methylation.py at commit 5f95a86, part
of the benchmark's plain reference; imports rewritten to stand alone,
and ``call_methylation_for_read`` takes the control's rounding and a
choice of the groups to score.

Per-read CpG methylation calling.

Orchestrates, for one read: scan the reference segment for CpG sites,
batch nearby sites into groups, map each group's reference window to an
event window (via the CIGAR-derived read->ref pairing and the ABEA
base->event map), then score the window with the profile HMM twice —
unmethylated and with every CpG methylated (CG -> MG) — and report the
log-likelihood ratio.

Reference parity: src/meth.c:473-612 plus its helpers.  The HMM windows
this module produces are exactly the batched work items the TPU HMM kernel
consumes; this host orchestration is shared by the NumPy and device paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import METH_MAX_GROUP_SPAN, METH_MIN_SEPARATION
# CIGAR operations (SAM specification)
(CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL,
 CDIFF) = range(9)

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
# IUPAC ambiguity -> first possible symbol (meth.c:225-310 disambiguate)
_DISAMB = {
    "A": "A", "C": "C", "G": "G", "T": "T", "M": "A", "R": "A", "W": "A",
    "S": "C", "Y": "C", "K": "G", "V": "A", "H": "A", "D": "A", "B": "C",
    "N": "A",
}


def disambiguate(seq: str) -> str:
    return "".join(_DISAMB.get(c, "A") for c in seq.upper())


def reverse_complement(seq: str) -> str:
    return "".join(_COMPLEMENT.get(c, "T") for c in reversed(seq))


def methylate(seq: str) -> str:
    """CG -> MG (meth.c:362-385)."""
    return seq.replace("CG", "MG")


def reverse_complement_meth(seq: str) -> str:
    """Meth-aware reverse complement: MG pairs map to MG at the mirrored
    position (meth.c:390-423)."""
    n = len(seq)
    out = ["A"] * n
    i = 0
    j = n - 1
    while i < n:
        if seq[i] == "M" and i + 1 < n and seq[i + 1] == "G":
            out[j] = "G"
            out[j - 1] = "M"
            i += 2
            j -= 2
        else:
            out[j] = _COMPLEMENT.get(seq[i], "T")
            i += 1
            j -= 1
    return "".join(out)


def aligned_ref_read_pairs(cigar, pos: int) -> np.ndarray:
    """(ref_pos, read_pos) for every aligned base (meth.c:23-95
    get_aligned_segments with read_stride=1)."""
    out = []
    read_pos = 0
    ref_pos = pos
    for op, ln in cigar:
        if op in (CMATCH, CEQUAL, CDIFF):
            for _ in range(ln):
                out.append((ref_pos, read_pos))
                read_pos += 1
                ref_pos += 1
        elif op == CDEL:
            ref_pos += ln
        elif op in (CINS, CSOFT_CLIP):
            read_pos += ln
        elif op == CHARD_CLIP:
            pass
        else:
            raise ValueError(f"unhandled CIGAR op {op}")
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def closest_event_to(k_idx: int, b2e_start: np.ndarray) -> int:
    """Nearest kmer (within +-1000) that has an event; its first event
    (meth.c:100-125)."""
    n = b2e_start.shape[0]
    lo = max(0, k_idx - 1000)
    hi = min(k_idx + 1000, n - 1)
    for i in range(k_idx, lo, -1):
        if b2e_start[i] != -1:
            return int(b2e_start[i])
    for i in range(k_idx, hi, 1):
        if b2e_start[i] != -1:
            return int(b2e_start[i])
    return -1


def event_alignment_record(cigar, pos: int, is_reverse: bool,
                           read_length: int, b2e_start: np.ndarray,
                           k: int) -> np.ndarray:
    """(ref_pos, event_idx) pairs over the alignment (meth.c:132-189)."""
    seq_pairs = aligned_ref_read_pairs(cigar, pos)
    out = []
    for ref_pos, read_pos in seq_pairs:
        if read_pos < k or read_pos + k >= read_length:
            continue
        kmer_pos = (read_length - read_pos - k) if is_reverse else read_pos
        ev = closest_event_to(int(kmer_pos), b2e_start)
        out.append((int(ref_pos), ev))
    pairs = np.asarray(out, dtype=np.int64).reshape(-1, 2)
    if pairs.shape[0] and pairs[0, 1] == pairs[-1, 1]:
        return np.zeros((0, 2), dtype=np.int64)  # degenerate
    return pairs


def find_by_ref_bounds(pairs: np.ndarray, ref_start: int, ref_stop: int):
    """Event indices bounding [ref_start, ref_stop] (meth.c:425-470)."""
    n = pairs.shape[0]
    refs = pairs[:, 0]
    start_i = int(np.searchsorted(refs, ref_start, side="left"))
    stop_i = int(np.searchsorted(refs, ref_stop, side="left"))
    if start_i == n or stop_i == n:
        return None
    left_bounded = refs[start_i] <= ref_start or (
        start_i != 0 and refs[start_i - 1] <= ref_start)
    right_bounded = refs[stop_i] >= ref_stop or (
        stop_i != n and stop_i + 1 < n and refs[stop_i + 1] >= ref_start)
    if not (left_bounded and right_bounded):
        return None
    return int(pairs[start_i, 1]), int(pairs[stop_i, 1])


@dataclass
class HmmWorkItem:
    """One HMM scoring task (sequence window x event window)."""

    seq: str
    rc_seq: str
    event_start_idx: int
    event_stop_idx: int
    event_stride: int
    rc: bool


@dataclass
class ScoredSite:
    start_position: int
    end_position: int
    n_cpg: int
    sequence: str
    ll_unmethylated: float = 0.0
    ll_methylated: float = 0.0
    strands_scored: int = 1

    @property
    def llr(self) -> float:
        return self.ll_methylated - self.ll_unmethylated


@dataclass
class MethGroup:
    """A CpG group ready for scoring: two HMM work items + site metadata."""

    unmeth: HmmWorkItem
    meth: HmmWorkItem
    site: ScoredSite


class MethCalls:
    """One read's methylation calls as struct-of-arrays.

    The native pipeline's fast assemble path: ascending-unique start
    positions (native collect_meth_groups scans CpGs left to right)
    with parallel end/n_cpg/score arrays and the read's disambiguated
    reference segment for sequence rendering — no per-site Python
    objects (the 42k-ScoredSite loop used to dominate the hmm stage's
    host time).  ``to_sites()`` expands to the legacy ScoredSite dict
    for consumers that want objects (mesh parity checks, tests).
    """

    __slots__ = ("starts", "ends", "n_cpg", "llu", "llm", "dis",
                 "r_pos", "k")

    def __init__(self, starts, ends, n_cpg, llu, llm, dis: bytes,
                 r_pos: int, k: int):
        self.starts = starts
        self.ends = ends
        self.n_cpg = n_cpg
        self.llu = llu
        self.llm = llm
        self.dis = dis
        self.r_pos = r_pos
        self.k = k

    def __len__(self):
        return len(self.starts)

    def to_sites(self) -> dict:
        k = self.k
        r_pos = self.r_pos
        dis = self.dis
        out = {}
        for j, start in enumerate(self.starts.tolist()):
            end = int(self.ends[j])
            first = start - r_pos
            out[start] = ScoredSite(
                start_position=start, end_position=end,
                n_cpg=int(self.n_cpg[j]),
                sequence=dis[first - k + 1:end - r_pos + k].decode(),
                ll_unmethylated=float(self.llu[j]),
                ll_methylated=float(self.llm[j]))
        return out


def collect_meth_groups(ref_seq: str, ref_start_pos: int, cigar, is_reverse,
                        read_length: int, b2e_start: np.ndarray, k: int,
                        max_event_to_bp_ratio: float = 20.0
                        ) -> list[MethGroup]:
    """All scoreable CpG groups of one read (meth.c:473-567).

    Returns work items; the caller scores them (serially via
    hmm_ref.profile_hmm_score, or batched on device) and aggregates
    per-start-position.
    """
    ref_seq = disambiguate(ref_seq)
    n = len(ref_seq)
    cpg_sites = [i for i in range(n - 1)
                 if ref_seq[i] == "C" and ref_seq[i + 1] == "G"]
    if not cpg_sites:
        return []

    groups = []
    curr = 0
    while curr < len(cpg_sites):
        end = curr + 1
        while end < len(cpg_sites):
            if cpg_sites[end] - cpg_sites[end - 1] > METH_MIN_SEPARATION:
                break
            end += 1
        groups.append((curr, end))
        curr = end

    # the event-alignment record is group-independent; build once
    ev_record = event_alignment_record(cigar, ref_start_pos, is_reverse,
                                       read_length, b2e_start, k)

    out: list[MethGroup] = []
    for start_idx, end_idx in groups:
        first = cpg_sites[start_idx]
        last = cpg_sites[end_idx - 1]
        sub_start = first - METH_MIN_SEPARATION
        sub_end = last + METH_MIN_SEPARATION
        span = last - first
        if sub_start <= METH_MIN_SEPARATION or span > METH_MAX_GROUP_SPAN:
            continue
        subseq = ref_seq[sub_start : sub_end + 1]
        rc_subseq = reverse_complement(subseq)
        calling_start = sub_start + ref_start_pos
        calling_end = sub_end + ref_start_pos

        bounds = find_by_ref_bounds(ev_record, calling_start, calling_end)
        if bounds is None:
            continue
        e1, e2 = bounds
        # NB: the reference computes ratio with a negative denominator
        # (meth.c:551), so the max_event_to_bp_ratio QC never fires there;
        # reproduced faithfully for output parity.
        ratio = abs(float(e2 - e1)) / (calling_start - calling_end)
        if abs(e2 - e1) <= 10 or ratio > max_event_to_bp_ratio:
            continue

        stride = 1 if e1 <= e2 else -1
        mcpg = methylate(subseq)
        rc_mcpg = reverse_complement_meth(mcpg)
        site = ScoredSite(
            start_position=first + ref_start_pos,
            end_position=last + ref_start_pos,
            n_cpg=end_idx - start_idx,
            sequence=ref_seq[first - k + 1 : last + k],
        )
        out.append(MethGroup(
            unmeth=HmmWorkItem(subseq, rc_subseq, e1, e2, stride,
                               bool(is_reverse)),
            meth=HmmWorkItem(mcpg, rc_mcpg, e1, e2, stride,
                             bool(is_reverse)),
            site=site,
        ))
    return out


def call_methylation_for_read(ref_seq: str, ref_start_pos: int, cigar,
                              is_reverse, read_length: int,
                              event_means: np.ndarray,
                              b2e_start: np.ndarray, scaling,
                              model, events_per_base: float, q=None,
                              scored=None) -> dict[int, ScoredSite]:
    """Full single-read methylation calling via the NumPy HMM (host path);
    ``q`` rounds each window's log-likelihood (the control); ``scored``
    (groups -> indices of the groups to score) leaves the others
    unscored, their log-likelihoods None."""
    from .hmm import profile_hmm_score

    site_map: dict[int, ScoredSite] = {}
    groups = collect_meth_groups(ref_seq, ref_start_pos, cigar, is_reverse,
                                 read_length, b2e_start, model.k)
    keep = range(len(groups)) if scored is None else set(scored(groups))
    for i, g in enumerate(groups):
        site = site_map.setdefault(g.site.start_position, g.site)
        if i not in keep:
            site.ll_unmethylated = site.ll_methylated = None
            continue
        u = profile_hmm_score(g.unmeth.seq, g.unmeth.rc_seq, event_means,
                              scaling, model, g.unmeth.event_start_idx,
                              g.unmeth.event_stop_idx, g.unmeth.event_stride,
                              g.unmeth.rc, events_per_base)
        m = profile_hmm_score(g.meth.seq, g.meth.rc_seq, event_means,
                              scaling, model, g.meth.event_start_idx,
                              g.meth.event_stop_idx, g.meth.event_stride,
                              g.meth.rc, events_per_base)
        if q is not None:
            u, m = float(q(np.float32(u))), float(q(np.float32(m)))
        site.ll_unmethylated = u
        site.ll_methylated = m
    return site_map
