"""eventalign on PyTorch: events re-aligned to the reference, segment by
segment, after the port's ABEA.

Counterpart of ``f5c_tpu/pipeline/eventalign.py``.  The record type, the
row emitters (TSV, SAM, PAF, m6anet, summary; eventalign.c:1574-2349
column for column) and the lockstep bookkeeping (``_ReadState``,
``ClosestEvent``, ``_get_end_pair``, the chunk cursor and commit) are that
module's, copied.  What reached JAX is re-implemented here:

- ``EventalignEngine`` re-aligns a batch with one of three engines: the
  whole-read C++ loop ``native.realign_read`` (eventalign.c realign_read)
  read by read over the host pool, or lockstep rounds -- every active read
  contributes its next ~100-base chunk and a round's chunks go to the
  Viterbi kernel (K8, ``ops/viterbi_cuda.py``, csrc/viterbi.cu) in one
  launch, against rank and event pools uploaded once a batch -- with or
  without small rounds on the host.  ``auto`` is the native engine, as
  measured on the card (``EventalignEngine``).  Under a mesh
  (``parallel/mesh.py``) a round of at least two chunks a device deals its
  chunks over the devices (``mesh.shard_viterbi_rounds``), against pools
  uploaded once a batch to every device.
- ``run_eventalign`` is the batch loop and emission of the JAX module's
  ``run_eventalign`` (eventalign.py:1012-1128) with this engine.  The
  re-alignment of a wave runs while the card fills the next wave; reads
  aligned by windows (ultra-long) finish after the waves.  Under
  ``--dist`` every read's rows, in the output and in ``--summary``,
  follow a ``#f5c-dist`` marker line (``parallel/distributed.py``); a SAM
  run's header comes from part 0 in the merge.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..backend import canonical_device, h2d
from ..io.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH,
                      CREF_SKIP, CSOFT_CLIP)
from ..ops.hmm import (decode_viterbi_movements, unpack_movements,
                       viterbi_consts, viterbi_max_path, viterbi_read_params)
from ..parallel import mesh
from ..parallel.distributed import MARKER
from .writer import AsyncWriter

_COMP = np.zeros(256, dtype=np.uint8)
for a, b in zip(b"ACGT", b"TGCA"):
    _COMP[a] = b
_COMP[_COMP == 0] = ord("A")  # disambiguated input is pure ACGT


def revcomp_bytes(seq: bytes) -> bytes:
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMP[arr[::-1]].tobytes()


def aligned_segments(cigar, pos: int):
    """(ref_pos, read_pos) pairs per segment, split on N ops
    (eventalign.c:1121-1188, read_stride=1). Vectorised."""
    segs = []
    ref_starts, read_starts, lens = [], [], []
    read_pos, ref_pos = 0, pos

    def flush():
        if not lens:
            return
        total = int(np.sum(lens))
        rp = np.empty(total, dtype=np.int64)
        qp = np.empty(total, dtype=np.int64)
        o = 0
        for rs, qs, ln in zip(ref_starts, read_starts, lens):
            rp[o:o + ln] = np.arange(rs, rs + ln)
            qp[o:o + ln] = np.arange(qs, qs + ln)
            o += ln
        segs.append(np.stack([rp, qp], axis=1))
        ref_starts.clear()
        read_starts.clear()
        lens.clear()

    for op, ln in cigar:
        if op in (CMATCH, CEQUAL, CDIFF):
            ref_starts.append(ref_pos)
            read_starts.append(read_pos)
            lens.append(ln)
            read_pos += ln
            ref_pos += ln
        elif op == CDEL:
            ref_pos += ln
        elif op == CREF_SKIP:
            flush()
            segs.append(None)  # segment boundary marker
            ref_pos += ln
        elif op in (CINS, CSOFT_CLIP):
            read_pos += ln
        elif op == CHARD_CLIP:
            pass
    flush()
    # merge: the reference starts a NEW segment at each N; empty segments
    # between consecutive Ns collapse away
    out = []
    for s in segs:
        if s is not None:
            out.append(s)
    return out if out else []


@dataclass
class EventAlignmentRecords:
    """Per-read alignment output: parallel arrays (forward order)."""

    ref_position: np.ndarray   # i64
    event_idx: np.ndarray      # i64
    state: np.ndarray          # u8: 0=K (never stored), 1=B, 2=M
    rc: bool = False
    ref_disamb: bytes = b""    # disambiguated reference segment
    ref_offset: int = 0


def tsv_header(print_read_names=False, write_samples=False,
               write_signal_index=False) -> str:
    cols = ["contig", "position", "reference_kmer",
            "read_name" if print_read_names else "read_index", "strand",
            "event_index", "event_level_mean", "event_stdv", "event_length",
            "model_kmer", "model_mean", "model_stdv", "standardized_level"]
    if write_signal_index:
        cols += ["start_idx", "end_idx"]
    if write_samples:
        cols += ["samples"]
    return "\t".join(cols) + "\n"


def m6anet_header(print_read_names=False, write_signal_index=False) -> str:
    cols = ["contig", "position", "reference_kmer",
            "read_name" if print_read_names else "read_index",
            "event_level_mean", "event_stdv", "event_length"]
    out = "\t".join(cols) + "\t"
    if write_signal_index:
        out += "\tstart_idx\tend_idx"
    return out + "\n"


def summary_header() -> str:
    return ("read_index\tread_name\tfast5_path\tmodel_name\tstrand\t"
            "num_events\tnum_steps\tnum_skips\tnum_stays\ttotal_duration\t"
            "shift\tscale\tdrift\tvar\n")


def _kmers_for_records(recs: EventAlignmentRecords, ref_disamb: bytes,
                       ref_offset: int, k: int):
    """(ref_kmer, model_kmer) strings per record."""
    ref_kmers = []
    model_kmers = []
    n_kmer = "N" * k
    for i in range(recs.ref_position.shape[0]):
        p = int(recs.ref_position[i]) - ref_offset
        rk = ref_disamb[p : p + k].decode()
        ref_kmers.append(rk)
        if recs.state[i] == 1:   # 'B'
            model_kmers.append(n_kmer)
        elif recs.rc:
            model_kmers.append(revcomp_bytes(rk.encode()).decode())
        else:
            model_kmers.append(rk)
    return ref_kmers, model_kmers


def summarize_alignment(recs: EventAlignmentRecords, read, nm: int) -> dict:
    """EventalignSummary (eventalign.c:1574-1636)."""
    n = recs.ref_position.shape[0]
    s = dict(num_events=int(n), num_steps=0, num_skips=0, num_stays=0,
             sum_duration=0.0, alignment_edit_distance=int(nm),
             reference_span=0)
    if n == 0:
        return s
    moves = np.diff(recs.ref_position)
    s["num_stays"] = int(np.sum(moves == 0))
    s["num_steps"] = int(np.sum(moves == 1))
    s["num_skips"] = int(np.sum(moves > 1))
    s["sum_duration"] = float(
        np.sum(read.event_lengths[recs.event_idx]))
    s["reference_span"] = int(recs.ref_position[-1]
                              - recs.ref_position[0] + 1)
    return s


def summary_line(read_idx, qname, signal_path, rna, summary, sample_rate,
                 scalings) -> str:
    return (f"{read_idx}\t{qname}\t{signal_path}\t"
            f"{'rna' if rna else 'dna'}\ttemplate\t"
            f"{summary['num_events']}\t{summary['num_steps']}\t"
            f"{summary['num_skips']}\t{summary['num_stays']}\t"
            f"{summary['sum_duration']/sample_rate:.2f}\t"
            f"{scalings.shift:.3f}\t{scalings.scale:.3f}\t0.000\t"
            f"{scalings.var:.3f}\n")


def emit_tsv(recs: EventAlignmentRecords, read, model, contig: str,
             ref_disamb: bytes, ref_offset: int, read_idx: int,
             print_read_names=False, scale_events=False,
             write_samples=False, write_signal_index=False,
             collapse=False, as_bytes=False):
    """eventalign.c:2038-2176."""
    raw = None
    if (collapse or write_samples) and read.raw_pa is not None:
        raw = np.ascontiguousarray(read.raw_pa, dtype=np.float32)
    sc = read.scaling
    return native.emit_eventalign_tsv(
        recs.ref_position, recs.event_idx, recs.state, recs.rc,
        read.event_starts, read.event_lengths, read.event_means,
        read.event_stdvs, raw, ref_disamb, ref_offset, contig,
        read.qname if print_read_names else str(read_idx), model.k,
        model.level_mean, model.level_stdv, sc.scale, sc.shift,
        sc.var, read.sample_rate, scale_events, write_signal_index,
        collapse, write_samples, as_bytes=as_bytes)


def emit_m6anet_tsv(recs: EventAlignmentRecords, read, model, contig: str,
                    ref_disamb: bytes, ref_offset: int, read_idx: int,
                    print_read_names=False, write_signal_index=False) -> str:
    """eventalign.c:2186-2302 (collapse per ref position, scaled means)."""
    k = model.k
    sample_rate = read.sample_rate
    ref_kmers, model_kmers = _kmers_for_records(recs, ref_disamb,
                                                ref_offset, k)
    ev_means = read.event_means
    ev_stdvs = read.event_stdvs
    ev_lens = read.event_lengths
    ev_starts = read.event_starts
    sc = read.scaling
    out = []
    n = recs.ref_position.shape[0]
    name_field = read.qname if print_read_names else str(read_idx)
    i = 0
    while i < n:
        ref_pos = int(recs.ref_position[i])
        length = 0.0
        event_mean = 0.0
        event_stdv = 0.0
        event_duration = 0.0
        n_collapse = 0
        while (i + n_collapse < n
               and ref_pos == recs.ref_position[i + n_collapse]):
            j = i + n_collapse
            if ref_kmers[j] == model_kmers[j]:
                e_j = int(recs.event_idx[j])
                len_curr = float(int(ev_lens[e_j]))
                length += len_curr
                event_mean += ((float(ev_means[e_j]) - sc.shift)
                               / sc.scale) * len_curr
                event_stdv += float(ev_stdvs[e_j]) * len_curr
                event_duration += (float(ev_lens[e_j]) / sample_rate
                                   ) * len_curr
            n_collapse += 1
        if length > 0:
            event_mean /= length
            event_stdv /= length
            event_duration /= length
        row = (f"{contig}\t{ref_pos}\t{ref_kmers[i]}\t{name_field}\t"
               f"{event_mean:.2f}\t{event_stdv:.3f}\t{event_duration:.5f}\t")
        if write_signal_index:
            e_i = int(recs.event_idx[i])
            start_idx = int(ev_starts[e_i])
            end_idx = start_idx + int(ev_lens[e_i])
            if n_collapse > 1:
                e_j = int(recs.event_idx[i + n_collapse - 1])
                s2 = int(ev_starts[e_j])
                e2 = s2 + int(ev_lens[e_j])
                start_idx = min(start_idx, s2)
                end_idx = max(end_idx, e2)
            row += f"\t{start_idx}\t{end_idx}"
        out.append(row + "\n")
        i += n_collapse
    return "".join(out)


def get_f5c_ss(recs: EventAlignmentRecords, read, rna: bool):
    """Run-length signal alignment string + block coords
    (eventalign.c:1677-1823).  Returns dict or None when empty."""
    n = recs.ref_position.shape[0]
    if n == 0:
        return None
    strand = "-" if recs.rc else "+"
    if (not rna and strand == "-") or (rna and strand == "+"):
        order = np.arange(n - 1, -1, -1)
    else:
        order = np.arange(n)
    ref_pos = recs.ref_position[order]
    ev_idx = recs.event_idx[order]
    ev_starts = read.event_starts
    ev_lens = read.event_lengths

    start_idx_sig = int(ev_starts[ev_idx[0]])
    end_idx_sig = int(ev_starts[ev_idx[-1]]) + int(ev_lens[ev_idx[-1]])
    dir_swap = 1 if ((not rna and strand == "+")
                     or (rna and strand == "-")) else 0
    start_idx_kmer = int(ref_pos[0] if dir_swap else ref_pos[-1])
    end_idx_kmer = int(ref_pos[-1] if dir_swap else ref_pos[0]) + 1
    n_kmer = end_idx_kmer - start_idx_kmer

    parts = []
    c_ref_pos = int(ref_pos[0])
    ci = start_idx_sig
    matches = 0
    i = 0
    while i < n:
        rp = int(ref_pos[i])
        start_idx = int(ev_starts[ev_idx[i]])
        end_idx = start_idx + int(ev_lens[ev_idx[i]])
        n_collapse = 1
        while i + n_collapse < n and rp == ref_pos[i + n_collapse]:
            n_collapse += 1
        if n_collapse > 1:
            j = i + n_collapse - 1
            s2 = int(ev_starts[ev_idx[j]])
            e2 = s2 + int(ev_lens[ev_idx[j]])
            start_idx = min(start_idx, s2)
            end_idx = max(end_idx, e2)
        d = abs(rp - c_ref_pos)
        if d > 0:
            parts.append(f"{d}D")
        mi = start_idx - ci
        ci += mi
        if mi:
            parts.append(f"{mi}I")
        mi = end_idx - start_idx
        ci += mi
        c_ref_pos = rp + 1 if dir_swap else rp - 1
        if mi:
            matches += 1
            parts.append(f"{mi},")
        i += n_collapse
    return dict(start_raw=start_idx_sig, end_raw=end_idx_sig,
                start_kmer=end_idx_kmer if rna else start_idx_kmer,
                end_kmer=start_idx_kmer if rna else end_idx_kmer,
                matches=matches, n_kmer=n_kmer, ss="".join(parts))


def emit_paf(recs: EventAlignmentRecords, read, contig: str, ref_len: int,
             k: int, rna: bool) -> str:
    """eventalign.c:2305-2349."""
    ss = get_f5c_ss(recs, read, rna)
    if ss is None:
        return ""
    strand = "-" if recs.rc else "+"
    len_raw_signal = int(read.nsample)
    n_kmer_total = ref_len - k + 1
    len_block = abs(ss["end_kmer"] - ss["start_kmer"])
    sc = read.scaling
    return (f"{read.qname}\t{len_raw_signal}\t{ss['start_raw']}\t"
            f"{ss['end_raw']}\t{strand}\t{contig}\t{n_kmer_total}\t"
            f"{ss['start_kmer']}\t{ss['end_kmer']}\t{ss['matches']}\t"
            f"{len_block}\t255\t"
            f"sc:f:{sc.scale:.2f}\tsh:f:{sc.shift:.2f}\tss:Z:{ss['ss']}\n")


def event_alignment_to_cigar(recs: EventAlignmentRecords):
    """eventalign.c:1825-1886: events-as-query CIGAR for SAM v1."""
    out = []
    if recs.event_idx[0] > 0:
        out.append((int(recs.event_idx[0]), "S"))
    out.append((1, "M"))
    prev_r = int(recs.ref_position[0])
    for i in range(1, recs.ref_position.shape[0]):
        r_idx = int(recs.ref_position[i])
        r_step = abs(r_idx - prev_r)
        if r_step == 1:
            op = (1, "M")
        elif r_step > 1:
            out.append((r_step - 1, "D"))
            op = (1, "M")
        else:
            op = (1, "I")
        if out[-1][1] == op[1]:
            out[-1] = (out[-1][0] + op[0], op[1])
        else:
            out.append(op)
        prev_r = r_idx
    return "".join(f"{ln}{op}" for ln, op in out)


def emit_sam(recs: EventAlignmentRecords, read, contig: str, ref_len: int,
             sam_out_version: int, rna: bool) -> str:
    """eventalign.c:1891-1994.  v1: events-as-CIGAR record + ES tag;
    v2: the base alignment + si/ss/sc/sh tags."""
    if recs.ref_position.shape[0] == 0:
        return ""
    sc = read.scaling
    if sam_out_version == 1:
        qname = read.qname + ".template"
        flag = 16 if recs.rc else 0
        pos = int(recs.ref_position[0]) + 1
        cigar = event_alignment_to_cigar(recs)
        stride = 1 if recs.event_idx[0] < recs.event_idx[-1] else -1
        return (f"{qname}\t{flag}\t{contig}\t{pos}\t{read.mapq}\t{cigar}\t"
                f"*\t0\t0\t*\t*\tES:i:{stride}\n")
    ss = get_f5c_ss(recs, read, rna)
    if ss is None:
        return ""
    cigar = "".join(f"{ln}{'MIDNSHP=X'[op]}" for op, ln in read.cigar)
    si = (f"{ss['start_raw']},{ss['end_raw']},"
          f"{ss['start_kmer']},{ss['end_kmer']}")
    # v2 re-emits the ORIGINAL record (qualities + aux tags) and appends
    # the signal tags, like the reference's sam_format1 + bam_aux append
    # (eventalign.c:1891-1994)
    qual = getattr(read, "qual", "*") or "*"
    aux = "".join(f"\t{t}" for t in getattr(read, "sam_aux", ()))
    return (f"{read.qname}\t{read.flag}\t{contig}\t{read.pos + 1}\t"
            f"{read.mapq}\t{cigar}\t*\t0\t0\t{read.seq}\t{qual}"
            f"{aux}\t"
            f"si:Z:{si}\tss:Z:{ss['ss']}\tsc:f:{sc.scale:.2f}\t"
            f"sh:f:{sc.shift:.2f}\n")


ALIGN_STRIDE = 100   # reference bases aligned per chunk (eventalign.c:1338)
OUTPUT_STRIDE = 50   # event alignments committed per chunk (:1339)
ENGINES = ("auto", "native", "python", "device")


class ClosestEvent:
    """O(1) closest-event lookup with the reference's quirky scan bounds
    (eventalign.c:971-996 / meth.c:100-125)."""

    def __init__(self, b2e_start: np.ndarray):
        b2e = np.asarray(b2e_start, dtype=np.int64)
        n = b2e.shape[0]
        idx = np.arange(n)
        filled = b2e != -1
        back = np.where(filled, idx, -1)
        np.maximum.accumulate(back, out=back)
        fwd = np.where(filled, idx, n + 10)
        fwd = np.minimum.accumulate(fwd[::-1])[::-1]
        self.b2e = b2e
        self.back = back
        self.fwd = fwd
        self.n = n

    def __call__(self, k_idx: int) -> int:
        k = int(k_idx)
        n = self.n
        # down-scan checks j in [max(0, k-1000)+?..k]; index stop is
        # exclusive, so j == stop is never checked
        before = -1
        if k >= 1:
            b = self.back[k]
            stop = max(0, k - 1000)
            if b > stop:
                before = int(self.b2e[b])
        if before != -1:
            return before
        stop_after = min(k + 1000, n - 1)
        f = self.fwd[k] if k < n else n + 10
        if f < stop_after:
            return int(self.b2e[f])
        return -1


@dataclass
class _ReadState:
    read: object                # ReadRecord
    ref_disamb: bytes = b""
    ref_offset: int = 0
    fwd_ranks: np.ndarray = None
    rc_ranks: np.ndarray = None
    ev_off: int = 0             # offsets into the device-resident pools
    fwd_off: int = 0
    rc_off: int = 0
    params: tuple = ()          # f32 (log_var, lp_stay, lp_step)
    segments: list = field(default_factory=list)
    seg_idx: int = 0
    pairs: np.ndarray = None    # current segment pairs
    closest: ClosestEvent = None
    # cursor within the current segment
    curr_start_event: int = 0
    curr_start_ref: int = 0
    curr_pair_idx: int = 0
    last_event: int = 0
    forward: bool = True
    done: bool = False
    out_ref: list = field(default_factory=list)
    out_ev: list = field(default_factory=list)
    out_st: list = field(default_factory=list)

    def start_segment(self, k: int) -> bool:
        """Initialise the cursor for the next segment; False if none left
        or the segment is unusable (reference returns early)."""
        while self.seg_idx < len(self.segments):
            pairs = self.segments[self.seg_idx]
            self.seg_idx += 1
            r = self.read
            # trim to max kmer index (eventalign.c:956-966)
            max_kmer_idx = len(r.seq) - k
            hi = pairs.shape[0]
            while hi > 0 and pairs[hi - 1, 1] > max_kmer_idx:
                hi -= 1
            pairs = pairs[:hi]
            if pairs.shape[0] == 0:
                self.done = True     # reference returns alignment_output
                return False
            rl = len(r.seq)
            ks = int(pairs[0, 1])
            ke = int(pairs[-1, 1])
            if r.is_reverse:
                ks = rl - ks - k
                ke = rl - ke - k
            first_event = self.closest(ks)
            last_event = self.closest(ke)
            self.pairs = pairs
            self.forward = first_event < last_event
            self.curr_start_event = first_event
            self.curr_start_ref = int(pairs[0, 0])
            self.curr_pair_idx = 0
            self.last_event = last_event
            return True
        self.done = True
        return False


def _get_end_pair(ref_pos: np.ndarray, ref_pos_max: int,
                  pair_idx: int) -> int:
    """First index after pair_idx whose ref exceeds max, minus one
    (eventalign.c:928-938)."""
    j = int(np.searchsorted(ref_pos[pair_idx:], ref_pos_max + 1) + pair_idx)
    if j >= ref_pos.shape[0]:
        return ref_pos.shape[0] - 1
    return j - 1


_PROBE = {}


def measured_dispatch_overhead(device: torch.device) -> float:
    """Seconds for one tiny op on ``device`` and the copy of its result to
    the host, measured once per process and device (median of 3 warm
    calls): what a lockstep round pays twice beyond its compute (the
    specs up, the movements down)."""
    key = ("dispatch", str(device))
    if key not in _PROBE:
        x = torch.zeros(8, dtype=torch.float32, device=device)
        (x + 1.0).cpu()                      # first-use costs
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            (x + 1.0).cpu()
            ts.append(time.perf_counter() - t0)
        _PROBE[key] = sorted(ts)[1]
    return _PROBE[key]


def measured_host_chunk_secs(model) -> float:
    """Seconds for one typical eventalign chunk DP on the host
    (native.viterbi_chunk on a synthetic ~ALIGN_STRIDE-base window),
    measured once per process."""
    if "host_chunk" not in _PROBE:
        nk = ALIGN_STRIDE - model.k + 1
        ne = int(nk * 1.8)
        rng = np.random.default_rng(0)
        rk = rng.integers(0, model.level_mean.shape[0], nk
                          ).astype(np.int32)
        ev = (model.level_mean[rk[np.clip(
            np.linspace(0, nk, ne, endpoint=False).astype(int),
            0, nk - 1)]] + rng.normal(0, 2, ne)).astype(np.float32)
        args = (rk, 0, 1, nk, ev, 0, 1, ne, 1.0, 0.0, 1.0, ne / nk,
                model.level_mean, model.level_stdv, model.level_log_stdv)
        native.viterbi_chunk(*args)          # warm (page-in, caches)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            native.viterbi_chunk(*args)
            ts.append(time.perf_counter() - t0)
        _PROBE["host_chunk"] = sorted(ts)[1]
    return _PROBE["host_chunk"]


def engine_name(device: torch.device = torch.device("cpu")) -> str:
    """The re-alignment engine that ``F5C_TPU_EA_ENGINE`` selects for a
    run on ``device``.  ``python`` runs chunk DPs on the host, so it is
    refused on a CUDA device, where every round goes to the kernel."""
    name = os.environ.get("F5C_TPU_EA_ENGINE", "auto")
    if name not in ENGINES:
        raise ValueError(f"F5C_TPU_EA_ENGINE={name!r}: expected auto, "
                         "native, python or device")
    if name == "python" and device.type == "cuda":
        raise ValueError("F5C_TPU_EA_ENGINE=python runs on the cpu only; "
                         "on a card use native or device")
    return name


class EventalignEngine:
    """Batched re-alignment of reads that passed ABEA + QC.

    ``F5C_TPU_EA_ENGINE`` = ``native`` (the whole-read C++ loop
    ``native.realign_read``, read by read over the host pool), ``device``
    (lockstep rounds: every active read contributes its next chunk, and a
    round's chunks go to the Viterbi kernel, csrc/viterbi.cu, in one
    launch; on the CPU its plain version), ``python`` (CPU runs only:
    lockstep rounds whose small rounds run ``native.viterbi_chunk`` per
    chunk and the others the plain version), or ``auto`` (default), which
    is ``native``.  The JAX engine resolves ``auto`` to ``device`` when a
    round of the batch's host DPs outlasts two dispatches; on an H100
    that rule picks ``device`` for 6 and for 510 reads, and the device
    engine then loses end to end on 510 reads (PERF.md): each chunk's
    host bookkeeping in the lockstep loop costs more than the DP it
    moves to the card.
    ``F5C_TPU_VIT_HOST_MAX`` sets the round size at or below which
    ``python`` runs a round on the host (the probed crossover of the
    probes below when unset); ``device`` runs every round through the
    kernel's wrapper.  The records are the same bytes whichever engine
    runs.  ``devices`` (``parallel/mesh.py:data_devices``, ``device``
    first) deals the device engine's rounds over several devices."""

    def __init__(self, model, region_start: int = -1, region_end: int = -1,
                 device: torch.device = torch.device("cpu"), devices=None):
        self.engine = engine_name(device)
        native.get_lib()     # raises when the host library cannot load
        self.model = model
        self.k = model.k
        self.region_start = region_start
        self.region_end = region_end
        self.device = canonical_device(device)
        self.devices = mesh.data_devices(self.device, devices)
        env_max = os.environ.get("F5C_TPU_VIT_HOST_MAX")
        self.host_round_max = int(env_max) if env_max is not None else None
        self._tables: dict = {}     # device -> the model's tables there
        self._pools: dict = {}      # device -> (rank pool, event pool, tables)
        self._consts = viterbi_consts()     # host constants
        self.stats = {"rounds_device": 0, "rounds_host": 0, "chunks": 0}

    def _probed_round_max(self) -> int:
        """Crossover round size: a device round pays ~2 synchronous
        trips (spec upload + movement download); below
        overhead/host_chunk items the host finishes first."""
        overhead = 2.0 * measured_dispatch_overhead(self.device)
        per_chunk = measured_host_chunk_secs(self.model)
        return max(16, min(100_000, int(overhead / max(per_chunk, 1e-7))))

    def resolve(self) -> str:
        """The engine a batch runs on (``auto`` is ``native``), probing
        the host/device crossover where the engine needs it."""
        engine = self.engine
        if engine in ("auto", "native"):
            return "native"
        if self.host_round_max is None:
            # only python consults the crossover; device runs every round
            # on the device
            self.host_round_max = (self._probed_round_max()
                                   if engine == "python" else 0)
        return engine

    def _realign_one(self, r, ref_seq: str):
        m, k = self.model, self.k
        dis = native.disambiguate(ref_seq.upper().encode())
        segs = self._segments(r)
        sc = r.scaling
        rr, ev, ps = native.realign_read(
            native.kmer_ranks(dis, k),
            native.kmer_ranks(revcomp_bytes(dis), k),
            len(dis), r.pos, k, len(r.seq), r.is_reverse, r.event_means,
            r.b2e_start, segs, sc.scale, sc.shift, sc.var,
            r.events_per_base, m.level_mean, m.level_stdv, m.level_log_stdv)
        return id(r), EventAlignmentRecords(
            ref_position=rr, event_idx=ev, state=ps, rc=bool(r.is_reverse),
            ref_disamb=dis, ref_offset=r.pos)

    def _segments(self, r):
        segs = aligned_segments(r.cigar, r.pos)
        if self.region_start != -1 and self.region_end != -1:
            segs = [s[(s[:, 0] >= self.region_start)
                      & (s[:, 0] <= self.region_end)] for s in segs]
        return segs

    def realign_batch(self, reads, ref_segments, pool=None) -> dict:
        """{id(read): EventAlignmentRecords}; ``ref_segments[i]`` is read
        i's reference from its mapping position to its end.  The native
        engine runs reads side by side on ``pool`` (a thread pool, or
        None; the C++ loop releases the GIL); the lockstep engines run
        rounds over the whole batch."""
        engine = self.resolve()
        if engine == "native":
            if pool is not None:
                return dict(pool.map(self._realign_one, reads, ref_segments))
            return dict(self._realign_one(r, s)
                        for r, s in zip(reads, ref_segments))
        return self._realign_lockstep(reads, ref_segments, engine)

    def _realign_lockstep(self, reads, ref_segments, engine: str) -> dict:
        k = self.k
        states = []
        rank_parts = []
        ev_parts = []
        rank_off = 0
        ev_off = 0
        for r, ref_seq in zip(reads, ref_segments):
            st = _ReadState(read=r)
            dis = native.disambiguate(ref_seq.upper().encode())
            st.ref_disamb = dis
            st.ref_offset = r.pos
            st.fwd_ranks = native.kmer_ranks(dis, k)
            st.rc_ranks = native.kmer_ranks(revcomp_bytes(dis), k)
            st.fwd_off = rank_off
            rank_parts.append(st.fwd_ranks)
            rank_off += st.fwd_ranks.shape[0]
            st.rc_off = rank_off
            rank_parts.append(st.rc_ranks)
            rank_off += st.rc_ranks.shape[0]
            st.ev_off = ev_off
            ev_parts.append(r.event_means)
            ev_off += r.event_means.shape[0]
            st.params = viterbi_read_params(r.events_per_base,
                                            r.scaling.var)
            st.segments = self._segments(r)
            st.closest = ClosestEvent(r.b2e_start)
            st.start_segment(k)     # sets done when there is none
            states.append(st)
        host_max = self.host_round_max if engine == "python" else 0
        if rank_parts:
            # the pools go up once a batch, to every device; a round ships
            # only its specs
            rank_pool = np.concatenate(rank_parts).astype(np.int32,
                                                          copy=False)
            ev_pool = np.concatenate(ev_parts).astype(np.float32, copy=False)
            m = self.model
            self._pools = {}
            for dev in dict.fromkeys(self.devices or [self.device]):
                if dev not in self._tables:
                    self._tables[dev] = tuple(
                        h2d(np.asarray(t, np.float32), dev)
                        for t in (m.level_mean, m.level_stdv,
                                  m.level_log_stdv))
                self._pools[dev] = (h2d(rank_pool, dev), h2d(ev_pool, dev),
                                    self._tables[dev])
            if self.devices:
                mesh.record_dispatch(
                    "viterbi_pools", 0, rank_pool.nbytes + ev_pool.nbytes
                    + mesh.table_bytes(m), len(self.devices))

        active = [st for st in states if not st.done]
        while active:
            self._run_round(active, host_max)
            next_active = []
            for st in active:
                if st.done and st.seg_idx < len(st.segments):
                    st.done = False
                    if st.start_segment(self.k):
                        next_active.append(st)
                elif not st.done:
                    next_active.append(st)
            active = next_active

        out = {}
        for st in states:
            r = st.read
            if st.out_ref:
                out[id(r)] = EventAlignmentRecords(
                    ref_position=np.concatenate(st.out_ref),
                    event_idx=np.concatenate(st.out_ev),
                    state=np.concatenate(st.out_st),
                    rc=bool(r.is_reverse), ref_disamb=st.ref_disamb,
                    ref_offset=st.ref_offset)
            else:
                out[id(r)] = EventAlignmentRecords(
                    ref_position=np.zeros(0, np.int64),
                    event_idx=np.zeros(0, np.int64),
                    state=np.zeros(0, np.uint8), rc=bool(r.is_reverse),
                    ref_disamb=st.ref_disamb, ref_offset=st.ref_offset)
        return out

    def _run_round_host(self, items):
        m = self.model
        for st, spec in items:
            r = st.read
            sc = r.scaling
            if spec["rank_stride"] == 1:
                rk = st.fwd_ranks
                local_start = spec["rank_start"] - st.fwd_off
            else:
                rk = st.rc_ranks
                local_start = spec["rank_start"] - st.rc_off
            mv = native.viterbi_chunk(
                rk, local_start, spec["rank_stride"], spec["n_kmers"],
                r.event_means, spec["e_start"], spec["stride"],
                spec["n_events"], sc.scale, sc.shift, sc.var,
                r.events_per_base, m.level_mean, m.level_stdv,
                m.level_log_stdv)
            ev_idx, k_idx, ps = decode_viterbi_movements(
                mv, mv.shape[0], spec["e_start"], spec["stride"],
                spec["n_events"], spec["n_kmers"])
            self._commit_chunk(st, spec, ev_idx, k_idx, ps)

    # -- one lockstep round: one chunk per active read --------------------
    def _run_round(self, active, host_max: int):
        items = []          # (state, spec) per chunk
        for st in active:
            spec = self._next_chunk(st)
            if spec is None:
                st.done = True
                continue
            items.append((st, spec))
        if not items:
            return
        self.stats["chunks"] += len(items)
        if len(items) <= host_max:
            # a round this small costs the host less than the device's
            # two trips: the chunk DPs run on the host
            self.stats["rounds_host"] += 1
            self._run_round_host(items)
            return
        self.stats["rounds_device"] += 1
        n = len(items)
        spec_i32 = np.empty((n, 6), np.int32)
        spec_f32 = np.empty((n, 6), np.float32)
        for i, (st, spec) in enumerate(items):
            sc = st.read.scaling
            spec_i32[i] = (spec["rank_start"], spec["rank_stride"],
                           spec["n_kmers"], st.ev_off + spec["e_start"],
                           spec["stride"], spec["n_events"])
            spec_f32[i] = (sc.scale, sc.shift, sc.var, *st.params)
        max_path = viterbi_max_path(spec_i32[:, 2], spec_i32[:, 5])
        movs, n_steps = mesh.shard_viterbi_rounds(
            mesh.slot_devices(self.devices, self.device, n), spec_i32,
            spec_f32, self._consts, self._pools, max_path)
        for i, (st, spec) in enumerate(items):
            mv = unpack_movements(movs[i], int(n_steps[i]))
            ev_idx, k_idx, ps = decode_viterbi_movements(
                mv, int(n_steps[i]), spec["e_start"], spec["stride"],
                spec["n_events"], spec["n_kmers"])
            self._commit_chunk(st, spec, ev_idx, k_idx, ps)

    def _next_chunk(self, st: _ReadState):
        """Chunk spec for the read's cursor (eventalign.c:1370-1422), or
        None when this segment is finished."""
        k = self.k
        fwd = st.forward
        if not ((fwd and st.curr_start_event < st.last_event)
                or (not fwd and st.curr_start_event > st.last_event)):
            return None
        pairs = st.pairs
        ref_pos = pairs[:, 0]
        end_pair_idx = _get_end_pair(ref_pos, st.curr_start_ref
                                     + ALIGN_STRIDE, st.curr_pair_idx)
        curr_end_ref = int(pairs[end_pair_idx, 0])
        curr_end_read = int(pairs[end_pair_idx, 1])
        r = st.read
        if r.is_reverse:
            curr_end_read = len(r.seq) - curr_end_read - k
        s = st.curr_start_ref - st.ref_offset
        l = curr_end_ref - st.curr_start_ref + 1
        if l < 2 * k:
            return None
        e_stop = st.closest(curr_end_read)
        if abs(st.curr_start_event - e_stop) < 2:
            return None
        stride = 1 if st.curr_start_event < e_stop else -1
        # window kmer ranks: forward slice, or the rc pool walked backwards
        # (rank[ki] = rc_full[L - s - k - ki], hmm.c:384-401)
        L = len(st.ref_disamb)
        if not r.is_reverse:
            rank_start = st.fwd_off + s
            rank_stride = 1
        else:
            rank_start = st.rc_off + (L - s - k)
            rank_stride = -1
        return dict(rank_start=rank_start, rank_stride=rank_stride,
                    n_kmers=l - k + 1,
                    e_start=st.curr_start_event, n_events=abs(
                        st.curr_start_event - e_stop) + 1,
                    stride=stride, seg_start_ref=st.curr_start_ref,
                    end_pair_idx=end_pair_idx, win_s=s, win_l=l)

    def _commit_chunk(self, st: _ReadState, spec, ev_idx, k_idx, ps):
        """Emit records capped at OUTPUT_STRIDE and advance the cursor
        (eventalign.c:1424-1521)."""
        last_section = spec["end_pair_idx"] == st.pairs.shape[0] - 1
        emit = (ps != 0) & (ev_idx != spec["e_start"])
        if not last_section:
            cum = np.cumsum(emit)
            emit = emit & (cum <= OUTPUT_STRIDE)
        idx = np.nonzero(emit)[0]
        if idx.shape[0] == 0:
            st.done = True
            return
        ref_positions = spec["seg_start_ref"] + k_idx[idx]
        st.out_ref.append(ref_positions.astype(np.int64))
        st.out_ev.append(ev_idx[idx].astype(np.int64))
        st.out_st.append(ps[idx].astype(np.uint8))
        last_event_output = int(ev_idx[idx[-1]])
        last_ref_kmer_output = int(ref_positions[-1])
        st.curr_start_event = last_event_output
        st.curr_start_ref = last_ref_kmer_output
        st.curr_pair_idx = _get_end_pair(st.pairs[:, 0], st.curr_start_ref,
                                         st.curr_pair_idx)


def run_eventalign(pipe, args, out=sys.stdout) -> None:
    """The CLI entry: batch loop + emission in BAM order (meth_main mode 1),
    on the port's ``Pipeline``, its rounds dealt over the pipeline's
    devices."""
    sam = getattr(args, "sam", False)
    paf = getattr(args, "paf", False)
    m6anet = getattr(args, "m6anet", False)
    print_rn = getattr(args, "print_read_names", False)
    scale_events = getattr(args, "scale_events", False)
    samples = getattr(args, "samples", False)
    signal_index = getattr(args, "signal_index", False)
    collapse = getattr(args, "collapse_events", False)
    rna = pipe.opt.rna
    engine = EventalignEngine(pipe.model, region_start=pipe.clip_start,
                              region_end=pipe.clip_end, device=pipe.device,
                              devices=pipe.devices or [pipe.device])
    dist = pipe.opt.dist_markers
    summary_fp = None
    if getattr(args, "summary", None):
        summary_fp = open(args.summary, "w")
        summary_fp.write(summary_header())
    sp = pipe.spans
    sink = AsyncWriter(out, sp)   # post-processor thread (meth_main.c:610)
    if sam:
        sink.write(pipe.bam.header_text.rstrip("\n") + "\n")
    elif not paf and not m6anet:
        sink.write(tsv_header(print_rn, samples, signal_index))
    elif m6anet:
        sink.write(m6anet_header(print_rn, signal_index))

    def realign(reads, recs_map):
        if not reads:
            return
        t0 = sp.now()
        refs = [pipe._fetch_ref_segment(r) for r in reads]
        recs_map.update(engine.realign_batch(
            reads, refs, pipe._host_pool(len(reads))))
        sp.add("hmm", t0)

    keep_raw = samples or collapse
    use_waves = pipe.supports_waves()
    batches = (pipe.batches(load=False) if use_waves
               else pipe.batches_prefetched(keep_raw=keep_raw))
    try:
        # a batch's span: from the loop's request for it to the hand-off
        # of its last rows
        t_batch = sp.now()
        for batch in batches:
            recs_map: dict = {}
            if use_waves:
                pipe.align_batch_waved(
                    batch, keep_raw=keep_raw,
                    wave_done=functools.partial(realign, recs_map=recs_map))
            else:
                pipe.align_batch(batch)
            # reads aligned by windows finish after the waves
            realign([r for r in batch
                     if not r.status and r.b2e_start is not None
                     and id(r) not in recs_map], recs_map)
            t0 = sp.now()
            for r in batch:
                if r.status:
                    pipe._count_failure(r)
                    continue
                pipe.counters["processed"] += 1
                recs = recs_map.get(id(r))
                if recs is None:
                    continue
                contig = pipe.bam.references[r.tid]
                ref_len = pipe.bam.ref_lengths[r.tid]
                if summary_fp is not None and recs.ref_position.shape[0] > 0:
                    if dist:
                        summary_fp.write(f"{MARKER}{r.read_idx}\n")
                    summary_fp.write(summary_line(
                        r.read_idx, r.qname, r.signal_path, rna,
                        summarize_alignment(recs, r, r.nm), r.sample_rate,
                        r.scaling))
                if recs.ref_position.shape[0] == 0:
                    continue
                if dist:
                    sink.write(f"{MARKER}{r.read_idx}\n")
                if paf:
                    sink.write(emit_paf(recs, r, contig, ref_len,
                                        pipe.model.k, rna))
                elif sam:
                    sink.write(emit_sam(recs, r, contig, ref_len,
                                        getattr(args, "sam_out_version", 2),
                                        rna))
                elif m6anet:
                    sink.write(emit_m6anet_tsv(
                        recs, r, pipe.model, contig, recs.ref_disamb,
                        recs.ref_offset, r.read_idx, print_rn,
                        signal_index))
                else:
                    # rendered on the writer thread (the native emitter
                    # releases the GIL)
                    sink.write_lazy(functools.partial(
                        emit_tsv, recs, r, pipe.model, contig,
                        recs.ref_disamb, recs.ref_offset, r.read_idx,
                        print_rn, scale_events, samples, signal_index,
                        collapse, as_bytes=True))
            sp.add("output", t0)
            t_batch = sp.add("batch", t_batch)
    finally:
        t0 = sp.now()
        sink.close()
        sp.add("output", t0, sub="output.drain")
        if summary_fp is not None:
            summary_fp.close()
