"""eventalign on PyTorch: events re-aligned to the reference, segment by
segment, after the port's ABEA.

Counterpart of ``f5c_tpu/pipeline/eventalign.py``.  The record type and
the row emitters (TSV, SAM, PAF, m6anet, summary; eventalign.c:1574-2349
column for column) are that module's, copied.  What reached JAX is
re-implemented here:

- ``EventalignEngine`` runs the re-alignment with the native engine only:
  the whole-read C++ loop ``native.realign_read`` (eventalign.c
  realign_read), read by read over the host pool.  It needs nothing from
  the card; the card's share of eventalign is ABEA, done by the port's
  ``Pipeline``.  ``F5C_TPU_EA_ENGINE`` = ``auto`` (default) or ``native``
  both mean the native engine until the device Viterbi engine (K8) is
  ported; ``device`` and ``python``, the engines built on it, are an
  error that names the ROADMAP item.
- ``run_eventalign`` is the batch loop and emission of the JAX module's
  ``run_eventalign`` (eventalign.py:1012-1128) with this engine.  The
  re-alignment of a wave runs on the host while the card fills the next
  wave; reads aligned by windows (ultra-long) finish after the waves.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from .. import native
from ..io.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH,
                      CREF_SKIP, CSOFT_CLIP)
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


K8_ITEM = ("the device Viterbi engine (K8, f5c_tpu/ops/hmm.py "
           "hmm_viterbi_rounds) is not ported to f5c_tpu_torch yet: see "
           "ROADMAP.md, Queue 1 item a")


def engine_name() -> str:
    """The re-alignment engine that ``F5C_TPU_EA_ENGINE`` selects."""
    name = os.environ.get("F5C_TPU_EA_ENGINE", "auto")
    if name in ("device", "python"):
        raise NotImplementedError(f"F5C_TPU_EA_ENGINE={name}: {K8_ITEM}")
    if name not in ("auto", "native"):
        raise ValueError(f"F5C_TPU_EA_ENGINE={name!r}: expected auto, "
                         "native, device or python")
    return "native"


class EventalignEngine:
    """Batched re-alignment of reads that passed ABEA + QC, with the
    native engine (see the module docstring)."""

    def __init__(self, model, region_start: int = -1, region_end: int = -1):
        self.engine = engine_name()
        native.get_lib()     # raises when the host library cannot load
        self.model = model
        self.k = model.k
        self.region_start = region_start
        self.region_end = region_end

    def _realign_one(self, r, ref_seq: str):
        m, k = self.model, self.k
        dis = native.disambiguate(ref_seq.upper().encode())
        segs = aligned_segments(r.cigar, r.pos)
        if self.region_start != -1 and self.region_end != -1:
            segs = [s[(s[:, 0] >= self.region_start)
                      & (s[:, 0] <= self.region_end)] for s in segs]
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

    def realign_batch(self, reads, ref_segments, pool=None) -> dict:
        """{id(read): EventAlignmentRecords}; ``ref_segments[i]`` is read
        i's reference from its mapping position to its end.  Reads are
        independent and the C++ loop releases the GIL, so ``pool`` (a
        thread pool, or None) runs them side by side."""
        if pool is not None:
            return dict(pool.map(self._realign_one, reads, ref_segments))
        return dict(self._realign_one(r, s)
                    for r, s in zip(reads, ref_segments))


def run_eventalign(pipe, args, out=sys.stdout) -> None:
    """The CLI entry: batch loop + emission in BAM order (meth_main mode 1),
    on the port's ``Pipeline``."""
    if pipe.opt.dist_markers:
        raise NotImplementedError("--dist is not ported to f5c_tpu_torch "
                                  "yet (ROADMAP.md)")
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
                              region_end=pipe.clip_end)
    summary_fp = None
    if getattr(args, "summary", None):
        summary_fp = open(args.summary, "w")
        summary_fp.write(summary_header())
    sink = AsyncWriter(out)   # post-processor thread (meth_main.c:610)
    if sam:
        sink.write(pipe.bam.header_text.rstrip("\n") + "\n")
    elif not paf and not m6anet:
        sink.write(tsv_header(print_rn, samples, signal_index))
    elif m6anet:
        sink.write(m6anet_header(print_rn, signal_index))

    def realign(reads, recs_map):
        if not reads:
            return
        t0 = time.time()
        refs = [pipe._fetch_ref_segment(r) for r in reads]
        recs_map.update(engine.realign_batch(
            reads, refs, pipe._host_pool(len(reads))))
        pipe.stage_time["hmm"] += time.time() - t0

    keep_raw = samples or collapse
    use_waves = pipe.supports_waves()
    batches = (pipe.batches(load=False) if use_waves
               else pipe.batches_prefetched(keep_raw=keep_raw))
    try:
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
            t0 = time.time()
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
                    summary_fp.write(summary_line(
                        r.read_idx, r.qname, r.signal_path, rna,
                        summarize_alignment(recs, r, r.nm), r.sample_rate,
                        r.scaling))
                if recs.ref_position.shape[0] == 0:
                    continue
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
            pipe.stage_time["output"] += time.time() - t0
    finally:
        t0 = time.time()
        sink.close()
        pipe.stage_time["output"] += time.time() - t0
        if summary_fp is not None:
            summary_fp.close()
