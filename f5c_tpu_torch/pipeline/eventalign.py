"""eventalign on PyTorch: events re-aligned to the reference, segment by
segment, after the port's ABEA.

Counterpart of ``f5c_tpu/pipeline/eventalign.py``.  The row emitters (TSV,
SAM, PAF, m6anet, summary) and the record types are that module's: it
imports no JAX at load, so they are shared, not copied.  What reached JAX
is re-implemented here:

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

from f5c_tpu import native
from f5c_tpu.pipeline.eventalign import (EventAlignmentRecords,
                                         aligned_segments, emit_m6anet_tsv,
                                         emit_paf, emit_sam, emit_tsv,
                                         m6anet_header, revcomp_bytes,
                                         summarize_alignment, summary_header,
                                         summary_line, tsv_header)
from f5c_tpu.pipeline.writer import AsyncWriter

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
        if not native.available():
            raise RuntimeError("eventalign needs the native host library "
                               "(f5c_tpu/native)")
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
