"""resquiggle on PyTorch: the raw signal aligned to the basecalled read
itself.

Counterpart of ``f5c_tpu/pipeline/resquiggle.py`` (the reference's
src/resquiggle.c): FASTQ/FASTA reads + a SLOW5 file or FAST5 directories
(no genome, no BAM) -> events -> ABEA against the read -> calibration QC
-> per-k-mer signal start/end TSV (default) or a PAF-like line with the
``ss:Z:`` run-length signal string (``-c``).  RNA flips the base-to-event
map before output (resquiggle.c:345-356).

It runs on the port's ``Pipeline.bare`` and its wave schedule
(``align_batch_waved``): the card's ABEA kernels and, with the device
events engine, its event detector; the rest is host code shared with
call-methylation and eventalign.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import native
from ..io.fasta import read_fastx
from ..io.readdb import scan_fast5_dirs
from ..models import builtin_model, load_model_file
from .runner import Options, Pipeline, ReadRecord

TSV_HEADER = "read_id\tkmer_idx\tstart_raw_idx\tend_raw_idx\n"


def make_pipeline(args, device) -> Pipeline:
    """The bare pipeline of a resquiggle run (f5c_tpu/pipeline/
    resquiggle.py:_make_pipeline_bare) on ``device``."""
    opt = Options(rna=args.rna, pore=args.pore,
                  kmer_model_path=args.kmer_model,
                  batch_reads=args.batchsize, device=args.device,
                  events_engine=args.events_engine, verbose=args.verbose)
    if args.profile:
        from ..profiles import apply_profile

        apply_profile(opt, args.profile)
    if args.threads:
        opt.num_proc = args.threads
    if opt.kmer_model_path:
        model = load_model_file(opt.kmer_model_path)
    elif opt.rna:
        model = builtin_model("rna004_nucleotide" if opt.pore == "rna004"
                              else "rna_r9_nucleotide")
    else:
        model = builtin_model("dna_r9_nucleotide")
    native.get_lib()     # raises when the host library cannot load
    return Pipeline.bare(opt, model, device=device)


def run_resquiggle(args, device, out=sys.stdout) -> Pipeline:
    """The CLI entry: reads in file order, batches of ``-K`` reads through
    the wave schedule (load, detection, ABEA, postalign), rows in read
    order.  Returns the pipeline (its counters and stage times)."""
    pipe = make_pipeline(args, device)
    opt = pipe.opt
    # reference: default TSV, -c selects PAF (resquiggle.c:46)
    paf = bool(args.paf)
    if not paf:
        out.write(TSV_HEADER)
    mapping = scan_fast5_dirs(args.fast5_dir) if args.fast5_dir else {}
    k = pipe.model.k

    def flush(batch):
        if not batch:
            return
        pipe.align_batch_waved(batch)
        for r in batch:
            if r.status:
                pipe._count_failure(r)
                continue
            pipe.counters["processed"] += 1
            _emit_read(r, k, opt.rna, paf, out)

    batch: list[ReadRecord] = []
    read_idx = 0
    for name, seq, _qual in read_fastx(args.reads):
        seq = seq.upper().replace("U", "T") if opt.rna else seq.upper()
        path = args.slow5 or mapping.get(name, "")
        if not path:
            pipe.counters["bad_signal"] += 1
            continue
        pipe.counters["total_reads"] += 1
        batch.append(ReadRecord(
            qname=name, read_idx=read_idx, tid=-1, pos=0,
            cigar=[(0, len(seq))], is_reverse=False, seq=seq,
            signal_path=path))
        read_idx += 1
        if len(batch) >= opt.batch_reads:
            flush(batch)
            batch = []
    flush(batch)
    return pipe


def _emit_read(r, k: int, rna: bool, paf: bool, out):
    """Per-k-mer signal ranges (src/resquiggle.c:317-456)."""
    n_kmers = len(r.seq) - k + 1
    b2e_start = np.asarray(r.b2e_start).copy()
    b2e_stop = np.asarray(r.b2e_stop).copy()
    if rna:
        # reverse the map and swap start/stop (resquiggle.c:345-356)
        b2e_start, b2e_stop = b2e_stop[::-1].copy(), b2e_start[::-1].copy()
    ev_start = r.event_starts
    ev_len = r.event_lengths
    if not paf:
        out.write(native.emit_resquiggle_tsv(
            r.qname, n_kmers, rna, b2e_start, b2e_stop, ev_start, ev_len))
        return
    parts = []
    ci = 0
    d = 0
    ff = True
    matches = 0
    sig_start2 = -1
    sig_end2 = -1
    read_start = -1
    read_end = -1
    for j in range(n_kmers):
        se = int(b2e_start[j])
        ee = int(b2e_stop[j])
        if se == -1:
            if not ff:
                d += 1
            continue
        sig_s = int(ev_start[se])
        if ff:
            sig_start2 = sig_s
            read_start = j
            ci = sig_s
            ff = False
        sig_e = int(ev_start[ee]) + int(ev_len[ee])
        sig_end2 = sig_e
        read_end = j
        if d > 0:
            parts.append(f"{d}D")
            d = 0
        if j == 0:
            ci = sig_s
        mi = sig_s - ci
        ci += mi
        if mi:
            parts.append(f"{mi}I")
        mi = sig_e - sig_s
        ci += mi
        if mi:
            matches += 1
            parts.append(f"{mi},")
    if sig_start2 == -1:
        return
    t_start = n_kmers - read_start if rna else read_start
    t_end = n_kmers - 1 - read_end if rna else read_end + 1
    out.write(
        f"{r.qname}\t{r.nsample}\t{sig_start2}\t{sig_end2}\t+\t"
        f"{r.qname}\t{n_kmers}\t{t_start}\t{t_end}\t"
        f"{matches}\t{n_kmers}\t255\t"
        f"sc:f:{r.scaling.scale:f}\tsh:f:{r.scaling.shift:f}\t"
        f"ss:Z:{''.join(parts)}\n")
