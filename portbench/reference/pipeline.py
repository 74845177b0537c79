"""The plain reference of one read, raw signal to answer, in NumPy.

f5c's per-read chain (f5c.c, align.c, meth.c, eventalign.c) from the
modules beside this one, which are frozen copies of the JAX package's
NumPy oracles (``f5c_tpu/ops/events_ref.py``, ``abea_ref.py``,
``scaling.py``, ``hmm_ref.py``, ``f5c_tpu/pipeline/methylation.py`` at
commit 5f95a86): event detection, method-of-moments scaling, adaptive
banded alignment with its QC, postalign and recalibration, then either
the CpG HMM (``meth_read``) or the re-alignment and m6anet rows
(``m6anet_read``, ``eventalign.py``).

It imports nothing of the program and takes nothing the program made:
its inputs are the pool's raw samples, sequences, mappings and
reference, and the frozen tables of ``portbench/tables``.

``q`` rounds what passes between stages; ``precision.bf16`` is the
control (the reference one precision below the configuration's float32).
"""

from __future__ import annotations

import numpy as np

from . import abea, events, meth, scaling
from .constants import (AVG_EVENTS_PER_KMER_MAX, MAX_EVENTS_PER_BASE,
                        MIN_CALIBRATION_VAR)

FAILED = "failed"


def ident(x):
    return x


def ref_span(cigar, pos: int) -> int:
    """The reference end of a mapping (M, D, N, =, X consume it)."""
    return pos + sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))


def aligned_read(read, channel, rna: bool, model, q=ident,
                 min_events_to_rescale: int = 200):
    """Events, alignment, postalign and recalibration of one read: a dict
    (event arrays, b2e_start, scaling, events_per_base) or None where f5c
    fails the read."""
    dig, off, rng_pa, _rate = channel
    unit = np.float32(rng_pa) / np.float32(dig)
    pa = q((read.raw.astype(np.float32) + np.float32(off)) * unit)
    et = events.detect_events(pa, rna=rna)
    means, stdvs = q(et.mean), q(et.stdv)
    starts, lengths = et.start, et.length
    seq = read.seq
    mom = abea.estimate_scalings_using_mom(seq, model, means)
    mom = abea.Scalings(shift=float(q(np.float32(mom.shift))),
                        scale=float(q(np.float32(mom.scale))), var=1.0)
    if rna:
        means, starts = means[::-1].copy(), starts[::-1].copy()
        lengths, stdvs = lengths[::-1].copy(), stdvs[::-1].copy()
    n_kmers = len(seq) - model.k + 1
    if means.shape[0] / len(seq) >= AVG_EVENTS_PER_KMER_MAX:
        return None
    res = abea.align(seq, means, model, mom)
    if res.failed:
        return None
    ranks = model.kmer_ranks(seq)
    post = scaling.postalign_np(res.pairs, ranks, n_kmers)
    ok, rc = scaling.recalibrate_np(model.level_mean, model.level_stdv,
                                    ranks, means, post,
                                    min_events_to_rescale)
    if not ok or rc.var > MIN_CALIBRATION_VAR:
        return None
    if post.events_per_base > MAX_EVENTS_PER_BASE:
        return None
    rc = abea.Scalings(shift=float(q(np.float32(rc.shift))),
                       scale=float(q(np.float32(rc.scale))),
                       var=float(q(np.float32(rc.var))))
    return dict(means=means, stdvs=stdvs, starts=starts, lengths=lengths,
                b2e_start=post.base_to_event_start, scaling=rc,
                events_per_base=post.events_per_base, pairs=res.pairs)


def meth_read(read, pool, model, cpg_model, q=ident,
              scored=None) -> dict | str:
    """{start: (end, n_cpg, sequence, ll_methylated, ll_unmethylated)} of
    one read, or FAILED; ``scored`` picks the CpG groups to score (the
    others' log-likelihoods are None)."""
    al = aligned_read(read, pool.channel, pool.rna, model, q)
    if al is None:
        return FAILED
    name, genome = pool.contigs[read.contig]
    ref_seq = genome[read.pos:ref_span(read.cigar, read.pos)]
    sites = meth.call_methylation_for_read(
        ref_seq, read.pos, read.cigar, read.is_reverse, len(read.seq),
        al["means"], al["b2e_start"], al["scaling"], cpg_model,
        al["events_per_base"], q=None if q is ident else q, scored=scored)
    return {s: (v.end_position, v.n_cpg, v.sequence, v.ll_methylated,
                v.ll_unmethylated) for s, v in sites.items()}


def m6anet_read(read, pool, model, q=ident) -> dict | str:
    """{ref position: (k-mer, mean, stdv, duration, start, end)} of one
    read's m6anet rows, or FAILED."""
    from . import eventalign

    al = aligned_read(read, pool.channel, pool.rna, model, q)
    if al is None:
        return FAILED
    name, genome = pool.contigs[read.contig]
    ref_seq = genome[read.pos:ref_span(read.cigar, read.pos)]
    return eventalign.m6anet_rows(read, al, ref_seq, model, pool.channel[3],
                                  q=None if q is ident else q)
