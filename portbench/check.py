"""How ``correct`` is decided: the program's rows for a sample of the
reads that the window completed, against the plain reference's answers
for the same reads, computed after the window in worker processes.

The sample is drawn from the seed: reads in a seeded order, taken while
the cell's ``check.sample_reads`` and ``check.sample_max_bases`` allow;
with ``check.sample_longest`` the pool's longest read besides.  Every
read that the program failed in the window joins it (up to
``FAILED_MAX``, drawn from the seed), so that the reference judges
whether f5c fails it too.  With
``check.sites_per_read`` the reference scores that many of a read's CpG
groups, drawn from the seed, and holds the others to their place alone.
Each number compared has its limit in the cell's file (``check.limits``);
``passes_differing`` (complete passes whose output bytes differ from the
first's) is held to 0 in every cell.

Numbers:

- ``site_dev_pct`` (call-methylation): the share of the sampled reads'
  CpG sites, the union of both sides, at which the program's row is
  missing or extra, names another end, motif count or sequence, or
  reports a log-likelihood ratio that differs from the reference's by
  more than ``check.llr_tol`` absolute plus ``check.llr_rel`` relative
  (f5c's tolerance); a site the reference placed and did not score
  counts only where it deviates.
- ``row_dev_pct`` (eventalign --m6anet): the share of the sampled reads'
  reference positions, the union of both sides, at which the program's
  row is missing or extra, names another k-mer or signal index, or
  reports a mean, stdv or duration off by more than
  ``check.mean_tol``, ``check.stdv_tol`` or ``check.dur_tol``.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

import numpy as np

from . import kmer
from .reference import pipeline, precision


def sample(pool, cell: dict, seed: int) -> list:
    """The reads drawn for the check, in BAM order."""
    rng = np.random.default_rng([seed, 0x5EED])
    chk = cell["check"]
    out, bases = [], 0
    if chk.get("sample_longest"):
        out.append(max(pool.reads, key=lambda r: len(r.seq)))
    for i in rng.permutation(len(pool.reads)):
        r = pool.reads[int(i)]
        if r in out or bases + len(r.seq) > chk["sample_max_bases"]:
            continue
        out.append(r)
        bases += len(r.seq)
        if len(out) == chk["sample_reads"] + bool(chk.get("sample_longest")):
            break
    return sorted(out, key=lambda r: r.read_idx)


FAILED_MAX = 8


def failed_sample(pool, failed: set, done: set, whole_pass: bool,
                  seed: int) -> list:
    """The reads that the program failed in the window, for the check:
    those of completed batches whose status says so (``failed``, read
    names) and, once a pass has run whole, the reads it never handed on
    (the pool's reads missing from ``done``); at most ``FAILED_MAX``,
    drawn from the seed."""
    out = [r for r in pool.reads if r.qname in failed
           or (whole_pass and r.qname not in done)]
    if len(out) > FAILED_MAX:
        rng = np.random.default_rng([seed, 0xFA11])
        out = [out[int(i)] for i in sorted(
            rng.choice(len(out), FAILED_MAX, replace=False))]
    return out


def key_of(read, config: dict) -> str:
    """The field that names a read in the program's rows."""
    if config["subcommand"] == "call-methylation":
        return read.qname
    return str(read.read_idx)


def _light(pool, read):
    """What the reference of one read needs: its record and its
    reference span, without the rest of the genome."""
    name, genome = pool.contigs[read.contig]
    end = pipeline.ref_span(read.cigar, read.pos)
    seg = SimpleNamespace(contigs={read.contig: (name, _Span(
        genome[read.pos:end], read.pos))}, channel=pool.channel,
        rna=pool.rna)
    return seg


class _Span:
    """A slice of a contig that answers slices in contig coordinates."""

    def __init__(self, seq: str, start: int):
        self.seq, self.start = seq, start

    def __getitem__(self, sl):
        return self.seq[sl.start - self.start:sl.stop - self.start]


class Scored:
    """The CpG groups of a read that the reference scores: ``n`` drawn
    from (seed, read index), or all."""

    def __init__(self, n, seed: int, read_idx: int):
        self.n, self.seed, self.read_idx = n, seed, read_idx

    def __call__(self, groups):
        if self.n is None or len(groups) <= self.n:
            return range(len(groups))
        rng = np.random.default_rng([self.seed, self.read_idx])
        return rng.choice(len(groups), self.n, replace=False).tolist()


def _answer(job):
    subcommand, chem, read, light, control, scored = job
    q = precision.bf16 if control else pipeline.ident
    model = kmer.load(chem["kmer_table"])
    if subcommand == "call-methylation":
        return pipeline.meth_read(read, light, model,
                                  kmer.load(chem["meth_table"]), q, scored)
    return pipeline.m6anet_read(read, light, model, q)


def _jobs(pool, config: dict, reads, control: bool, cell, seed: int):
    n = (cell or {}).get("check", {}).get("sites_per_read")
    return [(config["subcommand"], config["chemistry"], r, _light(pool, r),
             control, Scored(n, seed, r.read_idx)) for r in reads]


def _workers(jobs) -> int:
    return max(1, min(len(jobs), (os.cpu_count() or 2) - 2))


class Pending:
    """The reference's answers for ``reads``, computed in worker
    processes on the CPU from the moment it is made, while the caller
    goes on; ``result()`` waits for them, ``close()`` for the workers."""

    def __init__(self, pool, config: dict, reads, cell: dict | None = None,
                 seed: int = 0):
        jobs = _jobs(pool, config, reads, False, cell, seed)
        self._ex = ProcessPoolExecutor(
            max_workers=_workers(jobs),
            mp_context=multiprocessing.get_context("spawn")) if jobs else None
        self._futures = [self._ex.submit(_answer, j) for j in jobs]

    def result(self) -> list:
        return [f.result() for f in self._futures]

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex, self._futures = None, []
            stop_resource_tracker()


def stop_resource_tracker() -> None:
    """End multiprocessing's resource tracker, which a pool of spawned
    workers starts, and wait for it: it would outlive the run otherwise,
    a process nobody waits for.  A later pool starts it anew."""
    from multiprocessing import resource_tracker

    gc.collect()    # the pool's semaphores, unregistered as they go
    rt = resource_tracker._resource_tracker
    with rt._lock:
        if rt._fd is None:
            return
        os.close(rt._fd)
        rt._fd = None
        if rt._pid is not None:
            os.waitpid(rt._pid, 0)
            rt._pid = None


def reference(pool, config: dict, reads, control: bool = False,
              workers: int | None = None, cell: dict | None = None,
              seed: int = 0) -> list:
    """The reference's answer for each read, in worker processes."""
    jobs = _jobs(pool, config, reads, control, cell, seed)
    workers = workers or _workers(jobs)
    if workers == 1 or len(jobs) == 1:
        return [_answer(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        out = list(ex.map(_answer, jobs))
    del ex
    stop_resource_tracker()
    return out


def parse_rows(text: str, config: dict) -> dict:
    """The program's rows of one read, keyed as the reference keys its
    answer."""
    out = {}
    for line in text.splitlines():
        f = line.split("\t")
        if config["subcommand"] == "call-methylation":
            # chrom strand start end name llr llm llu strands motifs seq
            out[int(f[2])] = (int(f[3]), int(f[9]), f[10], float(f[6]),
                              float(f[7]), float(f[5]))
        else:
            # contig pos kmer index mean stdv duration "" start end
            out[int(f[1])] = (f[2], float(f[4]), float(f[5]), float(f[6]),
                              int(f[8]), int(f[9]))
    return out


def site_deviates(p, r, chk: dict) -> bool:
    end, n, seq, llm, llu = r
    if p[:3] != (end, n, seq):
        return True
    llr = llm - llu
    return abs(p[5] - llr) > chk["llr_tol"] + chk["llr_rel"] * abs(llr)


def row_deviates(p, r, chk: dict) -> bool:
    kmer_, mean, stdv, dur, s0, s1 = r
    return (p[0] != kmer_ or p[4] != s0 or p[5] != s1
            or abs(p[1] - mean) > chk["mean_tol"]
            or abs(p[2] - stdv) > chk["stdv_tol"]
            or abs(p[3] - dur) > chk["dur_tol"])


def deviation(program: dict, answers: dict, config: dict, chk: dict):
    """(units deviating, units compared) over the reads of ``answers``
    ({key: answer}; ``program``: {key: the program's rows})."""
    meth = config["subcommand"] == "call-methylation"
    bad = total = 0
    for key, ans in answers.items():
        rows = parse_rows(program.get(key, ""), config)
        ref = {} if ans == pipeline.FAILED else ans
        for pos in set(rows) | set(ref):
            if pos not in rows or pos not in ref:
                bad, total = bad + 1, total + 1
            elif meth and ref[pos][3] is None:
                # a site the reference placed but did not score
                if rows[pos][:3] != ref[pos][:3]:
                    bad, total = bad + 1, total + 1
            else:
                total += 1
                bad += (site_deviates(rows[pos], ref[pos], chk) if meth
                        else row_deviates(rows[pos], ref[pos], chk))
    return bad, total


def number_name(config: dict) -> str:
    return ("site_dev_pct" if config["subcommand"] == "call-methylation"
            else "row_dev_pct")


def judge(program: dict, answers: dict, config: dict, cell: dict,
          passes_differing: int) -> tuple[bool, dict]:
    """(correct, {number: [value, limit]}) of a run."""
    chk = cell["check"]
    bad, total = deviation(program, answers, config, chk)
    name = number_name(config)
    value = 100.0 * bad / total if total else 100.0
    numbers = {name: [value, chk["limits"][name]],
               "passes_differing": [passes_differing, 0],
               "units_compared": [total, "> 0"]}
    ok = (total > 0 and value <= chk["limits"][name]
          and passes_differing == 0)
    return ok, numbers


def rows_of(answer, config: dict) -> str:
    """A reference answer as the program's rows (for the control, which
    stands in the program's place)."""
    if answer == pipeline.FAILED:
        return ""
    out = []
    for pos in sorted(answer):
        if config["subcommand"] == "call-methylation":
            end, n, seq, llm, llu = answer[pos]
            if llm is None:
                llm = llu = 0.0
            out.append(f"c\t+\t{pos}\t{end}\tr\t{llm - llu:.2f}\t{llm:.2f}\t"
                       f"{llu:.2f}\t1\t{n}\t{seq}\n")
        else:
            kmer_, mean, stdv, dur, s0, s1 = answer[pos]
            out.append(f"c\t{pos}\t{kmer_}\tr\t{mean:.2f}\t{stdv:.3f}\t"
                       f"{dur:.5f}\t\t{s0}\t{s1}\n")
    return "".join(out)
