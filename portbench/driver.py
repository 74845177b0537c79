"""Drives the program as a user of its library does: index the pool,
build one ``Pipeline``, then pass over the pool's BAM again and again,
each pass one ``call_methylation`` or ``run_eventalign`` call, its output
into an in-process sink.

The only hold on the program is ``Clock``, a wrapper around the
``Pipeline`` instance's ``batches`` generator: it stamps each batch as
the program asks for the next one (the batch is then done), and ends a
pass at a batch boundary once the window's time is up.
"""

from __future__ import annotations

import argparse
import hashlib
import time


class Sink:
    """The output stream of one pass: counts and digests every byte and
    keeps the rows of the sampled reads, keyed by the field that names a
    read (``key_field``: the read name of a methylation row, the read
    index of an m6anet row)."""

    def __init__(self, key_field: int, keep: set):
        self.key_field = key_field
        self.keep = keep
        self.sha = hashlib.sha256()
        self.rows: dict = {}

    def write(self, chunk):
        if not chunk:
            return 0
        if isinstance(chunk, bytes):
            chunk = chunk.decode("latin1")
        self.sha.update(chunk.encode("latin1"))
        # one chunk is one read's rows (or the header)
        fields = chunk.split("\t", self.key_field + 1)
        if len(fields) > self.key_field:
            key = fields[self.key_field]
            if key in self.keep:
                self.rows[key] = self.rows.get(key, "") + chunk
        return len(chunk)

    def flush(self):
        pass


class Done:
    """What the work counts of a traced run need of one read the window
    completed; the alignment itself only at a read's first completion."""

    __slots__ = ("qname", "seq", "n_events", "event_means", "status",
                 "b2e_start", "tid", "pos", "cigar", "is_reverse")

    def __init__(self, r, first: bool):
        for k in self.__slots__:
            setattr(self, k, getattr(r, k))
        if self.event_means is not None:
            self.event_means = True
        if not first and self.b2e_start is not None:
            self.b2e_start = True


class Clock:
    """Stamps the batches the program's batch loop takes and stops a pass
    at a batch boundary after ``stop_at`` (perf_counter seconds); with
    ``stash``, keeps each completed batch's reads as ``Done``.
    ``failed_reads``: the reads of completed batches that the program
    failed (dropped, or failed calibration, alignment or QC)."""

    def __init__(self, stash: bool = False):
        self.stop_at = None
        self.stopped = False
        self.t_last = None
        self.batches = []    # (wall s, bases, reads)
        self.done_reads = set()
        self.failed_reads = set()
        self.stash = [] if stash else None

    def wrap(self, batches_fn):
        def gen(*args, **kwargs):
            it = batches_fn(*args, **kwargs)
            try:
                for batch in it:
                    if (self.stop_at is not None
                            and time.perf_counter() >= self.stop_at):
                        self.stopped = True
                        return
                    yield batch
                    # the loop asks for the next batch: this one is done
                    self.done(batch)
            finally:
                it.close()
        return gen

    def done(self, batch) -> None:
        t = time.perf_counter()
        self.batches.append((t - self.t_last, sum(len(r.seq) for r in batch),
                             len(batch)))
        self.t_last = t
        if self.stash is not None:
            self.stash.append([Done(r, r.qname not in self.done_reads)
                               for r in batch])
        self.done_reads.update(r.qname for r in batch)
        self.failed_reads.update(r.qname for r in batch if r.status)


def index(pool) -> None:
    """The program's own ``index`` step, as a user runs it."""
    from f5c_tpu_torch import cli

    code = cli.main(["index", "--slow5", pool.paths["slow5"],
                     pool.paths["reads"]])
    if code:
        raise RuntimeError(f"f5c_tpu_torch index exited {code}")


def pipeline(pool, config: dict, device):
    """One ``Pipeline`` at f5c's defaults and the configuration's stated
    options."""
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    o = config["options"]
    opt = Options(min_mapq=o["min_mapq"], batch_reads=o["batch_reads"],
                  batch_bases=o["batch_bases"],
                  events_engine=o["events_engine"],
                  ultra_thresh=o["ultra_thresh"],
                  meth_out_version=o.get("meth_out_version", 2),
                  slow5_path=pool.paths["slow5"])
    p = pool.paths
    return Pipeline(p["bam"], p["genome"], p["reads"], opt, device)


def key_field(config: dict) -> int:
    return 4 if config["subcommand"] == "call-methylation" else 3


def one_pass(pipe, config: dict, sink: Sink, clock: Clock) -> None:
    """One call of the configuration's subcommand over the whole BAM (or
    up to the clock's stop), its batches stamped by ``clock``."""
    pipe.batches = clock.wrap(pipe.batches)
    clock.t_last = time.perf_counter()
    try:
        if config["subcommand"] == "call-methylation":
            pipe.call_methylation(out=sink)
        else:
            from f5c_tpu_torch.pipeline.eventalign import run_eventalign

            run_eventalign(pipe, argparse.Namespace(**config["eventalign"]),
                           out=sink)
    finally:
        del pipe.batches
