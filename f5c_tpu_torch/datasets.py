"""Prepared copies of a call-methylation dataset (BAM, genome FASTA, reads
FASTA, BLOW5), for the end-to-end gates and throughput runs.

A dataset is a dict of paths by role: ``bam``, ``genome``, ``reads``,
``slow5``.  ``copy_dataset`` copies one into a directory and indexes the
copy (readdb + BLOW5 index), so the source stays read-only;
``replicate_dataset`` makes an N-fold copy in which every read copy
carries a unique read id, so a small vendored set (the 6-read
tests/data/golden/) becomes one realistically sized batch.

``GOLDEN_SIGNALS_ZLIB`` holds the records of tests/data/golden/
signals.blow5 recompressed from zstd to zlib (``recompress_blow5``), so
that the golden set reads without the optional ``zstandard`` module.

``ultra_dataset`` writes a seeded synthetic set of ultra-long reads (100
to 300 kb), the input of the windowed ABEA path.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from types import SimpleNamespace

import numpy as np

from .io.bam import BamReader, write_bam
from .io.fast5 import Signal
from .io.fasta import read_fastx
from .io.readdb import ReadDB
from .io.slow5 import Slow5File, write_blow5
from .models import builtin_model

ROLES = {"bam": "reads.bam", "genome": "genome.fa", "reads": "reads.fasta",
         "slow5": "signals.blow5"}
GOLDEN_SIGNALS_ZLIB = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "data", "golden_signals.zlib.blow5")


def dataset(directory: str, slow5: str | None = None) -> dict:
    """The dataset of ``directory`` (files named as in ROLES), optionally
    with its signals taken from ``slow5``."""
    paths = {role: os.path.join(directory, name)
             for role, name in ROLES.items()}
    if slow5 is not None:
        paths["slow5"] = slow5
    return paths


def copy_name(qname: str, copy: int) -> str:
    return f"{qname}_{copy:03d}"


def _index(paths: dict) -> None:
    ReadDB(paths["reads"]).build(slow5_path=paths["slow5"])


def copy_dataset(src: dict, dst: str) -> dict:
    """Copy ``src`` into ``dst`` and index the copy."""
    os.makedirs(dst, exist_ok=True)
    out = dataset(dst)
    for role, path in src.items():
        shutil.copy(path, out[role])
    _index(out)
    return out


def _signals(path: str) -> list:
    """Every record of a BLOW5 file, read from a scratch copy (opening a
    file indexes it in place)."""
    tmp = path + f".read{os.getpid()}"
    shutil.copy(path, tmp)
    try:
        f = Slow5File(tmp)
        try:
            return [f.get(rid) for rid in f.read_ids()]
        finally:
            f.close()
    finally:
        for p in (tmp, tmp + ".idx"):
            if os.path.exists(p):
                os.remove(p)


def replicate_dataset(src: dict, dst: str, copies: int) -> dict:
    """Write ``copies`` copies of every read of ``src`` into ``dst``: read
    ``q``'s copy c is ``copy_name(q, c)``, the BAM stays coordinate-sorted
    (copies of one record are adjacent), and the genome is shared."""
    os.makedirs(dst, exist_ok=True)
    out = dataset(dst)
    shutil.copy(src["genome"], out["genome"])
    bam = BamReader(src["bam"])
    refs = list(zip(bam.references, bam.ref_lengths))
    records = sorted(bam, key=lambda r: (r.tid, r.pos))
    write_bam(out["bam"], refs, [
        SimpleNamespace(qname=copy_name(r.qname, c), flag=r.flag, tid=r.tid,
                        pos=r.pos, mapq=r.mapq, cigar=r.cigar, seq=r.seq)
        for r in records for c in range(copies)])
    with open(out["reads"], "w") as f:
        for name, seq, _qual in read_fastx(src["reads"]):
            for c in range(copies):
                f.write(f">{copy_name(name, c)}\n{seq}\n")
    write_blow5(out["slow5"], (
        dataclasses.replace(s, read_id=copy_name(s.read_id, c))
        for s in _signals(src["slow5"]) for c in range(copies)),
        rec_press="zlib")
    _index(out)
    return out


def recompress_blow5(src: str, dst: str) -> None:
    """Rewrite a BLOW5 file's records with zlib compression (signals
    unchanged: svb-zd)."""
    write_blow5(dst, _signals(src), rec_press="zlib")


# the channel of scripts/make_golden_fixtures.py
DIGITISATION, RANGE, OFFSET, SAMPLE_RATE = 8192.0, 1467.61, 10.0, 4000.0
ULTRA_GENOME = 400_000


def simulate_signal(rng, seq: str, model) -> np.ndarray:
    """Raw int16 samples of a read: each k-mer dwells 6-12 samples at its
    pore-model level with noise of 0.6 of its stdv -- the simulation of
    scripts/make_golden_fixtures.py:_simulate_signal, vectorised."""
    ranks = model.kmer_ranks(seq)
    dwell = rng.integers(6, 13, ranks.shape[0])
    mean = np.repeat(model.level_mean[ranks].astype(np.float64), dwell)
    sd = np.repeat(model.level_stdv[ranks].astype(np.float64) * 0.6, dwell)
    pa = rng.normal(mean, sd)
    raw = np.rint(pa * DIGITISATION / RANGE - OFFSET)
    return np.clip(raw, -32000, 32000).astype(np.int16)


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


# bands of one launch, under every read of ultra_dataset (270,240 and
# up) and over four windows of WIN_BANDS (262,144): a TRACE_BYTES_BUDGET
# of abea_cuda.LAUNCH_BYTES_PER_BAND x this sends all four reads to the
# windowed path, in one window launch
ULTRA_WINDOWED_SHARE = 265_000


def ultra_dataset(dst: str, seed: int = 2026, scale: float = 1.0) -> dict:
    """Write a seeded synthetic dataset of ultra-long R9 DNA reads into
    ``dst`` (BAM, genome FASTA, reads FASTA, zlib BLOW5), indexed.

    A random 400 kb genome and 4 reads of 100, 150, 200 and 300 kb: ul100
    forward and exact, ul150 reverse strand, ul200 forward with 40-base
    soft clips at both ends, a 25-base insertion and a 35-base deletion,
    ul300 forward with 1 % mismatches -- about 0.75 M k-mers and 6.8 M
    samples.  At ~1.7 events per base (2.70 bands a base) the reads have
    270,240 to 811,435 bands: at the defaults every read takes the
    unchunked fill, ul300 in a solo launch, being over the wave share of
    796,178 bands (Pipeline._leaves_wave), and a TRACE_BYTES_BUDGET under
    one launch of 270,240 bands (ULTRA_WINDOWED_SHARE) sends all four to
    the windowed path (Pipeline._takes_window_path).  ``scale``
    shrinks the genome and the reads (not the clips and indels), for runs
    of the plain versions on the host."""
    rng = np.random.default_rng(seed)
    model = builtin_model("dna_r9_nucleotide")
    bases = np.array(list("ACGT"))

    def kb(n):
        return int(n * 1000 * scale)

    def rand(n):
        return "".join(rng.choice(bases, n))

    genome = rand(kb(400))
    reads = []      # (qname, read seq, flag, pos, cigar, BAM seq)
    seg = genome[0:kb(100)]
    reads.append(("ul100", seg, 0, 0, [(0, len(seg))], seg))
    p = kb(230)
    seg = genome[p:p + kb(150)]
    reads.append(("ul150", _revcomp(seg), 16, p, [(0, len(seg))], seg))
    p, m1, dl, m2 = kb(150), kb(100), 35, kb(100)
    clip, ins = rand(40), rand(25)
    read = (clip + genome[p:p + m1] + ins
            + genome[p + m1 + dl:p + m1 + dl + m2] + clip)
    reads.append(("ul200", read, 0, p,
                  [(4, 40), (0, m1), (1, 25), (2, dl), (0, m2), (4, 40)],
                  read))
    p = kb(60)
    seg = list(genome[p:p + kb(300)])
    for i in np.nonzero(rng.random(len(seg)) < 0.01)[0]:
        seg[i] = "ACGT"[("ACGT".index(seg[i]) + int(rng.integers(1, 4)))
                        % 4]
    seg = "".join(seg)
    reads.append(("ul300", seg, 0, p, [(0, len(seg))], seg))
    reads.sort(key=lambda t: t[3])

    os.makedirs(dst, exist_ok=True)
    out = dataset(dst)
    with open(out["genome"], "w") as f:
        f.write(f">ultra_ctg\n{genome}\n")
    with open(out["reads"], "w") as f:
        for qname, seq, *_ in reads:
            f.write(f">{qname}\n{seq}\n")
    write_bam(out["bam"], [("ultra_ctg", len(genome))], [
        SimpleNamespace(qname=q, flag=flag, tid=0, pos=pos, mapq=60,
                        cigar=cigar, seq=bam_seq)
        for q, _seq, flag, pos, cigar, bam_seq in reads])
    write_blow5(out["slow5"], (
        Signal(raw=simulate_signal(rng, seq, model),
               digitisation=DIGITISATION, offset=OFFSET, range=RANGE,
               sample_rate=SAMPLE_RATE, read_id=q)
        for q, seq, *_ in reads), rec_press="zlib")
    _index(out)
    return out
