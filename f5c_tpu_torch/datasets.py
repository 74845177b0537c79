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
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from types import SimpleNamespace

from f5c_tpu.io.bam import BamReader, write_bam
from f5c_tpu.io.fasta import read_fastx
from f5c_tpu.io.readdb import ReadDB
from f5c_tpu.io.slow5 import Slow5File, write_blow5

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
