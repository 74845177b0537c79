"""A cell's pool of reads: the files handed to the program, and what the
reference needs to judge its answers (every read's sequence, mapping,
raw signal and the reference sequence).

The generators (``generators/<name>.py``) build pools from a cell's
parameters and a seed.  Their parts shared here:

- read lengths are fixed quantiles of a truncated log-normal
  distribution, so every seed gives the same multiset of lengths;
- a molecule is its reference span with point mismatches and small
  indels, written into the CIGAR;
- a read's raw signal is simulated k-mer by k-mer from a pore-model
  table: ``simulate_signal`` is a frozen copy of
  ``f5c_tpu_torch/datasets.py`` ``simulate_signal`` (commit 5f95a86),
  its dwell range and noise taken from the configuration;
- the files are a genome FASTA, a reads FASTA, a coordinate-sorted BAM
  and a BLOW5 file (``formats.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from statistics import NormalDist
from types import SimpleNamespace

import numpy as np

from . import formats

CMATCH, CINS, CDEL = 0, 1, 2
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


@dataclass
class Read:
    qname: str
    seq: str             # as sequenced, 5' to 3' (T alphabet)
    contig: int          # index into Pool.contigs
    pos: int             # 0-based leftmost reference position
    flag: int            # 16: reverse strand
    cigar: list          # [(op, length)] over the BAM sequence
    bam_seq: str         # the molecule on the reference strand
    raw: np.ndarray      # int16 samples
    read_idx: int = -1   # its index in BAM order

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)


@dataclass
class Pool:
    paths: dict                    # bam, genome, reads, slow5
    contigs: list                  # [(name, sequence)]
    reads: list                    # [Read] in BAM order
    channel: tuple                 # digitisation, offset, range, rate
    rna: bool


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def quantile_lengths(n: int, median: float, sigma: float, lo: float,
                     hi: float) -> np.ndarray:
    """``n`` lengths at the mid-quantiles (i + 0.5) / n of a log-normal
    (``median``, ``sigma``) truncated to [lo, hi], longest first."""
    nd = NormalDist()
    mu = np.log(median)
    plo = nd.cdf((np.log(lo) - mu) / sigma)
    phi = nd.cdf((np.log(hi) - mu) / sigma)
    q = plo + (phi - plo) * (np.arange(n) + 0.5) / n
    z = np.array([nd.inv_cdf(float(x)) for x in q])
    return np.rint(np.exp(mu + sigma * z)).astype(np.int64)[::-1].copy()


def fixed_order(lengths: np.ndarray) -> np.ndarray:
    """``lengths`` in one shuffled order, the same for every seed (the
    order the reads take in the BAM)."""
    return lengths[np.random.default_rng(0).permutation(lengths.shape[0])]


def n50(lengths) -> int:
    s = np.sort(np.asarray(lengths))[::-1]
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, c[-1] / 2)])


def random_genome(rng, n: int, gc: float, cpg_keep: float) -> np.ndarray:
    """u8 ACGT of ``n`` bases at GC share ``gc``, then every CpG's C turned
    to T with probability 1 - ``cpg_keep`` (methyl-C deamination, which
    leaves the human genome's CpGs at about a quarter of their expected
    count)."""
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    g = np.frombuffer(b"ACGT", np.uint8)[rng.choice(4, size=n, p=p)].copy()
    cg = np.nonzero((g[:-1] == ord("C")) & (g[1:] == ord("G")))[0]
    g[cg[rng.random(cg.shape[0]) >= cpg_keep]] = ord("T")
    return g


def composition(seq) -> tuple[float, float]:
    """(GC share, CpG observed / expected) of a sequence."""
    a = np.frombuffer(seq.encode() if isinstance(seq, str) else bytes(seq),
                      np.uint8)
    c = float((a == ord("C")).mean())
    g = float((a == ord("G")).mean())
    cg = float(((a[:-1] == ord("C")) & (a[1:] == ord("G"))).mean())
    return c + g, cg / (c * g)


def mutate(rng, ref: str, length: int, mismatch: float, indel: float,
           indel_max: int):
    """A molecule of ``length`` bases read from the start of ``ref``
    (which must be long enough) with point mismatches at rate
    ``mismatch`` and insertions or deletions of 1..``indel_max`` bases at
    rate ``indel`` a base.  Returns (molecule, CIGAR, reference span)."""
    n_indel = rng.binomial(length, indel)
    at = np.sort(rng.choice(np.arange(50, max(51, length - 50)),
                            size=min(n_indel, max(0, length - 100)),
                            replace=False))
    mol, cigar = [], []
    rpos = qlen = 0
    for a in at:
        # an indel at molecule position a, after the bases before it
        m = int(a) - qlen
        if m <= 0:
            continue
        mol.append(ref[rpos:rpos + m])
        rpos += m
        qlen += m
        cigar.append((CMATCH, m))
        ln = int(rng.integers(1, indel_max + 1))
        if rng.random() < 0.5:
            mol.append("".join("ACGT"[i] for i in rng.integers(0, 4, ln)))
            qlen += ln
            cigar.append((CINS, ln))
        else:
            rpos += ln
            cigar.append((CDEL, ln))
    m = length - qlen
    mol.append(ref[rpos:rpos + m])
    rpos += m
    cigar.append((CMATCH, m))
    if sum(map(len, mol)) != length:
        raise ValueError(f"reference too short for a molecule of {length}")
    seq = np.frombuffer("".join(mol).encode(), np.uint8).copy()
    hit = np.nonzero(rng.random(seq.shape[0]) < mismatch)[0]
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), seq[hit])
    seq[hit] = np.frombuffer(b"ACGT", np.uint8)[
        (codes + rng.integers(1, 4, hit.shape[0])) % 4]
    merged = []
    for op, ln in cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + ln)
        else:
            merged.append((op, ln))
    return seq.tobytes().decode(), merged, rpos


def simulate_signal(rng, seq: str, model, dwell, noise_sd: float,
                    noise_pa: float, channel, reverse_time: bool = False
                    ) -> np.ndarray:
    """Raw int16 samples of a read: each k-mer dwells ``dwell[0]`` to
    ``dwell[1] - 1`` samples at its table level, with Gaussian noise of
    ``noise_sd`` times its table stdv plus ``noise_pa`` pA; with
    ``reverse_time`` the k-mers pass 3' to 5' (direct RNA)."""
    dig, off, rng_pa, _rate = channel
    ranks = model.kmer_ranks(seq)
    if reverse_time:
        ranks = ranks[::-1]
    reps = rng.integers(dwell[0], dwell[1], ranks.shape[0])
    mean = np.repeat(model.level_mean[ranks].astype(np.float64), reps)
    sd = np.repeat(model.level_stdv[ranks].astype(np.float64) * noise_sd
                   + noise_pa, reps)
    pa = rng.normal(mean, sd)
    raw = np.rint(pa * dig / rng_pa - off)
    return np.clip(raw, -32000, 32000).astype(np.int16)


def write_pool(dst: str, contigs, reads, channel, attrs, rna: bool) -> Pool:
    """Write the files of a pool into ``dst`` (reads sorted by mapping
    position; read_idx set to BAM order) and return it."""
    os.makedirs(dst, exist_ok=True)
    paths = {"bam": os.path.join(dst, "reads.bam"),
             "genome": os.path.join(dst, "genome.fa"),
             "reads": os.path.join(dst, "reads.fasta"),
             "slow5": os.path.join(dst, "signals.blow5")}
    reads = sorted(reads, key=lambda r: (r.contig, r.pos, r.qname))
    for i, r in enumerate(reads):
        r.read_idx = i
    with open(paths["genome"], "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            b = np.frombuffer(seq.encode(), np.uint8)
            full = b.shape[0] // 60 * 60
            lines = np.concatenate(
                [b[:full].reshape(-1, 60),
                 np.full((full // 60, 1), ord("\n"), np.uint8)], axis=1)
            f.write(lines.tobytes().decode())
            if full < b.shape[0]:
                f.write(seq[full:] + "\n")
    formats.write_fasta(paths["reads"], (
        (r.qname, r.seq.replace("T", "U") if rna else r.seq) for r in reads))
    formats.write_bam(paths["bam"], [(n, len(s)) for n, s in contigs], [
        SimpleNamespace(qname=r.qname, flag=r.flag, tid=r.contig, pos=r.pos,
                        mapq=60, cigar=r.cigar, seq=r.bam_seq)
        for r in reads])
    formats.write_blow5(paths["slow5"], ((r.qname, r.raw) for r in reads),
                        channel, attrs)
    return Pool(paths=paths, contigs=list(contigs), reads=reads,
                channel=tuple(channel), rna=rna)
