"""Genomic DNA reads of a nanopore run: a random genome of the
configuration's composition, reads of the cell's length distribution
from random positions on both strands, each a noisy copy of its span.

Cell parameters (``pool``): ``reads`` and the truncated log-normal
``median``, ``sigma``, ``min``, ``max`` of their lengths; ``mismatch``
and ``indel`` rates a base and ``indel_max``.  Configuration
(``genome``, ``chemistry``): genome size and composition (GC share,
CpG observed / expected), the pore-model table, the channel, the dwell
range and the noise.
"""

from __future__ import annotations

import numpy as np

from .. import kmer, pool as P


def depletion(gc: float, cpg_oe: float) -> tuple[float, float]:
    """(GC share before depletion, share of CpGs kept) that give a genome
    of GC share ``gc`` and CpG observed / expected ``cpg_oe``."""
    g = gc
    for _ in range(50):
        f = (g / 2) ** 2
        keep = cpg_oe * (g / 2 - f) * (g / 2) / (f * (1 - cpg_oe * g / 2))
        g = gc + (1 - keep) * f
    return g, keep


def generate(cell: dict, config: dict, seed: int, dst: str) -> P.Pool:
    rng = np.random.default_rng(seed)
    par, gen, chem = cell["pool"], config["genome"], config["chemistry"]
    model = kmer.load(chem["kmer_table"])
    channel = tuple(chem["channel"])
    g0, keep = depletion(gen["gc"], gen["cpg_oe"])
    genome = P.random_genome(rng, gen["bases"], g0, keep).tobytes().decode()
    lengths = P.fixed_order(P.quantile_lengths(
        par["reads"], par["median"], par["sigma"], par["min"], par["max"]))
    # mapping positions ascend in that order, so that every seed's BAM,
    # and so its batches and waves, hold the same lengths
    top = len(genome) - int(lengths.max()) * 21 // 20 - 400
    starts = np.sort(rng.integers(100, top, lengths.shape[0]))
    reads = []
    for i, n in enumerate(lengths):
        n = int(n)
        room = n + n // 20 + 200
        pos = int(starts[i])
        mol, cigar, _span = P.mutate(rng, genome[pos:pos + room], n,
                                     par["mismatch"], par["indel"],
                                     par["indel_max"])
        flag = 16 if rng.random() < 0.5 else 0
        seq = P.revcomp(mol) if flag else mol
        raw = P.simulate_signal(rng, seq, model, chem["dwell"],
                                chem["noise_sd"], chem["noise_pa"], channel)
        reads.append(P.Read(qname=f"read{i:05d}", seq=seq, contig=0,
                            pos=pos, flag=flag, cigar=cigar, bam_seq=mol,
                            raw=raw))
    return P.write_pool(dst, [(gen["contig"], genome)], reads, channel,
                        chem.get("blow5_attrs", {}), rna=False)
