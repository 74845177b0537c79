"""Direct-RNA reads of a transcriptome: random transcripts of the
configuration's length range (lengthened where an expressed one is
shorter than its longest read), expressed with Zipf-like skew; each read
is anchored at its transcript's 3' end and truncated at the 5' end to
its length, which comes from the cell's distribution; the signal passes
3' to 5' (``_pore_reads`` of ``f5c_tpu_torch/synthetic.py``, commit
5f95a86, at run scale).

Cell parameters (``pool``): ``reads``, the truncated log-normal
``median``, ``sigma``, ``min``, ``max`` of their lengths, ``mismatch``,
``indel``, ``indel_max``.  Configuration (``transcriptome``):
``transcripts``, their length distribution, the Zipf exponent.
"""

from __future__ import annotations

import numpy as np

from .. import kmer, pool as P


def generate(cell: dict, config: dict, seed: int, dst: str) -> P.Pool:
    rng = np.random.default_rng(seed)
    par, tx, chem = cell["pool"], config["transcriptome"], config["chemistry"]
    model = kmer.load(chem["kmer_table"])
    channel = tuple(chem["channel"])
    tx_len = P.quantile_lengths(tx["transcripts"], tx["median"],
                                tx["sigma"], tx["min"], tx["max"])
    tx_len = tx_len[rng.permutation(tx_len.shape[0])]
    lengths = P.fixed_order(P.quantile_lengths(
        par["reads"], par["median"], par["sigma"], par["min"], par["max"]))
    # reads a transcript by expression (Zipf); each expressed transcript
    # takes the next reads of the fixed order, so that every seed's BAM,
    # and so its batches and waves, hold nearly the same lengths
    weight = 1.0 / np.arange(1, tx_len.shape[0] + 1) ** tx["zipf"]
    counts = rng.multinomial(lengths.shape[0], weight / weight.sum())
    order = [int(t) for t in rng.permutation(tx_len.shape[0])]
    order = ([t for t in order if counts[t]]
             + [t for t in order if not counts[t]])
    # a transcript's reads sort together in the BAM, so no block crosses
    # a batch of the configuration's -K reads; the reads a cut leaves
    # over go one each to the transcripts that drew none
    per_batch = config["options"]["batch_reads"]
    contigs, reads, i = [], [], 0
    for c, t in enumerate(order):
        block = lengths[i:min(i + (counts[t] or 1),
                              (i // per_batch + 1) * per_batch,
                              lengths.shape[0])]
        n_tx = int(tx_len[t])
        if block.shape[0]:
            # long enough for its longest read and that read's deletions
            n_tx = max(n_tx, int(block.max()) * 51 // 50 + 50)
        ref = P.random_genome(rng, n_tx, 0.5, 1.0).tobytes().decode()
        contigs.append((f"tx{c:04d}", ref))
        for n in block:
            n = int(n)
            # copied from the 3' end backwards, so that the molecule ends
            # where its transcript does
            mol, cigar, span = P.mutate(rng, ref[::-1], n, par["mismatch"],
                                        par["indel"], par["indel_max"])
            mol, cigar = mol[::-1], cigar[::-1]
            raw = P.simulate_signal(rng, mol, model, chem["dwell"],
                                    chem["noise_sd"], chem["noise_pa"],
                                    channel, reverse_time=True)
            reads.append(P.Read(qname=f"read{i:05d}", seq=mol, contig=c,
                                pos=len(ref) - span, flag=0, cigar=cigar,
                                bam_seq=mol, raw=raw))
            i += 1
    return P.write_pool(dst, contigs, reads, channel,
                        chem.get("blow5_attrs", {}), rna=True)
