"""The benchmark's pool generator, file writers, reference and frozen
roofline, on the CPU."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from pbtest import ROOT, small

from portbench import formats, kmer, pool as P, registry, work
from portbench.reference import abea, eventalign, events, hmm, precision
from portbench.reference import pipeline as RP
from portbench.reference.meth import disambiguate, reverse_complement


def digest(paths) -> dict:
    return {k: hashlib.sha256(open(v, "rb").read()).hexdigest()
            for k, v in paths.items()}


@pytest.mark.parametrize("cell_name", ["meth-r9-typical", "m6anet-rna004"])
def test_pool_is_seeded(cell_name, tmp_path):
    """One seed gives the same files twice; another seed gives other
    files with the same read lengths in each batch."""
    _, cell, config = small(cell_name, reads=12, median=1200)
    gen = registry.generator(cell["generator"])
    a = gen.generate(cell, config, 2 ** 31 + 11, str(tmp_path / "a"))
    b = gen.generate(cell, config, 2 ** 31 + 11, str(tmp_path / "b"))
    c = gen.generate(cell, config, 2 ** 32 + 5, str(tmp_path / "c"))
    assert digest(a.paths) == digest(b.paths)
    assert digest(a.paths)["slow5"] != digest(c.paths)["slow5"]
    # every batch of -K reads holds the same lengths whatever the seed
    k = config["options"]["batch_reads"]
    for i in range(0, len(a.reads), k):
        assert (sorted(len(r.seq) for r in a.reads[i:i + k])
                == sorted(len(r.seq) for r in c.reads[i:i + k]))


def test_pool_length_mix_is_fixed_by_the_cell():
    """Every cell's lengths are the same quantiles whatever the seed, and
    the stated read N50 holds."""
    bench = registry.benchmark(ROOT)
    for name, n50 in (("meth-r9-typical", (9500, 11500)),
                      ("meth-r9-ultralong", (95000, 120000))):
        p = registry.cell(bench, name)["pool"]
        lengths = P.quantile_lengths(p["reads"], p["median"], p["sigma"],
                                     p["min"], p["max"])
        assert n50[0] <= P.n50(lengths) <= n50[1]
        assert 5.5e6 <= lengths.sum() <= 6.5e6


def test_genome_composition():
    cfg = registry.config("r9-dna-cpg")["genome"]
    g0, keep = __import__("portbench.generators.genomic_dna",
                          fromlist=["x"]).depletion(cfg["gc"], cfg["cpg_oe"])
    g = P.random_genome(np.random.default_rng(3), 2_000_000, g0, keep)
    gc, oe = P.composition(g.tobytes())
    assert abs(gc - cfg["gc"]) < 0.01
    assert abs(oe - cfg["cpg_oe"]) < 0.03


def test_molecule_and_cigar_agree():
    rng = np.random.default_rng(9)
    ref = "".join(rng.choice(list("ACGT"), 30_000))
    mol, cigar, span = P.mutate(rng, ref, 20_000, 0.0, 0.002, 5)
    assert len(mol) == 20_000
    assert sum(n for op, n in cigar if op in (0, 1)) == len(mol)
    assert sum(n for op, n in cigar if op in (0, 2)) == span
    q = r = 0
    for op, n in cigar:
        if op == 0:
            assert mol[q:q + n] == ref[r:r + n]
        q += n if op in (0, 1) else 0
        r += n if op in (0, 2) else 0


def test_svb_zd_matches_the_program():
    """The benchmark's encoder writes the program's bytes (slow5lib)."""
    from f5c_tpu_torch import native

    raw = np.random.default_rng(4).integers(-32000, 32000, 5001).astype(
        np.int16)
    raw[:100] = np.cumsum(np.ones(100, np.int16))
    assert formats.svb_zd_encode(raw) == native.svb_zd_encode(raw).tobytes()


def test_the_program_reads_the_pool(tmp_path):
    """The program's readers take the benchmark's BAM and BLOW5."""
    from f5c_tpu_torch.io.bam import BamReader
    from f5c_tpu_torch.io.slow5 import Slow5File

    _, cell, config = small("m6anet-rna004", reads=5, median=600)
    pool = registry.generator(cell["generator"]).generate(
        cell, config, 17, str(tmp_path))
    recs = list(BamReader(pool.paths["bam"]))
    assert [r.qname for r in recs] == [r.qname for r in pool.reads]
    assert [r.cigar for r in recs] == [[tuple(c) for c in r.cigar]
                                       for r in pool.reads]
    f = Slow5File(pool.paths["slow5"])
    try:
        assert f.header.attrs["experiment_type"] == ["rna"]
        for r in pool.reads:
            assert np.array_equal(f.get(r.qname).raw, r.raw)
    finally:
        f.close()


def _events(read, pool, model):
    dig, off, rng_pa, _ = pool.channel
    pa = ((read.raw.astype(np.float32) + np.float32(off))
          * (np.float32(rng_pa) / np.float32(dig)))
    return events.detect_events(pa, rna=pool.rna)


@pytest.mark.parametrize("cell_name", ["meth-r9-typical", "m6anet-rna004"])
def test_fast_abea_is_the_oracle(cell_name, tmp_path):
    _, cell, config = small(cell_name, reads=4, median=2500)
    pool = registry.generator(cell["generator"]).generate(
        cell, config, 23, str(tmp_path))
    model = kmer.load(config["chemistry"]["kmer_table"])
    for r in pool.reads:
        et = _events(r, pool, model)
        means = et.mean[::-1].copy() if pool.rna else et.mean
        mom = abea.estimate_scalings_using_mom(r.seq, model, means)
        a = abea.align(r.seq, means, model, mom)
        b = abea.align_plain(r.seq, means, model, mom)
        assert np.array_equal(a.pairs, b.pairs)
        assert (a.sum_emission, a.n_aligned, a.failed) == (
            b.sum_emission, b.n_aligned, b.failed)


@pytest.mark.parametrize("rc", [False, True])
def test_viterbi_is_the_oracle(rc, tmp_path):
    _, cell, config = small("m6anet-rna004", reads=2, median=900)
    pool = registry.generator(cell["generator"]).generate(
        cell, config, 29, str(tmp_path))
    model = kmer.load(config["chemistry"]["kmer_table"])
    r = pool.reads[0]
    al = RP.aligned_read(r, pool.channel, True, model)
    ref = pool.contigs[r.contig][1][r.pos:RP.ref_span(r.cigar, r.pos)]
    s = disambiguate(ref)[5:105]
    for e0, e1, stride in ((10, 170, 1), (200, 60, -1)):
        a = eventalign.viterbi(s, reverse_complement(s), al["means"],
                               al["scaling"], model, e0, e1, stride, rc,
                               al["events_per_base"])
        b = hmm.profile_hmm_viterbi(s, reverse_complement(s), al["means"],
                                    al["scaling"], model, e0, e1, stride, rc,
                                    al["events_per_base"])
        assert np.array_equal(a[0], [x[0] for x in b])
        assert np.array_equal(a[1], [x[1] for x in b])
        assert np.array_equal(a[2], ["KBM".index(x[2]) for x in b])


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, -3.3, np.inf], np.float32)
    y = precision.bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == np.float32(1.0078125)
    assert abs(y[3] + 3.3) < 0.02 and np.isinf(y[4])


def test_fill_bound_is_chip_smokes():
    """``work.fill_launch_bound`` counts what chip_smoke.bound_of counts
    for one fill launch, from the reads' sizes alone."""
    import torch

    import chip_smoke

    rng = np.random.default_rng(31)
    B = 7
    nb = rng.integers(300, 3000, B)
    ne = rng.integers(400, 5000, B)
    nk = nb - 5
    total = int((ne + nk + 2).sum())
    packed = (int(nb.sum()) + 3) // 4
    packed += -packed % 4
    args = (torch.zeros(int(ne.sum())), torch.zeros(B, dtype=torch.int64),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(packed, dtype=torch.uint8),
            torch.zeros(B, dtype=torch.int64),
            torch.zeros(B, dtype=torch.int32), 6, torch.zeros(4096),
            torch.zeros(4096), torch.zeros(4096), torch.zeros(B, 6),
            torch.zeros(B + 1, dtype=torch.int64), total)
    out = (torch.zeros(total, 32, dtype=torch.uint8),
           torch.zeros(total, dtype=torch.int32),
           torch.zeros(B, dtype=torch.int32))
    ms, _ = chip_smoke.bound_of("abea_fill", args, {}, out)
    assert work.fill_launch_bound(ne, nk, nb, 4096) * 1e3 == pytest.approx(
        ms, rel=1e-12)


def test_windows_counted_as_the_reference_collects_them(tmp_path):
    """``work.cpg_windows`` finds the CpG windows of
    ``reference/meth.py`` (counting only; the HMM roofline's work)."""
    from portbench.reference import meth

    _, cell, config = small("meth-r9-typical", reads=2, median=3000)
    pool = registry.generator(cell["generator"]).generate(
        cell, config, 37, str(tmp_path))
    model = kmer.load(config["chemistry"]["kmer_table"])
    for r in pool.reads:
        al = RP.aligned_read(r, pool.channel, False, model)
        ref = pool.contigs[0][1][r.pos:RP.ref_span(r.cigar, r.pos)]
        groups = meth.collect_meth_groups(ref, r.pos, r.cigar, r.is_reverse,
                                          len(r.seq), al["b2e_start"], 6)
        pairs = work.ref_aligned_events(r.cigar, r.pos, r.is_reverse,
                                        len(r.seq), al["b2e_start"], 6)
        km, ev = work.cpg_windows(ref, r.pos, pairs, 6)
        want_km = [len(g.unmeth.seq) - 5 for g in groups]
        want_ev = [abs(g.unmeth.event_stop_idx - g.unmeth.event_start_idx)
                   + 1 for g in groups]
        assert list(km[::2]) == want_km and list(ev[::2]) == want_ev

