"""The port's copy of the host stack against the JAX package's own.

The port keeps its own copies of the host modules it runs (native C++
library, pore models, options, eventalign emitters).  Here the same
inputs -- the golden set and seeded synthetic reads -- go through both,
and the outputs must be identical: byte for byte for arrays and text.
Also: the port stands alone, so a process that imports every module of
the port and runs its CLI on the golden set has no module of ``f5c_tpu``
and no ``jax`` loaded.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from f5c_tpu import native as jax_native
from f5c_tpu.pipeline import eventalign as jax_ea
from f5c_tpu.pipeline import runner as jax_runner
from f5c_tpu_torch import datasets, native, synthetic
from f5c_tpu_torch.io.fast5 import Signal
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import abea
from f5c_tpu_torch.pipeline import eventalign as port_ea
from f5c_tpu_torch.pipeline import runner as port_runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")


def _same(a, b):
    """Equal types, shapes and bytes (arrays), or equal values."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif dataclasses.is_dataclass(a):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            _same(fa[k], fb[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b or (a != a and b != b)


def _golden_signals():
    return list(datasets._signals(datasets.GOLDEN_SIGNALS_ZLIB))


def _synthetic_signals(seed, n_reads):
    rng = np.random.default_rng(seed)
    model = builtin_model("dna_r9_nucleotide")
    seqs = [synthetic.random_seq(rng, int(n))
            for n in rng.integers(300, 3000, n_reads)]
    sigs = [Signal(raw=datasets.simulate_signal(rng, s, model),
                   digitisation=datasets.DIGITISATION,
                   offset=datasets.OFFSET, range=datasets.RANGE,
                   sample_rate=datasets.SAMPLE_RATE, read_id=f"s{i}")
            for i, s in enumerate(seqs)]
    return sigs, seqs


def _golden_seqs():
    from f5c_tpu_torch.io.fasta import read_fastx

    return {q: s for q, s, _ in
            read_fastx(os.path.join(GOLDEN, "reads.fasta"))}


@pytest.mark.parametrize("case", ["golden", "synthetic", "rna"])
def test_native_prep_reads_many(case):
    """Event tables, ranks and MoM scalings of one batched native call."""
    if case == "golden":
        sigs = _golden_signals()
        seqs = [_golden_seqs()[s.read_id] for s in sigs]
    else:
        sigs, seqs = _synthetic_signals(31 if case == "synthetic" else 32,
                                        9)
    model = builtin_model("rna_r9_nucleotide" if case == "rna"
                          else "dna_r9_nucleotide")
    rna = case == "rna"
    for keep_pa in (False, True):
        got = native.prep_reads_many(sigs, seqs, model.k, model.level_mean,
                                     rna=rna, keep_pa=keep_pa)
        want = jax_native.prep_reads_many(sigs, seqs, model.k,
                                          model.level_mean, rna=rna,
                                          keep_pa=keep_pa)
        assert len(got) == len(want) == len(sigs)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("k,meth", [(5, False), (6, False), (9, False),
                                    (6, True)])
def test_native_kmer_ranks(k, meth):
    rng = np.random.default_rng(40 + k)
    alphabet = list("ACGMT") if meth else list("ACGTN")
    for n in (0, k - 1, k, 1000):
        seq = "".join(rng.choice(alphabet, n))
        _same(native.kmer_ranks(seq, k, meth=meth),
              jax_native.kmer_ranks(seq, k, meth=meth))


@pytest.mark.parametrize("seed", [50, 51])
def test_native_decode_qc_postalign(seed):
    """The host half of ABEA on walks from the port's plain fill and walk
    (one read with events that do not follow it fails QC)."""
    rng = np.random.default_rng(seed)
    model = builtin_model("dna_r9_nucleotide")
    n_kmers = [int(n) for n in rng.integers(30, 600, 7)]
    seqs, events = synthetic.abea_reads(rng, n_kmers, model, unrelated=(2,))
    x = synthetic.abea_inputs(seqs, events, model)
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in x.items()}
    fill = abea.abea_fill_plain(*(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        "level_mean", "level_stdv", "level_log_stdv", "params",
        "band_off")))
    flat, n = abea.abea_walk_plain(fill[0], fill[1], t["band_off"], fill[2],
                                   t["rk_len"], t["byte_off"])
    flat, n, start_e = flat.numpy(), n.numpy(), fill[2].numpy()
    bo = x["byte_off"]
    for i, (seq, ev) in enumerate(zip(seqs, events)):
        ranks = native.kmer_ranks(seq, model.k)
        args = (flat[bo[i]:bo[i + 1]], int(n[i]), int(start_e[i]), ranks,
                ev, model.level_mean, model.level_stdv,
                model.level_log_stdv, 1.0, 0.0, -5.0, 50, 200)
        got = native.decode_qc_postalign(*args)
        want = jax_native.decode_qc_postalign(*args)
        if got[0] or not got[1]:
            # failed QC or calibration: the base-to-event maps are
            # unwritten scratch; the verdict and the QC numbers agree
            got, want = ((r[0], r[1], r[7], r[8]) for r in (got, want))
        _same(got, want)
    assert int(n.min()) > 0


@pytest.mark.parametrize("seed", [60, 61])
def test_native_disambiguate_and_meth_groups(seed):
    """CpG group collection over a seeded reference with insertions,
    deletions, soft clips and both strands."""
    rng = np.random.default_rng(seed)
    k = 6
    for trial in range(6):
        n = int(rng.integers(200, 3000))
        ref = "".join(rng.choice(list("ACGTNRY"), n, p=[.22, .25, .25, .22,
                                                        .02, .02, .02]))
        ref = ref.encode()
        dis = native.disambiguate(ref)
        _same(dis, jax_native.disambiguate(ref))
        m1 = int(rng.integers(50, n // 2))
        cig = [(4, int(rng.integers(0, 20))), (0, m1), (1, 7), (2, 5),
               (0, n - m1 - 5)]
        ops = np.array([c[0] for c in cig], np.int32)
        lens = np.array([c[1] for c in cig], np.int32)
        read_len = int(sum(ln for op, ln in cig if op in (0, 1, 4)))
        b2e = np.cumsum(rng.integers(0, 3, read_len - k + 1)).astype(
            np.int32)
        b2e[rng.random(b2e.shape[0]) < 0.05] = -1
        args = (dis, int(rng.integers(0, 10_000)), ops, lens,
                bool(trial % 2), read_len, b2e, k)
        _same(native.collect_meth_groups(*args),
              jax_native.collect_meth_groups(*args))


@pytest.mark.parametrize("seed", [70, 71])
def test_native_viterbi_chunk(seed):
    """The port's binding of f5c_viterbi_chunk against the JAX package's:
    the same movements on a synthetic round (both strides of ranks and
    events, chunks of 12-105 bases)."""
    rng = np.random.default_rng(seed)
    model = builtin_model("dna_r9_nucleotide")
    x = synthetic.viterbi_round(rng, model, 12)
    for c in x["chunks"]:
        args = (c["ranks"], c["rank_start"], c["rank_stride"],
                c["n_kmers"], c["ev_pool"], c["e_start"], c["stride"],
                c["n_events"], c["scale"], c["shift"], c["var"],
                c["events_per_base"], model.level_mean, model.level_stdv,
                model.level_log_stdv)
        got = native.viterbi_chunk(*args)
        assert got.shape[0] > c["n_events"] // 2
        _same(got, jax_native.viterbi_chunk(*args))


@pytest.mark.parametrize("rna", [False, True])
def test_native_emit_resquiggle_tsv(rna):
    """The port's binding of f5c_emit_resquiggle_tsv against the JAX
    package's, unaligned k-mers included."""
    rng = np.random.default_rng(80 + rna)
    n_ev = 500
    starts = np.cumsum(rng.integers(1, 9, n_ev)).astype(np.int64)
    lens = rng.integers(1, 9, n_ev).astype(np.float32)
    for n_kmers in (1, 37, 300):
        b2e_start = np.sort(rng.integers(0, n_ev, n_kmers)).astype(np.int32)
        b2e_stop = np.minimum(b2e_start + rng.integers(0, 3, n_kmers),
                              n_ev - 1).astype(np.int32)
        b2e_start[rng.random(n_kmers) < 0.1] = -1
        args = ("read-" + str(n_kmers), n_kmers, rna, b2e_start, b2e_stop,
                starts, lens)
        got = native.emit_resquiggle_tsv(*args)
        assert got.count("\n") == n_kmers
        assert got == jax_native.emit_resquiggle_tsv(*args)


def test_options_defaults():
    got = dataclasses.fields(port_runner.Options)
    want = dataclasses.fields(jax_runner.Options)
    assert [f.name for f in got] == [f.name for f in want]
    for g, w in zip(got, want):
        assert (g.type, g.default) == (w.type, w.default), g.name
    assert port_runner.Options() == port_runner.Options(
        **dataclasses.asdict(jax_runner.Options()))


def _records(rng, n, rc):
    ref_position = np.sort(rng.integers(100, 100 + n // 2, n)).astype(
        np.int64)
    if rc:
        ref_position = ref_position[::-1].copy()
    return SimpleNamespace(
        ref_position=ref_position,
        event_idx=np.arange(5, 5 + n, dtype=np.int64),
        state=np.where(rng.random(n) < 0.1, 1, 2).astype(np.uint8),
        rc=rc)


def _read(rng, n_events):
    lengths = rng.integers(3, 20, n_events).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths[:-1])]).astype(np.int64)
    nsample = int(starts[-1] + lengths[-1])
    return SimpleNamespace(
        qname="read_x", sample_rate=4000.0, nsample=nsample,
        event_starts=starts, event_lengths=lengths,
        event_means=rng.normal(90, 10, n_events).astype(np.float32),
        event_stdvs=rng.uniform(1, 3, n_events).astype(np.float32),
        raw_pa=rng.normal(90, 10, nsample).astype(np.float32),
        scaling=native.Scalings(shift=1.5, scale=1.1, var=1.3),
        flag=16, pos=99, mapq=60, seq="ACGTACGTAC", qual="*",
        sam_aux=("NM:i:1",), cigar=[(4, 2), (0, 6), (2, 1), (0, 2)])


@pytest.mark.parametrize("rc", [False, True])
def test_eventalign_emitters(rc):
    """Every emitter on fixed records: identical text."""
    rng = np.random.default_rng(70 + rc)
    model = builtin_model("dna_r9_nucleotide")
    rd = _read(rng, 400)
    ref_disamb = "".join(rng.choice(list("ACGT"), 400)).encode()
    fields = _records(rng, 300, rc)
    recs = {m: m.EventAlignmentRecords(
        ref_position=fields.ref_position, event_idx=fields.event_idx,
        state=fields.state, rc=rc, ref_disamb=ref_disamb, ref_offset=100)
        for m in (port_ea, jax_ea)}
    for flags in [(False, False, False, False, False),
                  (True, True, True, True, True),
                  (False, True, False, True, False)]:
        got, want = (m.emit_tsv(recs[m], rd, model, "ctg", ref_disamb, 100,
                                7, *flags) for m in (port_ea, jax_ea))
        assert got == want and got
    for flags in [(False, False), (True, True)]:
        got, want = (m.emit_m6anet_tsv(recs[m], rd, model, "ctg",
                                       ref_disamb, 100, 7, *flags)
                     for m in (port_ea, jax_ea))
        assert got == want and got
    for rna in (False, True):
        assert (port_ea.emit_paf(recs[port_ea], rd, "ctg", 5000, 6, rna)
                == jax_ea.emit_paf(recs[jax_ea], rd, "ctg", 5000, 6, rna))
        for version in (1, 2):
            assert (port_ea.emit_sam(recs[port_ea], rd, "ctg", 5000,
                                     version, rna)
                    == jax_ea.emit_sam(recs[jax_ea], rd, "ctg", 5000,
                                       version, rna))
    summaries = [m.summarize_alignment(recs[m], rd, 3)
                 for m in (port_ea, jax_ea)]
    assert summaries[0] == summaries[1]
    assert (port_ea.summary_line(7, "read_x", "p.blow5", False,
                                 summaries[0], 4000.0, rd.scaling)
            == jax_ea.summary_line(7, "read_x", "p.blow5", False,
                                   summaries[1], 4000.0, rd.scaling))
    for m in (False, True):
        assert port_ea.tsv_header(m, m, m) == jax_ea.tsv_header(m, m, m)
        assert port_ea.m6anet_header(m, m) == jax_ea.m6anet_header(m, m)
    assert port_ea.summary_header() == jax_ea.summary_header()


def test_port_stands_alone(tmp_path):
    """A fresh interpreter imports every module of the port (the
    multi-device and multi-process layer of ``parallel/`` among them),
    runs call-methylation, eventalign and resquiggle on the golden set on
    the CPU, and has loaded no module of f5c_tpu and no jax."""
    code = f"""
import importlib, os, pkgutil, sys
import f5c_tpu_torch
names = [m.name for m in pkgutil.walk_packages(f5c_tpu_torch.__path__,
                                               "f5c_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {{"f5c_tpu_torch.parallel.distributed", "f5c_tpu_torch.parallel.mesh",
        "f5c_tpu_torch.parallel.mesh_check"}} <= set(names), names
from f5c_tpu_torch import datasets
from f5c_tpu_torch.cli import main
d = datasets.copy_dataset(datasets.dataset({GOLDEN!r},
    slow5=datasets.GOLDEN_SIGNALS_ZLIB), {str(tmp_path / "g")!r})
args = ["--device", "cpu", "--min-mapq", "0", "-b", d["bam"], "-g",
        d["genome"], "-r", d["reads"], "--slow5", d["slow5"]]
assert main(["call-methylation", *args, "-o", {str(tmp_path / "m.tsv")!r}]) == 0
assert main(["eventalign", *args, "-o", {str(tmp_path / "e.tsv")!r},
             "--summary", {str(tmp_path / "s.tsv")!r}]) == 0
assert main(["resquiggle", "--device", "cpu", d["reads"], "--slow5",
             d["slow5"], "-o", {str(tmp_path / "r.tsv")!r}]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("f5c_tpu", "jax"))
assert not bad, bad
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 30
    with open(tmp_path / "m.tsv") as f:
        assert len(f.read().splitlines()) > 6
