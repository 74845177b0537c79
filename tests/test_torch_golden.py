"""Golden end-to-end gate for the port: ``call-methylation`` on the
vendored dataset (tests/data/golden/) with ``device="cpu"`` -- the
kernels' plain PyTorch versions -- must process all 6 reads with 0
deviant rows against meth.exp under f5c's tolerance (the comparison of
tests/test_golden_e2e.py).  The CLI case also shows that a whole run never
imports jax.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

from test_golden_e2e import GOLDEN, _tolerant_compare

from f5c_tpu_torch import datasets

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "meth.exp")),
    reason="golden fixtures not generated")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """The vendored dataset with its indexes built in tmp."""
    tmp = str(tmp_path_factory.mktemp("golden_torch"))
    datasets.copy_dataset(datasets.dataset(GOLDEN), tmp)
    return tmp


@pytest.fixture(scope="module")
def golden_zlib_dir(tmp_path_factory):
    """The same, with the zlib copy of the signals (as chip_smoke.py)."""
    tmp = str(tmp_path_factory.mktemp("golden_torch_zlib"))
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), tmp)
    return tmp


def test_zlib_signals_match_golden(golden_dir, golden_zlib_dir):
    pytest.importorskip("zstandard")
    from f5c_tpu.io.slow5 import Slow5File

    a = Slow5File(os.path.join(golden_dir, "signals.blow5"))
    b = Slow5File(os.path.join(golden_zlib_dir, "signals.blow5"))
    assert b.header.rec_press == "zlib"
    assert a.read_ids() == b.read_ids() and len(a.read_ids()) == 6
    for rid in a.read_ids():
        x, y = a.get(rid), b.get(rid)
        assert x.raw.dtype == y.raw.dtype and (x.raw == y.raw).all()
        assert (x.digitisation, x.offset, x.range, x.sample_rate) == (
            y.digitisation, y.offset, y.range, y.sample_rate)
    a.close()
    b.close()


def _truth():
    with open(os.path.join(GOLDEN, "meth.exp")) as f:
        return f.read()


def test_pipeline_call_methylation_cpu(golden_dir):
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    slow5 = os.path.join(golden_dir, "signals.blow5")
    opt = Options(min_mapq=0, meth_out_version=1, slow5_path=slow5)
    pipe = Pipeline(os.path.join(golden_dir, "reads.bam"),
                    os.path.join(golden_dir, "genome.fa"),
                    os.path.join(golden_dir, "reads.fasta"), opt,
                    device=torch.device("cpu"))
    out = io.StringIO()
    pipe.call_methylation(out=out)
    assert pipe.counters["processed"] == 6
    # float cols: log_lik_ratio, log_lik_methylated, log_lik_unmethylated
    _tolerant_compare(out.getvalue(), _truth(), {4, 5, 6})


def test_cli_runs_without_jax(golden_zlib_dir):
    golden_dir = golden_zlib_dir
    out_path = os.path.join(golden_dir, "meth_cli.tsv")
    argv = ["call-methylation", "--device", "cpu", "--min-mapq", "0",
            "--meth-out-version", "1",
            "-b", os.path.join(golden_dir, "reads.bam"),
            "-g", os.path.join(golden_dir, "genome.fa"),
            "-r", os.path.join(golden_dir, "reads.fasta"),
            "--slow5", os.path.join(golden_dir, "signals.blow5"),
            "-o", out_path]
    code = ("import sys\n"
            "from f5c_tpu_torch.cli import main\n"
            f"rc = main({argv!r})\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=golden_dir,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "processed: 6" in proc.stderr
    with open(out_path) as f:
        _tolerant_compare(f.read(), _truth(), {4, 5, 6})


def test_cli_without_card_is_an_error():
    from f5c_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main(["call-methylation", "-b", "x.bam", "-g", "x.fa",
                 "-r", "x.fa"]) == 2


def test_bam_ordered_path(golden_dir, capsys):
    """--print-raw loads in BAM order, so the batch takes align_batch (one
    ABEA launch) and meth_batch's direct path instead of the waves."""
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    slow5 = os.path.join(golden_dir, "signals.blow5")
    opt = Options(min_mapq=0, meth_out_version=1, slow5_path=slow5,
                  print_raw=True)
    pipe = Pipeline(os.path.join(golden_dir, "reads.bam"),
                    os.path.join(golden_dir, "genome.fa"),
                    os.path.join(golden_dir, "reads.fasta"), opt,
                    device=torch.device("cpu"))
    assert not pipe.supports_waves()
    out = io.StringIO()
    pipe.call_methylation(out=out)
    assert pipe.counters["processed"] == 6
    assert capsys.readouterr().out.count("\tLN:") == 6   # the raw dumps
    _tolerant_compare(out.getvalue(), _truth(), {4, 5, 6})


def test_reads_past_tpu_limits_are_routed():
    """Reads past the JAX runner's TPU limits (65,536 k-mers or 131,072
    events) used to raise here.  They now take the port's routing rule:
    the unchunked path while their trace fits a wave's share of the
    budget, the windowed path of the ultra-long reads beyond it."""
    from types import SimpleNamespace

    from f5c_tpu.models import builtin_model
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    pipe = Pipeline.bare(Options(), builtin_model("dna_r9_nucleotide"))
    ok = SimpleNamespace(qname="r", seq="A" * 2000, n_events=4000)
    assert not pipe._takes_window_path(ok)
    for n_bases, n_events in ((70_000, 1000), (1000, 140_000)):
        long = SimpleNamespace(qname="r", seq="A" * n_bases,
                               n_events=n_events)
        assert not pipe._takes_window_path(long)
    ultra = SimpleNamespace(qname="r", seq="A" * 100_000, n_events=168_000)
    assert pipe._takes_window_path(ultra)
