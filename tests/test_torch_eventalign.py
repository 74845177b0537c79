"""The port's eventalign (f5c_tpu_torch/pipeline/eventalign.py) on the
golden set: ``python -m f5c_tpu_torch.cli eventalign --device cpu
--summary ...`` against eventalign.exp.gz and eventalign.summary.exp with
the columns and tolerance of tests/test_golden_e2e.py:104-125, through the
normal ABEA path and with every read forced through the windowed one; the
engine selection; and that the port's eventalign, ultra-long and CLI
modules import no jax.
"""

import gzip
import os
import subprocess
import sys

import pytest

from test_golden_e2e import GOLDEN, _tolerant_compare

from f5c_tpu_torch import datasets
from f5c_tpu_torch.pipeline import eventalign
from f5c_tpu_torch.pipeline.runner import Pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EA_FLOAT_COLS = {6, 7, 8, 10, 11, 12}   # event mean/stdv/duration, model
SUMMARY_FLOAT_COLS = {9, 10, 11, 12, 13}  # total_duration, shift..var

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "eventalign.exp.gz")),
    reason="golden fixtures not generated")


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden_ea"))
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), tmp)
    return tmp


def _norm_summary(text: str) -> str:
    """The summary's fast5_path column is machine-specific."""
    rows = []
    for ln in text.rstrip("\n").split("\n"):
        c = ln.split("\t")
        if len(c) > 2:
            c[2] = os.path.basename(c[2])
        rows.append("\t".join(c))
    return "\n".join(rows) + "\n"


def _eventalign(golden_dir, tag, *extra):
    from f5c_tpu_torch.cli import main

    out = os.path.join(golden_dir, f"ea_{tag}.tsv")
    summary = os.path.join(golden_dir, f"ea_{tag}.summary.tsv")
    rc = main(["eventalign", "--device", "cpu", "--min-mapq", "0",
               "-b", os.path.join(golden_dir, "reads.bam"),
               "-g", os.path.join(golden_dir, "genome.fa"),
               "-r", os.path.join(golden_dir, "reads.fasta"),
               "--slow5", os.path.join(golden_dir, "signals.blow5"),
               "-o", out, "--summary", summary, *extra])
    return rc, out, summary


@pytest.mark.parametrize("windowed", [False, True])
def test_cli_eventalign_golden(golden_dir, monkeypatch, windowed):
    routed = []
    if windowed:
        align_ultra_batch = Pipeline._align_ultra_batch

        def spy(self, todo, ranks):
            routed.extend(r.qname for r in todo)
            align_ultra_batch(self, todo, ranks)

        monkeypatch.setattr(Pipeline, "TRACE_BYTES_BUDGET", 1_000_000)
        monkeypatch.setattr(Pipeline, "WIN_BANDS", 300)
        monkeypatch.setattr(Pipeline, "_align_ultra_batch", spy)
    rc, out, summary = _eventalign(golden_dir, f"w{int(windowed)}")
    assert rc == 0
    assert len(routed) == (6 if windowed else 0)
    with gzip.open(os.path.join(GOLDEN, "eventalign.exp.gz"), "rt") as f:
        truth = f.read()
    with open(out) as f:
        _tolerant_compare(f.read(), truth, EA_FLOAT_COLS)
    with open(os.path.join(GOLDEN, "eventalign.summary.exp")) as f:
        truth_sum = f.read()
    with open(summary) as f:
        _tolerant_compare(_norm_summary(f.read()), _norm_summary(truth_sum),
                          SUMMARY_FLOAT_COLS)


@pytest.mark.parametrize("name", ["device", "python"])
def test_unported_engine_is_an_error(golden_dir, monkeypatch, name):
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 "
                                                  "item a"):
        eventalign.engine_name()
    rc, out, _ = _eventalign(golden_dir, f"engine_{name}")
    assert rc == 2 and not os.path.exists(out)


def test_auto_engine_is_native(monkeypatch):
    from f5c_tpu.models import builtin_model

    for name in ("auto", "native"):
        monkeypatch.setenv("F5C_TPU_EA_ENGINE", name)
        engine = eventalign.EventalignEngine(
            builtin_model("dna_r9_nucleotide"))
        assert engine.engine == "native"


def test_modules_import_no_jax():
    code = ("import sys\n"
            "import f5c_tpu_torch.pipeline.eventalign\n"
            "import f5c_tpu_torch.ops.abea_ultra\n"
            "import f5c_tpu_torch.ops.abea_ultra_cuda\n"
            "import f5c_tpu_torch.cli\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
