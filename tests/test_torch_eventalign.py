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

        # under each golden read's own launch (2,679 x 39.25 B and up)
        monkeypatch.setattr(Pipeline, "TRACE_BYTES_BUDGET", 100_000)
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
def test_lockstep_engines_match_native(golden_dir, monkeypatch, name):
    """``F5C_TPU_EA_ENGINE=device`` and ``=python`` (on the CPU, the
    Viterbi kernel's plain version and the host DP) write the native
    engine's bytes.  An unknown engine is an error before any work."""
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "native")
    rc, out_n, sum_n = _eventalign(golden_dir, "engine_native")
    assert rc == 0
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", name)
    assert eventalign.engine_name() == name
    rc, out, summary = _eventalign(golden_dir, f"engine_{name}")
    assert rc == 0
    for a, b in ((out, out_n), (summary, sum_n)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "viterbi")
    with pytest.raises(ValueError, match="F5C_TPU_EA_ENGINE"):
        eventalign.engine_name()
    rc, out, _ = _eventalign(golden_dir, "engine_bad")
    assert rc == 2 and not os.path.exists(out)


def test_auto_engine_is_native(monkeypatch):
    """``auto`` is the native engine on every device, with no probe (the
    JAX rule's pick, the device engine, lost end to end on the card:
    PERF.md); ``python`` probes its host/device crossover, and
    ``device`` runs every round through the kernel's wrapper."""
    import torch

    from f5c_tpu_torch.models import builtin_model

    model = builtin_model("dna_r9_nucleotide")
    for name in ("auto", "native"):
        monkeypatch.setenv("F5C_TPU_EA_ENGINE", name)
        for dev in ("cpu", "cuda"):
            engine = eventalign.EventalignEngine(
                model, device=torch.device(dev))
            assert engine.resolve() == "native"
            assert engine.host_round_max is None      # nothing was probed
    monkeypatch.setattr(eventalign, "measured_host_chunk_secs",
                        lambda m: 1e-4)
    monkeypatch.setattr(eventalign, "measured_dispatch_overhead",
                        lambda d: 1e-3)
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "python")
    engine = eventalign.EventalignEngine(model)
    assert engine.resolve() == "python" and engine.host_round_max == 20
    monkeypatch.setenv("F5C_TPU_VIT_HOST_MAX", "7")
    engine = eventalign.EventalignEngine(model)
    assert engine.resolve() == "python" and engine.host_round_max == 7
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "device")
    monkeypatch.delenv("F5C_TPU_VIT_HOST_MAX")
    engine = eventalign.EventalignEngine(model, device=torch.device("cuda"))
    assert engine.resolve() == "device" and engine.host_round_max == 0


def test_python_engine_is_refused_on_cuda(monkeypatch):
    """The python engine runs chunk DPs on the host, so a run on a CUDA
    device refuses it before any work: on the card every round goes to
    the Viterbi kernel's wrapper."""
    import torch

    from f5c_tpu_torch.models import builtin_model

    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "python")
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="cpu only"):
        eventalign.engine_name(cuda)
    with pytest.raises(ValueError, match="cpu only"):
        eventalign.EventalignEngine(builtin_model("dna_r9_nucleotide"),
                                    device=cuda)
    assert eventalign.engine_name(torch.device("cpu")) == "python"


def test_engines_agree_on_golden_records(golden_dir):
    """The whole-read native loop, lockstep rounds on the host
    (native.viterbi_chunk) and lockstep rounds through the Viterbi
    kernel's plain version give identical records (the pattern of
    tests/test_eventalign.py:72-94)."""
    import torch

    from f5c_tpu_torch.pipeline.runner import Options

    dev = torch.device("cpu")
    p = Pipeline(os.path.join(golden_dir, "reads.bam"),
                 os.path.join(golden_dir, "genome.fa"),
                 os.path.join(golden_dir, "reads.fasta"),
                 Options(min_mapq=0, slow5_path=os.path.join(
                     golden_dir, "signals.blow5")), dev)
    batch = next(p.batches(load=False))
    p.align_batch_waved(batch)
    ok = [r for r in batch if not r.status and r.b2e_start is not None]
    assert len(ok) == 6
    refs = [p._fetch_ref_segment(r) for r in ok]
    records = {}
    for name, host_max in (("native", None), ("python", 10**9),
                           ("device", 0)):
        eng = eventalign.EventalignEngine(p.model, device=dev)
        eng.engine = name
        eng.host_round_max = host_max
        records[name] = eng.realign_batch(ok, refs)
        if name != "native":
            rounds = eng.stats["rounds_host" if name == "python"
                               else "rounds_device"]
            assert rounds > 0 and eng.stats["chunks"] > 6
    for r in ok:
        a = records["native"][id(r)]
        assert a.ref_position.shape[0] > 100
        for other in ("python", "device"):
            b = records[other][id(r)]
            assert a.ref_position.tobytes() == b.ref_position.tobytes()
            assert a.event_idx.tobytes() == b.event_idx.tobytes()
            assert a.state.tobytes() == b.state.tobytes()


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
