"""The port's resquiggle (f5c_tpu_torch/pipeline/resquiggle.py, ``python
-m f5c_tpu_torch.cli resquiggle --device cpu``) against the JAX package's
``run_resquiggle``: the same bytes on the golden reads, as TSV and as PAF
(``-c``), and on a synthetic RNA read (the pattern of tests/test_rna.py),
with the host event detector and with the device detector's plain
version.
"""

import io
import os

import numpy as np
import pytest

from f5c_tpu.pipeline.resquiggle import run_resquiggle as jax_resquiggle
from f5c_tpu_torch import datasets
from f5c_tpu_torch.cli import main
from f5c_tpu_torch.io.fast5 import Signal
from f5c_tpu_torch.io.slow5 import write_blow5
from f5c_tpu_torch.models import builtin_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")


class _Args:
    fast5_dir = []
    pore = "r9"
    kmer_model = None
    threads = None
    batchsize = 512
    device = "auto"
    events_engine = "host"
    verbose = 0
    profile = None


def _jax(reads, slow5, rna=False, paf=False) -> str:
    args = _Args()
    args.reads, args.slow5, args.rna, args.paf = reads, slow5, rna, paf
    buf = io.StringIO()
    jax_resquiggle(args, out=buf)
    return buf.getvalue()


def _port(tmp_path, reads, slow5, *extra) -> str:
    out = str(tmp_path / "port.tsv")
    rc = main(["resquiggle", "--device", "cpu", reads, "--slow5", slow5,
               "-o", out, *extra])
    assert rc == 0
    with open(out) as f:
        return f.read()


@pytest.mark.parametrize("paf", [False, True])
def test_resquiggle_golden_matches_jax(tmp_path, paf):
    reads = os.path.join(GOLDEN, "reads.fasta")
    slow5 = datasets.GOLDEN_SIGNALS_ZLIB
    want = _jax(reads, slow5, paf=paf)
    extra = ["-c"] if paf else []
    got = _port(tmp_path, reads, slow5, *extra)
    assert got == want
    assert len(want.splitlines()) == (6 if paf else 1 + sum(
        len(s) - 5 for s in _fasta_seqs(reads)))
    # the device detector's plain version writes the same bytes
    assert _port(tmp_path, reads, slow5, "--events-engine", "device",
                 *extra) == want


def _fasta_seqs(path):
    seqs, cur = [], []
    with open(path) as f:
        for ln in f:
            if ln.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(ln.strip())
    seqs.append("".join(cur))
    return seqs


def test_resquiggle_rna_matches_jax(tmp_path):
    """A synthetic RNA read (tests/test_rna.py:_synth_rna): k-mers emitted
    3' to 5', the base-to-event map flipped at output."""
    rng = np.random.default_rng(11)
    model = builtin_model("rna_r9_nucleotide")
    seq = "".join(rng.choice(list("ACGT"), 400))
    levels = model.level_mean[model.kmer_ranks(seq)[::-1]]
    sig = np.repeat(levels, rng.integers(6, 14, levels.shape[0]))
    sig = (sig + rng.normal(0, 1.0, sig.shape[0])).astype(np.float32)
    dig, off, rng_ = 8192.0, 0.0, 1200.0
    raw = np.clip(sig * dig / rng_ - off, -32000, 32000).astype(np.int16)
    blow5 = str(tmp_path / "rna.blow5")
    write_blow5(blow5, [Signal(raw=raw, digitisation=dig, offset=off,
                               range=rng_, sample_rate=3000.0,
                               read_id="rna-read-1")],
                attrs={"experiment_type": "rna"})
    reads = tmp_path / "reads.fastq"
    reads.write_text(f"@rna-read-1\n{seq.replace('T', 'U')}\n+\n"
                     f"{'I' * len(seq)}\n")
    want = _jax(str(reads), blow5, rna=True)
    rows = want.splitlines()[1:]
    assert len(rows) == len(seq) - model.k + 1
    assert sum(r.split("\t")[2] != "." for r in rows) > 0.9 * len(rows)
    assert _port(tmp_path, str(reads), blow5, "--rna") == want
    assert _port(tmp_path, str(reads), blow5, "--rna", "--events-engine",
                 "device") == want
    assert _port(tmp_path, str(reads), blow5, "--rna", "-c") == _jax(
        str(reads), blow5, rna=True, paf=True)
