"""R10 with 9-mer models through the port against the JAX CLI: the
synthetic full-size 9-mer model files (4^9 nucleotide and 5^9 CpG
levels) and R10 reads of ``f5c_tpu_torch.synthetic`` (the construction
of tests/test_pore_configs_cli.py and tests/test_r10_kmer9.py; the R10
chemistry detected from the BLOW5 header), through ``python -m
f5c_tpu_torch.cli --device cpu`` and through ``f5c_tpu.cli`` with
``F5C_TPU_INTERPRET=1`` (its call-methylation crashes off the TPU
without it).  ``call-methylation --pore r10 --kmer-model --meth-model``:
every column equal but the HMM log-likelihoods, which agree within f5c's
tolerance |x - t| <= 0.1|t| + 0.02; ``eventalign --pore r10 --summary``
with the native and the device re-alignment engine: the same bytes.
"""

import os

import pytest

# The JAX runner binds sys.stderr as a default argument when it is first
# imported (Pipeline.report); import it here, while the tests are
# collected, so that it binds pytest's session-long stream and not the
# stream of one test's capture, which is closed after that test.
import f5c_tpu.pipeline.runner  # noqa: F401
from f5c_tpu import cli as jax_cli
from f5c_tpu_torch import cli, synthetic

# meth-out-version 2: log_lik_ratio, log_lik_methylated, log_lik_unmethylated
HMM_COLS_V2 = (5, 6, 7)


def run_jax(argv):
    """The JAX CLI in this process, its Pallas kernels in interpret mode."""
    saved = os.environ.get("F5C_TPU_INTERPRET")
    os.environ["F5C_TPU_INTERPRET"] = "1"
    try:
        return jax_cli.main(argv)
    finally:
        if saved is None:
            os.environ.pop("F5C_TPU_INTERPRET", None)
        else:
            os.environ["F5C_TPU_INTERPRET"] = saved


def inputs(d):
    return ["--min-mapq", "0", "-b", d["bam"], "-g", d["genome"], "-r",
            d["reads"], "--slow5", d["slow5"], "--min-recalib-events", "100"]


def hmm_close(ours: str, theirs: str, hmm_cols) -> int:
    """Rows compared: every column equal, the HMM columns within f5c's
    tolerance of the JAX package's; returns the number of rows."""
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b) and a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        xs, ys = x.split("\t"), y.split("\t")
        assert len(xs) == len(ys)
        for i, (u, v) in enumerate(zip(xs, ys)):
            if i in hmm_cols:
                assert abs(float(u) - float(v)) <= 0.1 * abs(float(v)) + 0.02
            else:
                assert u == v, (i, x, y)
    return len(a) - 1


@pytest.fixture(scope="module")
def r10(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("r10"))
    nuc, cpg = synthetic.r10_models(os.path.join(tmp, "models"))
    data = synthetic.r10_dataset(os.path.join(tmp, "data"), nuc)
    return tmp, nuc, cpg, data


def test_r10_call_methylation_matches_jax(r10):
    tmp, nuc, cpg, d = r10
    argv = ["call-methylation", *inputs(d), "--pore", "r10", "--kmer-model",
            nuc, "--meth-model", cpg]
    outs = []
    for tag, main, extra in (("jax", run_jax, []),
                             ("torch", cli.main, ["--device", "cpu"])):
        outs.append(os.path.join(tmp, f"meth_{tag}.tsv"))
        assert main([*argv, *extra, "-o", outs[-1]]) == 0
    with open(outs[0]) as a, open(outs[1]) as b:
        theirs, ours = a.read(), b.read()
    assert hmm_close(ours, theirs, HMM_COLS_V2) > 50
    with open(d["genome"]) as f:
        seq = f.read().split("\n")[1]
    for row in ours.splitlines()[1:]:
        start = int(row.split("\t")[2])
        assert seq[start:start + 2] == "CG"


@pytest.fixture(scope="module")
def r10_eventalign_jax(r10):
    tmp, nuc, _, d = r10
    out = os.path.join(tmp, "ea_jax.tsv")
    assert run_jax(["eventalign", *inputs(d), "--pore", "r10", "--kmer-model",
                    nuc, "--summary", out + ".summary", "-o", out]) == 0
    return out


@pytest.mark.parametrize("engine", ["native", "device"])
def test_r10_eventalign_matches_jax(r10, r10_eventalign_jax, monkeypatch,
                                    engine):
    tmp, nuc, _, d = r10
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", engine)
    out = os.path.join(tmp, f"ea_{engine}.tsv")
    assert cli.main(["eventalign", *inputs(d), "--pore", "r10",
                     "--kmer-model", nuc, "--summary", out + ".summary",
                     "--device", "cpu", "-o", out]) == 0
    for x in ("", ".summary"):
        with open(out + x, "rb") as a, open(r10_eventalign_jax + x,
                                            "rb") as b:
            ours, theirs = a.read(), b.read()
        assert ours == theirs
    with open(out) as f:
        lines = f.read().splitlines()
    cols = lines[1].split("\t")
    assert len(lines) > 1000 and len(cols[2]) == len(cols[9]) == 9
