"""RNA004 through the port against the JAX CLI: ``eventalign --m6anet``
on the synthetic RNA004 reads of ``f5c_tpu_torch.synthetic`` (the
construction of tests/test_pore_configs_cli.py::test_rna004_m6anet_cli),
with no ``--rna`` or ``--pore``: the chemistry is detected from the
BLOW5 header (``experiment_type rna``, ``sequencing_kit sqk-rna004``,
as tests/test_rna.py checks it), through ``python -m f5c_tpu_torch.cli
--device cpu`` and through ``f5c_tpu.cli`` with ``F5C_TPU_INTERPRET=1``:
the same bytes.
"""

import os

import pytest

from test_torch_pores import inputs, run_jax

from f5c_tpu_torch import cli, synthetic
from f5c_tpu_torch.pipeline.runner import detect_pore_from_slow5


@pytest.fixture(scope="module")
def rna004(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("rna004"))
    return tmp, synthetic.rna004_dataset(os.path.join(tmp, "data"))


@pytest.mark.parametrize("summary", [False, True])
def test_rna004_m6anet_matches_jax(rna004, summary):
    tmp, d = rna004
    assert detect_pore_from_slow5(d["slow5"]) == (True, "rna004")
    outs = []
    for tag, main, dev in (("jax", run_jax, []),
                           ("torch", cli.main, ["--device", "cpu"])):
        out = os.path.join(tmp, f"m6a_{tag}{int(summary)}.tsv")
        extra = ["--summary", out + ".summary"] if summary else []
        assert main(["eventalign", *inputs(d), "--m6anet", *extra, *dev,
                     "-o", out]) == 0
        outs.append(out)
    for x in ([".summary"] if summary else [""]):
        with open(outs[0] + x, "rb") as a, open(outs[1] + x, "rb") as b:
            assert a.read() == b.read()
    with open(outs[1]) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("contig\tposition\treference_kmer\t"
                               "read_index\tevent_level_mean")
    assert len(lines) > 500 and len(lines[1].split("\t")[2]) == 5
