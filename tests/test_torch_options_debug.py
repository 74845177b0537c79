"""call-methylation's debug prints and region filter through the port
against the JAX CLI on the golden set (the helpers of
test_torch_options.py): ``--print-events``, ``--print-banded-aln``,
``--print-scaling``, ``-w chr:start-end`` and
``-w file.bed``.  The output bytes are equal, except the HMM
log-likelihood columns, which agree within f5c's tolerance.
"""

import os

import pytest

from test_torch_options import golden_copy, same_but_hmm, both

CASES = {
    "print_events": ["--print-events"],
    "print_banded_aln": ["--print-banded-aln"],
    "print_scaling": ["--print-scaling"],
    "region": ["-w", "{chrom}:100-900"],
    "region_bed": ["-w", "{bed}"],
}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("options_debug"))
    d = golden_copy(os.path.join(tmp, "data"))
    with open(d["genome"]) as f:
        chrom = f.readline()[1:].split()[0]
    bed = os.path.join(tmp, "region.bed")
    with open(bed, "w") as f:
        f.write(f"{chrom}\t100\t900\n")
    return tmp, d, chrom, bed


@pytest.mark.parametrize("name", list(CASES))
def test_debug_option_matches_jax(golden, name):
    tmp, d, chrom, bed = golden
    opts = [o.replace("{chrom}", chrom).replace("{bed}", bed)
            for o in CASES[name]]
    (rc_j, (out_j,)), (rc_t, (out_t,)) = both(tmp, "call-methylation", d,
                                              opts, name)
    assert rc_j == rc_t == 0
    lines = same_but_hmm(out_t, out_j)
    full = 244      # lines of the whole golden run (243 and the last)
    assert (lines < full) if name.startswith("region") else lines > full
