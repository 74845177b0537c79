"""call-methylation's batch options through the port against the JAX
CLI on the golden set (the helpers of test_torch_options.py):
``-K 2 --debug-break 1`` (the first batch of two reads only) and
``--skip-ultra FILE`` with a low ``--ultra-thresh``: the same records
written to FILE, byte for byte, and the same output of the reads kept.
Output bytes are equal, except the HMM log-likelihood columns, which
agree within f5c's tolerance.
"""

import os

import pytest

from test_torch_options import golden_copy, same_but_hmm, both

from f5c_tpu_torch.io.bam import BamReader


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("options_batch"))
    return tmp, golden_copy(os.path.join(tmp, "data"))


def test_debug_break_matches_jax(golden, capfd):
    tmp, d = golden
    (rc_j, (out_j,)), (rc_t, (out_t,)), err = both(
        tmp, "call-methylation", d, ["-K", "2", "--debug-break", "1"], "k2",
        capfd=capfd)
    assert rc_j == rc_t == 0
    same_but_hmm(out_t, out_j)
    reads = {ln.split("\t")[4] for ln in out_t.decode().splitlines()[1:]}
    assert len(reads) == 2 and "processed: 2; " in err


def test_skip_ultra_matches_jax(golden):
    tmp, d = golden
    (rc_j, (out_j, bam_j)), (rc_t, (out_t, bam_t)) = both(
        tmp, "call-methylation", d,
        ["--skip-ultra", "{out}.ultra.bam", "--ultra-thresh", "1100"], "ul",
        ["{out}.ultra.bam"])
    assert rc_j == rc_t == 0
    assert bam_t == bam_j
    same_but_hmm(out_t, out_j)
    skipped = {r.qname for r in BamReader(os.path.join(tmp,
                                                       "ul_torch.out.ultra.bam"))}
    kept = {ln.split("\t")[4] for ln in out_t.decode().splitlines()[1:]}
    assert skipped and kept and not skipped & kept
