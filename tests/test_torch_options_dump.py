"""call-methylation's raw-signal options through the port against the
JAX CLI on the golden set (the helpers of test_torch_options.py):
``--write-dump`` writes the JAX package's dump byte for byte, and
``--read-dump`` of it the JAX package's output; ``--print-raw``; and
``--skip-unreadable yes`` / ``no`` on a copy whose BLOW5 lacks one
read's record: the same output and counts (yes), the same exit code and
message (no).  Output bytes are equal, except the HMM log-likelihood
columns, which agree within f5c's tolerance.
"""

import os

import pytest

from test_torch_options import golden_copy, same_but_hmm, both

from f5c_tpu_torch.io.slow5 import Slow5File, write_blow5


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("options_dump"))
    return tmp, golden_copy(os.path.join(tmp, "data"))


def test_write_then_read_dump_matches_jax(golden):
    tmp, d = golden
    (rc_j, (out_j, dump_j)), (rc_t, (out_t, dump_t)) = both(
        tmp, "call-methylation", d, ["--write-dump", "{out}.dump"], "wd",
        ["{out}.dump"])
    assert rc_j == rc_t == 0 and len(dump_t) > 100_000
    assert dump_t == dump_j
    same_but_hmm(out_t, out_j)
    # both read the JAX package's dump
    dump = os.path.join(tmp, "wd_jax.out.dump")
    (rc_j, (rd_j,)), (rc_t, (rd_t,)) = both(
        tmp, "call-methylation", d, ["--read-dump", dump], "rd")
    assert rc_j == rc_t == 0
    assert same_but_hmm(rd_t, rd_j) == same_but_hmm(out_t, out_j)


def test_print_raw_matches_jax(golden, capfd):
    tmp, d = golden
    capfd.readouterr()
    (rc_j, (out_j,)), (rc_t, (out_t,)) = both(
        tmp, "call-methylation", d, ["--print-raw"], "raw")
    raw = capfd.readouterr().out
    assert rc_j == rc_t == 0
    same_but_hmm(out_t, out_j)
    # the raw dumps go to stdout, the JAX run's first, then the port's
    half = len(raw) // 2
    assert raw.count("\tLN:") == 12 and raw[:half] == raw[half:]


@pytest.fixture(scope="module")
def missing_record(golden):
    """The golden set with one read's record left out of its BLOW5."""
    tmp, d = golden
    d = golden_copy(os.path.join(tmp, "missing"))
    f = Slow5File(d["slow5"])
    keep = [f.get(r) for r in f.read_ids() if r != f.read_ids()[2]]
    f.close()
    write_blow5(d["slow5"], keep)
    os.remove(d["slow5"] + ".idx")
    return tmp, d


@pytest.mark.parametrize("skip", ["yes", "no"])
def test_skip_unreadable_matches_jax(missing_record, capfd, skip):
    """The JAX CLI leaves its output unflushed when it exits on the
    unreadable record, so with ``no`` the exit codes are compared and the
    port's output holds the header and no row."""
    tmp, d = missing_record
    (rc_j, (out_j,)), (rc_t, (out_t,)), err = both(
        tmp, "call-methylation", d, ["--skip-unreadable", skip], f"sk{skip}",
        capfd=capfd)
    if skip == "yes":
        assert rc_j == rc_t == 0
        assert same_but_hmm(out_t, out_j) > 100
        assert "processed: 5; " in err and "bad signal: 1;" in err
    else:
        assert rc_j == rc_t == ("exit", 1)
        assert out_t.count(b"\n") == 1 and out_t.startswith(b"chromosome")
        assert err.count("is unavailable/unreadable") == 1
