"""eventalign's output options through the port against the JAX CLI on
the golden set: ``python -m f5c_tpu_torch.cli eventalign --device cpu``
and ``f5c_tpu.cli eventalign`` (in this process, its Pallas kernels in
interpret mode, so that its compiled kernels are shared between the
cases) with ``--sam`` (``--sam-out-version`` 1 and 2), ``--paf``,
``--m6anet``, ``--samples``, ``--signal-index``, ``--scale-events``,
``--collapse-events`` and ``--print-read-names``, each with
``--summary``: the same bytes.  The helpers
here are shared by the other option tests (test_torch_options_*.py).
"""

import os

import pytest

from test_torch_pores import run_jax

from f5c_tpu_torch import cli, datasets

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")
HMM_COLS_V2 = (5, 6, 7)     # meth-out-version 2's log-likelihood columns

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "meth.exp")),
    reason="golden fixtures not generated")


def golden_copy(dst: str) -> dict:
    """The golden set (zlib signals) copied into ``dst`` and indexed."""
    return datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), dst)


def both(tmp, cmd, d, opts, tag, files=(), capfd=None):
    """``cmd`` with ``opts`` on dataset ``d`` through the JAX CLI and the
    port's (``--device cpu``).  A ``{out}`` in an option is that side's
    output path, a ``{side}`` its name; ``files`` are more paths (with
    ``{out}`` / ``{side}``) to read back.  Returns, for each side, its
    exit code (or SystemExit code) and the bytes of its output and of
    ``files``; with ``capfd``, the port's stderr as a third item."""
    if capfd is not None:
        capfd.readouterr()
    res = []
    for side, main, extra in (("jax", run_jax, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        out = os.path.join(tmp, f"{tag}_{side}.out")

        def fill(s):
            return s.format(out=out, side=side)

        argv = [cmd, "--min-mapq", "0", "-b", d["bam"], "-g", d["genome"],
                "-r", d["reads"], "--slow5", d["slow5"],
                *(fill(o) for o in opts), *extra, "-o", out]
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
        got = []
        for p in (out, *(fill(f) for f in files)):
            with open(p, "rb") as f:
                got.append(f.read())
        res.append((rc, got))
        if capfd is not None:
            err = capfd.readouterr().err
    if capfd is not None:
        res.append(err)
    return res


def same_but_hmm(ours: bytes, theirs: bytes, hmm_cols=HMM_COLS_V2) -> int:
    """Every line equal, except call-methylation rows, whose HMM columns
    agree within f5c's tolerance |x - t| <= 0.1|t| + 0.02 (the rest equal);
    returns the number of lines."""
    a, b = ours.decode().split("\n"), theirs.decode().split("\n")
    assert len(a) == len(b)
    width = 8 + len(hmm_cols)
    for x, y in zip(a, b):
        if x == y:
            continue
        xs, ys = x.split("\t"), y.split("\t")
        assert len(xs) == len(ys) == width, (x[:80], y[:80])
        for i, (u, v) in enumerate(zip(xs, ys)):
            if i in hmm_cols:
                assert abs(float(u) - float(v)) <= 0.1 * abs(float(v)) + 0.02
            else:
                assert u == v, (i, x, y)
    return len(a)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("options_ea"))
    return tmp, golden_copy(os.path.join(tmp, "data"))


EA_OPTIONS = {
    "sam1": ["--sam", "--sam-out-version", "1"],
    "sam2": ["--sam", "--sam-out-version", "2"],
    "paf": ["--paf"],
    "m6anet": ["--m6anet"],
    "samples": ["--samples"],
    "signal_index": ["--signal-index"],
    "scale_events": ["--scale-events"],
    "collapse_events": ["--collapse-events"],
    "print_read_names": ["--print-read-names"],
}


@pytest.mark.parametrize("name", list(EA_OPTIONS))
def test_eventalign_option_matches_jax(golden, name):
    tmp, d = golden
    (rc_j, (out_j, sum_j)), (rc_t, (out_t, sum_t)) = both(
        tmp, "eventalign", d, [*EA_OPTIONS[name], "--summary",
                               "{out}.summary"], name, ["{out}.summary"])
    assert rc_j == rc_t == 0
    assert out_t == out_j and out_t.count(b"\n") >= 6
    assert sum_t == sum_j
