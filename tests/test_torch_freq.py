"""The port's meth-freq and freq-merge (f5c_tpu_torch/pipeline/freq.py)
against the JAX package's (f5c_tpu/pipeline/freq.py, its python
engine), byte for byte: each engine of the port (python, for in-memory
streams, and native, the C++ accumulator and k-way merge of the port's
host library, for files) on the inputs of tests/test_pipeline.py and on
the golden set's meth.exp, with and without split groups; the native
engine's reject path (CPython number spellings, CRLF, blank lines, no
final newline) and its located errors; the native merge's ties,
pass-through rows and header check; the stream choosing the engine.
"""

import io
import os

import pytest

from f5c_tpu.pipeline import freq as jax_freq
from f5c_tpu_torch.pipeline import freq

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")

METH_TSV = (
    "chromosome\tstart\tend\tread_name\tlog_lik_ratio\tlog_lik_methylated\t"
    "log_lik_unmethylated\tnum_calling_strands\tnum_cpgs\tsequence\n"
    "chr1\t100\t100\tr1\t3.10\t-10.0\t-13.1\t1\t1\tAAAAACGAAAA\n"
    "chr1\t100\t100\tr2\t-4.00\t-14.0\t-10.0\t1\t1\tAAAAACGAAAA\n"
    "chr1\t100\t100\tr3\t1.00\t-10.0\t-11.0\t1\t1\tAAAAACGAAAA\n"
    "chr1\t200\t206\tr1\t6.00\t-20.0\t-26.0\t1\t2\tAAAAACGTTTCGAAAAA\n"
    "chr2\t50\t50\tr1\t-9.00\t-30.0\t-21.0\t1\t1\tAAAAACGAAAA\n")
HDR = METH_TSV.splitlines()[0] + "\n"
# the same calls in meth-out-version 2 (a strand column after the chromosome)
METH_TSV_V2 = "".join(
    "\t".join([c[0], "+", *c[1:]]) + "\n" if i else
    "chromosome\tstrand\tstart\tend\tread_name\tlog_lik_ratio\t"
    "log_lik_methylated\tlog_lik_unmethylated\tnum_calling_strands\t"
    "num_motifs\tsequence\n"
    for i, c in enumerate(ln.split("\t") for ln in METH_TSV.splitlines()))
WEIRD = (HDR
         + "chr1\t10\t10\tr1\t2_5.0\t-1\t-2\t1\t1\tAACGA\n"
         + "chr1\t20\t20\tr2\tinf\t-1\t-2\t1\t1\tAACGA\r\n"
         + "   \n\n"
         + "chr1\t3_0\t30\tr3\t5.0\t-1\t-2\t1\t1\tAACGA\n"
         + "chr1\t40\t40\tr4\tnan\t-1\t-2\t1\t1\tAACGA\n"
         + "chr1\t50\t50\tr5\t-9.0\t-1\t-2\t1\t1\tTTCGA")
FREQ_HDR = ("chromosome\tstart\tend\tnum_cpgs_in_group\tcalled_sites\t"
            "called_sites_methylated\tmethylated_frequency\tgroup_sequence\n")


def _golden_calls():
    with open(os.path.join(GOLDEN, "meth.exp")) as f:
        return f.read()


INPUTS = {"calls": lambda: METH_TSV, "calls_v2": lambda: METH_TSV_V2,
          "weird": lambda: WEIRD, "golden": _golden_calls}


def _run_meth_freq(fn, path, engine, **kw):
    """(output, error) of one meth_freq over the file at ``path``, read
    with universal newlines: from the file (the native engine) or from a
    StringIO of its text (the python engine)."""
    buf = io.StringIO()
    try:
        with open(path, newline=None) as fh:
            fn(fh if engine == "native" else io.StringIO(fh.read()),
               out=buf, **kw)
    except ValueError as e:
        return buf.getvalue(), str(e)
    return buf.getvalue(), None


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_meth_freq_matches_jax(tmp_path, name, engine, split):
    path = tmp_path / "calls.tsv"
    with open(path, "w", newline="") as f:
        f.write(INPUTS[name]())
    want = _run_meth_freq(jax_freq.meth_freq, path, "python",
                          split_groups=split)
    got = _run_meth_freq(freq.meth_freq, path, engine, split_groups=split)
    assert want[1] is None and want[0].count("\n") > 1
    assert got == want


def test_meth_freq_counts():
    """The counts of tests/test_pipeline.py::test_meth_freq and its
    split-groups case, on the port (StringIO input: the python engine)."""
    out = io.StringIO()
    freq.meth_freq(io.StringIO(METH_TSV), out=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("chromosome\tstart\tend\tnum_cpgs_in_group")
    rows = {tuple(ln.split("\t")[:3]): ln.split("\t") for ln in lines[1:]}
    assert rows[("chr1", "100", "100")][4:7] == ["2", "1", "0.500"]
    assert rows[("chr1", "200", "206")][3:7] == ["2", "2", "2", "1.000"]
    assert rows[("chr2", "50", "50")][5:7] == ["0", "0.000"]
    out = io.StringIO()
    freq.meth_freq(io.StringIO(METH_TSV), split_groups=True, out=out)
    keys = {tuple(ln.split("\t")[:3]) for ln in out.getvalue().splitlines()}
    assert {("chr1", "200", "200"), ("chr1", "205", "205")} <= keys


@pytest.mark.parametrize("engine", ["python", "native"])
def test_meth_freq_located_error(tmp_path, engine):
    """A malformed row raises the JAX package's located error from either
    engine; an unknown header too."""
    bad = tmp_path / "bad.tsv"
    bad.write_text(HDR + "chr1\t10\t10\tr1\t5.0\t-1\t-2\t1\t1\tAACGA\n"
                   + "chr1\tfoo\t10\tr1\tbad\n")
    want = _run_meth_freq(jax_freq.meth_freq, bad, "python")
    got = _run_meth_freq(freq.meth_freq, bad, engine)
    assert want[1] and "line 3" in want[1]
    assert got[1] == want[1]
    hdr = tmp_path / "hdr.tsv"
    hdr.write_text("not\ta\theader\n")
    got = _run_meth_freq(freq.meth_freq, hdr, engine)
    assert got[1].startswith("unrecognised header")


def test_native_engine_needs_a_file(tmp_path, monkeypatch):
    """The stream picks the engine: a file-backed input (meth-freq) or
    output (freq-merge) goes to the native engine, an in-memory one to
    the python loop."""
    taken = []
    monkeypatch.setattr(freq, "_meth_freq_native",
                        lambda *a: taken.append("meth_freq"))
    monkeypatch.setattr(freq, "_freq_merge_native",
                        lambda *a: taken.append("freq_merge"))
    path = tmp_path / "calls.tsv"
    path.write_text(METH_TSV)
    freq.meth_freq(io.StringIO(METH_TSV), out=io.StringIO())
    freq.freq_merge(_merge_inputs(tmp_path), out=io.StringIO())
    assert taken == []
    with open(path) as fh:
        freq.meth_freq(fh, out=io.StringIO())
    with open(tmp_path / "m.tsv", "w") as out:
        freq.freq_merge(_merge_inputs(tmp_path), out=out)
    assert taken == ["meth_freq", "freq_merge"]


def _merge_inputs(tmp_path):
    a = tmp_path / "a.tsv"
    b = tmp_path / "b.tsv"
    c = tmp_path / "c.tsv"
    a.write_text(FREQ_HDR + "chr1\t10\t10\t1\t4\t1\t0.250\tAACGTT\n"
                 "chr1\t20\t20\t1\t2\t2\t1.000\tAACGTT\textra\tcols\n"
                 "chr2\t7\t9\t2\t3\t0\t0.000\tTTCGAA\n")
    b.write_text(FREQ_HDR + "chr1\t10\t10\t1\t6\t4\t0.667\tZZDIFFERENT\n"
                 "chr1\t20\t20\t1\t1\t0\t0.000\tAACGTT\n"
                 "chr2\t5\t5\t1\t1\t0\t0.000\tAACGTT\n\n")
    c.write_text(FREQ_HDR + "chr0\t1\t1\t1\t16\t16\t1.000\tCGCGCG\n")
    return [str(a), str(b), str(c)]


def _run_merge(fn, paths, out_path, engine):
    """(output, error) of one freq_merge into the file at ``out_path``
    (the native engine) or into a StringIO (the python engine)."""
    try:
        if engine == "python":
            out = io.StringIO()
            fn(paths, out=out)
            return out.getvalue(), None
        with open(out_path, "w") as out:
            fn(paths, out=out)
    except ValueError as e:
        return None, str(e)
    with open(out_path) as f:
        return f.read(), None


@pytest.mark.parametrize("engine", ["python", "native"])
def test_freq_merge_matches_jax(tmp_path, engine):
    """Merged keys sum, ties keep the first file's row bytes, pass-through
    rows keep their extra columns; differing headers and a malformed row
    raise the JAX package's errors."""
    paths = _merge_inputs(tmp_path)
    want = _run_merge(jax_freq.freq_merge, paths, tmp_path / "w.tsv",
                      "python")
    got = _run_merge(freq.freq_merge, paths, tmp_path / "g.tsv", engine)
    assert got == want
    assert "chr1\t10\t10\t1\t10\t5\t0.500\tAACGTT" in got[0]
    assert "ZZDIFFERENT" not in got[0] and "AACGTT\textra\tcols" in got[0]
    d = tmp_path / "d.tsv"
    d.write_text("other\theader\nchr1\t1\t1\t1\t1\t1\t1.000\tA\n")
    e = tmp_path / "e.tsv"
    e.write_text(FREQ_HDR + "chr1\t1\t1\t1\t1\t1\t1.000\tA\n"
                 + "chr1\tnotanint\t2\t1\t1\t1\t1.000\tA\n")
    for bad in ([paths[0], str(d)], [str(e)]):
        want = _run_merge(jax_freq.freq_merge, bad, tmp_path / "w.tsv",
                          "python")
        got = _run_merge(freq.freq_merge, bad, tmp_path / "g.tsv", engine)
        assert want[1] and got[1] == want[1]


def test_freq_merge_stringio_is_python(tmp_path):
    """A StringIO output (no file descriptor) takes the python merge."""
    paths = _merge_inputs(tmp_path)
    out = io.StringIO()
    freq.freq_merge(paths, out=out)
    want = io.StringIO()
    jax_freq.freq_merge(paths, out=want)
    assert out.getvalue() == want.getvalue()
