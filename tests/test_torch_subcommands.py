"""The port's host subcommands and run options against the JAX CLI:
``index`` (over a BLOW5 and over FAST5 directories) and
``fast5-to-blow5`` (FAST5 files written with h5py, one unreadable) write
the JAX command's files byte for byte; the golden chain ``index`` ->
``call-methylation --device cpu`` -> ``meth-freq`` (with and without
``-s``) -> ``freq-merge`` writes the JAX ``meth-freq`` / ``freq-merge``
bytes of the same call-methylation TSV (that TSV is held to meth.exp by
tests/test_torch_golden.py), and ``freq-merge`` of two ``--shard`` runs
equals ``meth-freq`` of the whole run; ``--profile-dir`` writes a
torch.profiler trace; ``--dist`` is still refused.
"""

import filecmp
import glob
import os
import shutil

import numpy as np
import pytest

from f5c_tpu import cli as jax_cli
from f5c_tpu_torch import cli

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")
INDEX_FILES = (".index", ".index.gzi", ".index.fai", ".index.readdb")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "meth.exp")),
    reason="golden fixtures not generated")


def _copy_golden(dst):
    from f5c_tpu_torch import datasets

    os.makedirs(dst, exist_ok=True)
    src = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
    for key in ("bam", "genome", "reads", "slow5"):
        shutil.copy(src[key], dst)
    return {key: os.path.join(dst, os.path.basename(src[key]))
            for key in src}


def _same_files(a, b):
    for x, y in zip(a, b):
        assert filecmp.cmp(x, y, shallow=False), (x, y)


def _make_fast5(dirpath, rng):
    """A multi-read FAST5 (the layout of tests/test_fast5_multi.py), a
    single-read one, and an unreadable one."""
    h5py = pytest.importorskip("h5py")
    os.makedirs(os.path.join(dirpath, "sub"), exist_ok=True)
    with h5py.File(os.path.join(dirpath, "multi.fast5"), "w") as f:
        for i in range(3):
            raw = rng.integers(-100, 2000, int(rng.integers(500, 3000))
                               ).astype(np.int16)
            grp = f.create_group(f"read_0000-{i:04d}")
            grp.create_dataset("Raw/Signal", data=raw)
            ch = grp.create_group("channel_id")
            ch.attrs["digitisation"] = 8192.0
            ch.attrs["offset"] = float(i)
            ch.attrs["range"] = 1467.6
            ch.attrs["sampling_rate"] = 4000.0
    with h5py.File(os.path.join(dirpath, "sub", "single.fast5"), "w") as f:
        rgrp = f.create_group("Raw/Reads/Read_7")
        rgrp.attrs["read_id"] = b"1111-0007"
        rgrp.create_dataset("Signal", data=rng.integers(
            0, 1500, 1234).astype(np.int16))
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 2048.0
        ch.attrs["offset"] = 3.0
        ch.attrs["range"] = 1400.0
        ch.attrs["sampling_rate"] = 4000.0
    with open(os.path.join(dirpath, "broken.fast5"), "wb") as f:
        f.write(b"not an HDF5 file")
    return ["0000-0000", "0000-0001", "0000-0002", "1111-0007"]


def test_fast5_to_blow5_matches_jax(tmp_path, capsys):
    rids = _make_fast5(str(tmp_path / "f5"), np.random.default_rng(31))
    outs = []
    for tag, main in (("jax", jax_cli.main), ("torch", cli.main)):
        out = str(tmp_path / f"{tag}.blow5")
        assert main(["fast5-to-blow5", "-d", str(tmp_path / "f5"), "-o",
                     out]) == 0
        err = capsys.readouterr().err
        assert "skipping broken.fast5" in err and "wrote 4 reads" in err
        outs.append((out, out + ".idx"))
    _same_files(*outs)
    from f5c_tpu_torch.io.fast5 import Fast5File
    from f5c_tpu_torch.io.slow5 import Slow5File

    f = Slow5File(outs[1][0])
    assert sorted(f.read_ids()) == rids
    with Fast5File(str(tmp_path / "f5" / "multi.fast5")) as f5:
        want = f5.get_signal("0000-0001")
    got = f.get("0000-0001")
    assert np.array_equal(got.raw, want.raw) and got.offset == 1.0
    f.close()


@pytest.mark.parametrize("source", ["slow5", "fast5"])
def test_index_matches_jax(tmp_path, source):
    """``index reads.fasta --slow5 signals.blow5`` (the .index files and
    the BLOW5's .idx) and ``index -d DIR`` (the .readdb maps each read to
    its FAST5 file) write the JAX command's bytes."""
    made = []
    for tag, main in (("jax", jax_cli.main), ("torch", cli.main)):
        d = _copy_golden(str(tmp_path / tag))
        if source == "slow5":
            argv = ["index", d["reads"], "--slow5", d["slow5"]]
            files = [d["reads"] + x for x in INDEX_FILES] + [
                d["slow5"] + ".idx"]
        else:
            rids = _make_fast5(str(tmp_path / "f5"),
                               np.random.default_rng(31))
            with open(d["reads"], "w") as f:
                f.writelines(f">{r}\nACGTACGTAC\n" for r in rids)
            argv = ["index", d["reads"], "-d", str(tmp_path / "f5"),
                    "--iop", "2"]
            files = [d["reads"] + x for x in INDEX_FILES]
        assert main(argv) == 0
        made.append(files)
    _same_files(*made)
    if source == "fast5":
        with open(made[1][3]) as f:
            paths = dict(ln.rstrip("\n").split("\t") for ln in f)
        assert sorted(paths) == rids
        assert paths["1111-0007"].endswith(os.path.join("sub",
                                                        "single.fast5"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """index -> call-methylation --device cpu (the whole run and shards 0/2
    and 1/2) on a copy of the golden set through the port's CLI."""
    tmp = str(tmp_path_factory.mktemp("chain"))
    d = _copy_golden(tmp)
    assert cli.main(["index", d["reads"], "--slow5", d["slow5"]]) == 0
    meth = {}
    for tag, extra in (("all", []), ("s0", ["--shard", "0/2"]),
                       ("s1", ["--shard", "1/2"])):
        meth[tag] = os.path.join(tmp, f"meth_{tag}.tsv")
        assert cli.main(["call-methylation", "--device", "cpu",
                         "--min-mapq", "0", "-b", d["bam"], "-g",
                         d["genome"], "-r", d["reads"], "--slow5",
                         d["slow5"], "-o", meth[tag], *extra]) == 0
    return tmp, meth, d


@pytest.mark.parametrize("split", [False, True])
def test_chain_meth_freq_matches_jax(chain, split):
    tmp, meth, _ = chain
    s = ["-s"] if split else []
    outs = []
    for tag, main in (("jax", jax_cli.main), ("torch", cli.main)):
        out = os.path.join(tmp, f"freq_{tag}{len(s)}.tsv")
        assert main(["meth-freq", "-i", meth["all"], *s, "-o", out]) == 0
        outs.append(out)
    _same_files(outs[:1], outs[1:])
    with open(outs[1]) as f:
        assert f.read().count("\n") > 10


def test_chain_freq_merge_of_shards(chain):
    """freq-merge of the two shards' meth-freq writes the JAX
    freq-merge's bytes, and those equal meth-freq of the whole run."""
    tmp, meth, _ = chain
    with open(meth["s0"]) as a, open(meth["s1"]) as b:
        n0, n1 = a.read().count("\n"), b.read().count("\n")
    assert n0 > 1 and n1 > 1
    parts = []
    for tag in ("s0", "s1"):
        parts.append(os.path.join(tmp, f"freq_{tag}.tsv"))
        assert cli.main(["meth-freq", "-i", meth[tag], "-o", parts[-1]]) == 0
    whole = os.path.join(tmp, "freq_whole.tsv")
    assert cli.main(["meth-freq", "-i", meth["all"], "-o", whole]) == 0
    outs = []
    for tag, main in (("jax", jax_cli.main), ("torch", cli.main)):
        outs.append(os.path.join(tmp, f"merge_{tag}.tsv"))
        assert main(["freq-merge", *parts, "-o", outs[-1]]) == 0
    _same_files(outs[:1], outs[1:])
    _same_files([outs[1]], [whole])


def test_profile_dir_writes_a_trace(chain):
    """``--profile-dir`` with ``--device cpu`` writes one torch.profiler
    trace of the host's operators (here of the first read only: -K 1
    --debug-break 1, since the plain versions' operators make a trace of
    tens of MB a read) and leaves the output as it is."""
    tmp, meth, d = chain
    prof = os.path.join(tmp, "prof")
    out = os.path.join(tmp, "meth_prof.tsv")
    assert cli.main(["call-methylation", "--device", "cpu", "--min-mapq",
                     "0", "-b", d["bam"], "-g", d["genome"], "-r",
                     d["reads"], "--slow5", d["slow5"], "-o", out,
                     "-K", "1", "--debug-break", "1",
                     "--profile-dir", prof]) == 0
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert '"traceEvents"' in f.read(1 << 16)
    os.remove(traces[0])
    with open(out) as f:
        got = f.read()
    with open(meth["all"]) as f:
        whole = f.read()
    assert got.count("\n") > 2 and whole.startswith(got)


def test_dist_is_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["call-methylation", "--device", "cpu", "-b", "x.bam",
                  "-g", "g.fa", "-r", "r.fa", "--dist", "-o",
                  str(tmp_path / "o.tsv")])
    assert e.value.code == 2
