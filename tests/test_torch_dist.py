"""The port's multi-process layer (f5c_tpu_torch/parallel/distributed.py)
against the JAX package's (f5c_tpu/parallel/distributed.py): the part
merge on the parts of tests/test_distributed.py and on random part sets,
the --dist refusals with the JAX messages, and two real gloo processes of
``python -m f5c_tpu_torch.cli ... --dist --device cpu`` on the golden set,
whose merged files must be the single-process run's bytes.  A rank that
fails leaves no merged file and both ranks exit nonzero.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from f5c_tpu.parallel import distributed as jax_dist
from f5c_tpu_torch import datasets
from f5c_tpu_torch.cli import main
from f5c_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
TIMEOUT_S = 60       # the ranks' barrier timeout in these tests


def _merge_both(tmp_path, parts_text):
    """Merge the same parts with the port and the JAX package; returns
    ((count, text) of the port, (count, text) of JAX)."""
    paths = []
    for i, text in enumerate(parts_text):
        p = tmp_path / f"out.part{i}"
        p.write_text(text)
        paths.append(str(p))
    got = []
    for mod, name in ((distributed, "port.tsv"), (jax_dist, "jax.tsv")):
        n = mod.merge_marked_parts(paths, str(tmp_path / name))
        got.append((n, (tmp_path / name).read_text()))
    return got


def test_merge_matches_jax_on_two_parts(tmp_path):
    """The parts of tests/test_distributed.py:24-58."""
    port, jax = _merge_both(tmp_path, [
        "colA\tcolB\n#f5c-dist\t0\nr0 line1\nr0 line2\n#f5c-dist\t2\n"
        "r2 line1\n",
        "colA\tcolB\n#f5c-dist\t1\nr1 line1\n#f5c-dist\t3\nr3 line1\n"
        "r3 line2\n"])
    assert port == jax
    assert port == (4, "colA\tcolB\nr0 line1\nr0 line2\nr1 line1\n"
                       "r2 line1\nr3 line1\nr3 line2\n")
    port, jax = _merge_both(tmp_path, ["hdr\n#f5c-dist\t0\nrow\n", "hdr\n"])
    assert port == jax == (1, "hdr\nrow\n")
    assert distributed.part_path("o.tsv", 3) == jax_dist.part_path("o.tsv",
                                                                   3)
    assert distributed.MARKER == jax_dist.MARKER


@pytest.mark.parametrize("seed", range(20))
def test_merge_matches_jax_on_random_parts(tmp_path, seed):
    """Reads dealt over 1-4 ranks by read index, 0-3 rows each (a read
    with no rows writes no marker); every fifth set has a rank with no
    reads at all."""
    rng = np.random.default_rng(seed)
    n_parts = int(rng.integers(1, 5))
    n_reads = int(rng.integers(0, 30))
    header = "".join(f"h{j}\n" for j in range(int(rng.integers(0, 3))))
    parts = [header] * n_parts
    whole = header
    for idx in range(n_reads):
        shard = idx % n_parts
        if seed % 5 == 0 and shard == n_parts - 1 and n_parts > 1:
            continue
        rows = "".join(f"r{idx}\t{int(v)}\n"
                       for v in rng.integers(0, 1000,
                                             int(rng.integers(0, 4))))
        if rows:
            parts[shard] += f"{distributed.MARKER}{idx}\n{rows}"
            whole += rows
    port, jax = _merge_both(tmp_path, parts)
    assert port == jax
    assert port[1] == whole


@pytest.mark.parametrize("extra,message", [
    ([], "--dist requires -o FILE"),
    (["-o", "x.tsv", "--print-events"],
     "--dist is incompatible with --print-* debug dumps"),
    (["-o", "x.tsv", "--write-dump", "d.bin"],
     "--dist is incompatible with --write-dump/--read-dump"),
])
def test_dist_refusals(extra, message):
    """Exit 2 before joining a group, with the JAX CLI's messages."""
    from f5c_tpu import cli as jax_cli

    argv = ["call-methylation", "-b", "r.bam", "-g", "g.fa", "-r", "r.fa",
            "--dist", *extra]
    errs = []
    for entry in (main, jax_cli.main):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises(SystemExit) as ex:
            entry(argv)
        assert ex.value.code == 2
        errs.append(err.getvalue().strip().splitlines()[-1])
    assert message in errs[0]
    assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]
    assert not distributed.initialized()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_golden"))
    return datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), tmp)


def _argv(cmd, d, out, *extra):
    return [cmd, "--device", "cpu", "--min-mapq", "0", "-b", d["bam"],
            "-g", d["genome"], "-r", d["reads"], "--slow5", d["slow5"],
            "-o", out, *extra]


def _ranks(argvs):
    """Run one process a rank (``argvs[r]`` then the rendezvous options),
    on a free port, retried once on a fresh port; returns [(exit code,
    stderr)]."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    for attempt in range(2):
        # bind-then-release picks a free port; another process may take
        # it before rank 0 listens there, hence the one retry
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for r, argv in enumerate(argvs):
            argv = [*argv, "--dist", "--dist-coordinator",
                    f"127.0.0.1:{port}", "--dist-nprocs", str(len(argvs)),
                    "--dist-rank", str(r)]
            code = ("import sys\nfrom f5c_tpu_torch.cli import main\n"
                    f"sys.exit(main({argv!r}, dist_timeout_s={TIMEOUT_S}))")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        res = [(p.wait(timeout=300), p.stderr.read()) for p in procs]
        for p in procs:
            p.stderr.close()
        if attempt == 0 and any("EADDRINUSE" in e or "address already in use"
                                in e.lower() for _, e in res):
            continue
        return res


def _read(path):
    with open(path) as f:
        return f.read()


def test_two_process_call_methylation_matches_single(golden, tmp_path):
    single = str(tmp_path / "single.tsv")
    assert main(_argv("call-methylation", golden, single,
                      "--meth-out-version", "1")) == 0
    merged = str(tmp_path / "dist.tsv")
    argv = _argv("call-methylation", golden, merged, "--meth-out-version",
                 "1")
    for rc, err in _ranks([argv, argv]):
        assert rc == 0, err[-3000:]
    assert _read(merged) == _read(single)
    assert len(_read(single).splitlines()) > 6
    assert not os.path.exists(merged + ".part0")
    assert not os.path.exists(merged + ".part1")


def test_two_process_eventalign_summary_matches_single(golden, tmp_path):
    single, single_s = str(tmp_path / "s.tsv"), str(tmp_path / "s.sum")
    assert main(_argv("eventalign", golden, single, "--summary",
                      single_s)) == 0
    merged, merged_s = str(tmp_path / "d.tsv"), str(tmp_path / "d.sum")
    argv = _argv("eventalign", golden, merged, "--summary", merged_s)
    for rc, err in _ranks([argv, argv]):
        assert rc == 0, err[-3000:]
    assert _read(merged) == _read(single)
    assert _read(merged_s) == _read(single_s)
    assert len(_read(single_s).splitlines()) == 7
    for path in (merged, merged_s):
        assert not os.path.exists(path + ".part0")
        assert not os.path.exists(path + ".part1")


def test_failed_rank_leaves_no_merged_output(golden, tmp_path):
    """Rank 1 cannot open its BAM: it exits nonzero with the fail note;
    rank 0 writes its part, errors out of the barrier (within the test's
    timeout) and merges nothing."""
    merged = str(tmp_path / "dist.tsv")
    bad = dict(golden, bam=str(tmp_path / "missing.bam"))
    (rc0, err0), (rc1, err1) = _ranks([
        _argv("call-methylation", golden, merged),
        _argv("call-methylation", bad, merged)])
    assert rc0 != 0 and rc1 != 0
    assert "rank 1 failed before the output barrier" in err1
    assert "missing.bam" in err1
    assert not os.path.exists(merged)
    assert os.path.exists(merged + ".part0")
