"""The port's multi-process layer (f5c_tpu_torch/parallel/distributed.py)
against the JAX package's (f5c_tpu/parallel/distributed.py): the part
merge on the parts of tests/test_distributed.py and on random part sets,
the --dist refusals with the JAX messages, and two real gloo processes of
``python -m f5c_tpu_torch.cli ... --dist --device cpu`` on the golden set,
whose merged files must be the single-process run's bytes: launched with
the three --dist-* options, under a faked SLURM and a faked Open MPI
environment with none, and with --dist-coordinator alone, SLURM supplying
the rest.  A rank that fails leaves no merged file and both ranks exit
nonzero.  The port's coordinator rules give JAX's answers
(jax/_src/clusters), and a rank's cards follow the gathered host names.
"""

import contextlib
import io
import os
import random
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


# every variable by which a launcher tells a process its place
LAUNCH_VARS = (*distributed.ENV_VARS, "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               distributed.OMPI_URI, *distributed.OMPI_VARS,
               *distributed.SLURM_VARS, distributed.PORT_OVERRIDE)
JOB_PORT0 = 65535 - 2**12 + 1     # JAX's ports: 61440 + a job's id mod 4096


def _free_port(lo: int = 1024) -> int:
    """A port of 127.0.0.1 that is free now, at or above ``lo``."""
    while True:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", 0 if lo == 1024
                        else random.randint(lo, 65535)))
            except OSError:
                continue
            return s.getsockname()[1]


def _launch(how: str, r: int, n: int, port: int):
    """(options, environment) of rank ``r`` of ``n`` meeting at
    127.0.0.1:``port``: ``manual`` the three --dist-* options; ``slurm``
    and ``ompi`` none, the faked environment of srun or mpirun with a job
    id that JAX's rule maps to ``port``; ``coordinator`` the option alone
    (the job's node list names hosts that do not resolve), SLURM the
    rest."""
    coord = f"127.0.0.1:{port}"
    if how == "manual":
        return ["--dist-coordinator", coord, "--dist-nprocs", str(n),
                "--dist-rank", str(r)], {}
    if how == "ompi":
        job = (port - JOB_PORT0) * 2**12
        return [], {distributed.OMPI_URI: f"{job}.0;tcp://127.0.0.1,"
                    f"10.0.0.9:{port + 1}", "OMPI_COMM_WORLD_SIZE": str(n),
                    "OMPI_COMM_WORLD_RANK": str(r),
                    "OMPI_COMM_WORLD_LOCAL_RANK": str(r)}
    slurm = {"SLURM_JOB_ID": str(4096 * 7 + port - JOB_PORT0),
             "SLURM_STEP_NODELIST": "127.0.0.1", "SLURM_NTASKS": str(n),
             "SLURM_PROCID": str(r), "SLURM_LOCALID": str(r)}
    if how == "slurm":
        return [], slurm
    slurm["SLURM_STEP_NODELIST"] = "nohost[001-002]"
    return ["--dist-coordinator", coord], slurm


def _ranks(argvs, how: str = "manual"):
    """Run one process a rank (``argvs[r]`` then the launch of ``how``,
    ``_launch``), on a free port, retried once on a fresh port; returns
    [(exit code, stderr)]."""
    env0 = {k: v for k, v in os.environ.items()
            if k != "PYTHONPATH" and k not in LAUNCH_VARS}
    env0["PYTHONPATH"] = ROOT
    for attempt in range(2):
        # bind-then-release picks a free port; another process may take
        # it before rank 0 listens there, hence the one retry
        port = _free_port(1024 if how == "manual" else JOB_PORT0)
        procs = []
        for r, argv in enumerate(argvs):
            opts, env = _launch(how, r, len(argvs), port)
            argv = [*argv, "--dist", *opts]
            code = ("import sys\nfrom f5c_tpu_torch.cli import main\n"
                    f"sys.exit(main({argv!r}, dist_timeout_s={TIMEOUT_S}))")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env={**env0, **env},
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


@pytest.fixture(scope="module")
def single_meth(golden, tmp_path_factory):
    """The single process's call-methylation output."""
    single = str(tmp_path_factory.mktemp("dist_single") / "single.tsv")
    assert main(_argv("call-methylation", golden, single,
                      "--meth-out-version", "1")) == 0
    return _read(single)


@pytest.mark.parametrize("how", ["manual", "slurm", "ompi", "coordinator"])
def test_two_process_call_methylation_matches_single(golden, single_meth,
                                                     tmp_path, how):
    """Two ranks with the three --dist-* options; under srun's and
    mpirun's environments with none of them; with --dist-coordinator
    alone and SLURM's environment for the rest."""
    merged = str(tmp_path / "dist.tsv")
    argv = _argv("call-methylation", golden, merged, "--meth-out-version",
                 "1")
    for rc, err in _ranks([argv, argv], how):
        assert rc == 0, err[-3000:]
    assert _read(merged) == single_meth
    assert len(single_meth.splitlines()) > 6
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


SLURM_NODES = ["node001", "node001,host2", "node[001-015],host2",
               "node[001,007-015],host2", "host[1-2]-ib", "127.0.0.1",
               "gpu-a[12-14,20]", "n[7]"]
OMPI_URIS = ["1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
             "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
             "2620:10d:c083:150e::3000:2]:43370",
             "4096.0;tcp://127.0.0.1:5000", "0.1;tcp://host-7:1234"]


def _clean_env(monkeypatch):
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)


@pytest.mark.parametrize("port", [None, "7000"])
@pytest.mark.parametrize("nodes", SLURM_NODES)
def test_slurm_coordinator_matches_jax(monkeypatch, nodes, port):
    from jax._src.clusters.slurm_cluster import SlurmCluster

    _clean_env(monkeypatch)
    env = {"SLURM_JOB_ID": "123456789", "SLURM_STEP_NODELIST": nodes,
           "SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1"}
    if port:
        env[distributed.PORT_OVERRIDE] = port
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = SlurmCluster.get_coordinator_address(None, port)
    assert distributed.slurm_coordinator(os.environ) == want
    assert SlurmCluster.is_env_present()
    assert distributed.cluster_launch(os.environ) == (
        want, SlurmCluster.get_process_count(),
        SlurmCluster.get_process_id(), SlurmCluster.get_local_process_id())
    monkeypatch.delenv("SLURM_LOCALID")      # not all of srun's variables
    assert not SlurmCluster.is_env_present()
    assert distributed.cluster_launch(os.environ) is None


@pytest.mark.parametrize("port", [None, "7000"])
@pytest.mark.parametrize("uri", OMPI_URIS)
def test_ompi_coordinator_matches_jax(monkeypatch, uri, port):
    """Open MPI's rule, and Open MPI before SLURM when both are present
    (JAX's order)."""
    from jax._src.clusters.ompi_cluster import OmpiCluster

    _clean_env(monkeypatch)
    env = {distributed.OMPI_URI: uri, "OMPI_COMM_WORLD_SIZE": "8",
           "OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_LOCAL_RANK": "1",
           "SLURM_JOB_ID": "9", "SLURM_STEP_NODELIST": "n1",
           "SLURM_NTASKS": "2", "SLURM_PROCID": "0", "SLURM_LOCALID": "0"}
    if port:
        env[distributed.PORT_OVERRIDE] = port
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = OmpiCluster.get_coordinator_address(None, port)
    assert distributed.ompi_coordinator(os.environ) == want
    assert distributed.cluster_launch(os.environ) == (
        want, OmpiCluster.get_process_count(),
        OmpiCluster.get_process_id(), OmpiCluster.get_local_process_id())


def test_partial_options_without_a_launcher_are_refused(monkeypatch):
    _clean_env(monkeypatch)
    with pytest.raises(ValueError, match="no launcher found for "
                       "--dist-coordinator, --dist-rank"):
        distributed.initialize(None, 2, None)
    assert not distributed.initialized()


# (host of each rank, cards a host, local ids from the launcher or None,
#  each rank's cards)
PLACEMENTS = {
    "two_single_rank_hosts": (["a", "b"], 8, None,
                              [list(range(8)), list(range(8))]),
    "four_ranks_two_hosts": (["a", "a", "b", "b"], 8, None,
                             [[0, 2, 4, 6], [1, 3, 5, 7]] * 2),
    "interleaved_hosts": (["a", "b", "a", "b"], 8, None,
                          [[0, 2, 4, 6]] * 2 + [[1, 3, 5, 7]] * 2),
    "launcher_local_ids": (["a", "a", "b", "b"], 8, [1, 0, 0, 1],
                           [[1, 3, 5, 7], [0, 2, 4, 6], [0, 2, 4, 6],
                            [1, 3, 5, 7]]),
    "one_card_two_ranks": (["a", "a"], 1, None, [[0], [0]]),
}


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_local_devices_follow_the_gathered_hosts(monkeypatch, case):
    """initialize on each rank of a launch with the group, the host names
    and the card count faked: every rank gets its host's cards, by the
    gathered host list (a launcher's own local id, where it gives one, as
    the local rank), and makes the first of them current."""
    import torch
    import torch.distributed as dist

    hosts, n_cards, local_ids, want = PLACEMENTS[case]
    for r in range(len(hosts)):
        _clean_env(monkeypatch)
        if local_ids is not None:
            monkeypatch.setenv("LOCAL_RANK", str(local_ids[r]))
            for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
                monkeypatch.setenv(v, "0")
        current = []
        monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
        monkeypatch.setattr(dist, "get_rank", lambda r=r: r)
        monkeypatch.setattr(dist, "get_world_size", lambda: len(hosts))

        def gather(out, obj, r=r):
            assert obj == hosts[r]
            out[:] = hosts

        monkeypatch.setattr(dist, "all_gather_object", gather)
        monkeypatch.setattr(socket, "gethostname", lambda r=r: hosts[r])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
        monkeypatch.setattr(torch.cuda, "set_device", current.append)
        args = ((None, None, None) if local_ids is not None
                else ("h0:1234", len(hosts), r))
        assert distributed.initialize(*args) == (r, len(hosts))
        got = distributed.local_devices()
        distributed.shutdown()
        assert got == [torch.device("cuda", i) for i in want[r]], r
        assert current == [got[0]]
