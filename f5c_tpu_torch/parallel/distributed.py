"""Multi-process execution over ``torch.distributed``.

Counterpart of ``f5c_tpu/parallel/distributed.py``, which rides the
``jax.distributed`` coordination service.  The layer is the same:

- every process calls :func:`initialize`, which joins a **gloo** process
  group.  Gloo runs on the host: the layer needs no device collective,
  and two ranks may share one card (NCCL refuses two ranks on one GPU);
- reads are sharded by ``read_idx % world_size``, the single-process
  ``--shard I/N`` machinery, so a rank runs the same code on its reads
  as a single-process run does;
- each rank writes ``<output>.partN`` with one marker line
  ``#f5c-dist\\t<read_idx>`` before each read's rows
  (``Options.dist_markers``);
- a barrier, then rank 0 k-way merges the parts by read index, which
  gives the bytes of the single-process output, and removes them
  (:func:`finalize`).

Launchers, as ``jax.distributed.initialize`` finds them:

- the options ``--dist-coordinator HOST:PORT``, ``--dist-nprocs N`` and
  ``--dist-rank I`` always win, each on its own;
- what they leave missing comes from the first cluster environment
  present, in JAX's order (``jax/_src/clusters/__init__.py:23-24``): Open
  MPI (``mpirun``/``mpiexec``), then SLURM (``srun``), with JAX's rules
  for the coordinator (:func:`ompi_coordinator`, :func:`slurm_coordinator`);
  the group then meets at ``tcp://HOST:PORT``, where rank 0 listens;
- with no option given, the ``env://`` variables that ``torchrun``
  (``python -m torch.distributed.run``) sets come first: ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` (torchrun starts the process
  itself, also inside an allocation; JAX has no torchrun rule).

Once the group has formed, the ranks gather their host names: a rank's
local world is the ranks on its host, and its local rank the local id its
launcher gives (``LOCAL_RANK``, ``OMPI_COMM_WORLD_LOCAL_RANK``,
``SLURM_LOCALID``: JAX takes the same, ``cluster.py:82-86``), else its
place among them.  Its cards follow from those (:func:`local_devices`), so
ranks on a one-card host share ``cuda:0``.
"""

from __future__ import annotations

import datetime
import heapq
import os
import re
import socket

import torch

MARKER = "#f5c-dist\t"
TIMEOUT_S = 3600      # the JAX package's barrier timeout
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# the environments of jax/_src/clusters/ompi_cluster.py:20-24 and
# slurm_cluster.py:18-23 (JAX 0.9.0), and JAX's port override
# (cluster.py:72-74)
OMPI_URI = "OMPI_MCA_orte_hnp_uri"
OMPI_VARS = ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
             "OMPI_COMM_WORLD_LOCAL_RANK")
SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID", "SLURM_LOCALID")
PORT_OVERRIDE = "JAX_COORDINATOR_PORT"

# this process's place in the group: rank, world, local_rank, local_world
_state: dict = {}


def ompi_coordinator(env) -> str:
    """The coordinator under Open MPI, by JAX's rule
    (``jax/_src/clusters/ompi_cluster.py:36-54``): the launcher's address,
    the first of ``OMPI_MCA_orte_hnp_uri``'s ``tcp://`` or ``tcp6://``
    list, at port ``(jobid // 4096) % 4096 + 61440`` (the job id is the
    URI's part before its first dot), or ``JAX_COORDINATOR_PORT``."""
    uri = env[OMPI_URI]
    port = env.get(PORT_OVERRIDE)
    if not port:
        job_id = int(uri.split(".", maxsplit=1)[0]) // 2**12
        port = str(job_id % 2**12 + (65535 - 2**12 + 1))
    m = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if m is None:
        raise ValueError("--dist: could not parse the coordinator's address "
                         f"from {OMPI_URI}={uri!r}")
    return f"{next(g for g in m.groups() if g is not None)}:{port}"


def slurm_coordinator(env) -> str:
    """The coordinator under SLURM, by JAX's rule
    (``jax/_src/clusters/slurm_cluster.py:36-58``): the first host of
    ``SLURM_STEP_NODELIST`` (``node001``, ``node001,host2``: up to the
    first comma; ``node[001-015],host2``, ``node[001,007-015]``: the
    prefix and the bracket list's first number) at port
    ``SLURM_JOB_ID % 4096 + 61440``, or ``JAX_COORDINATOR_PORT``."""
    port = env.get(PORT_OVERRIDE)
    if not port:
        port = str(int(env["SLURM_JOB_ID"]) % 2**12 + (65535 - 2**12 + 1))
    nodes = env["SLURM_STEP_NODELIST"]
    ind = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if ind == len(nodes) or nodes[ind] == ",":
        return f"{nodes[:ind]}:{port}"
    suffix = nodes[ind + 1:]
    ind2 = next((i for i, ch in enumerate(suffix) if ch in ",-"), None)
    return f"{nodes[:ind]}{suffix[:ind2]}:{port}"


def cluster_launch(env) -> tuple[str, int, int, int] | None:
    """(coordinator, world, rank, local rank) of the first cluster
    environment present in ``env``, in JAX's order: Open MPI (present
    when ``OMPI_MCA_orte_hnp_uri`` is set), then SLURM (present when all
    of ``SLURM_VARS`` are); None when neither is."""
    if OMPI_URI in env:
        return (ompi_coordinator(env),
                *(int(env[v]) for v in OMPI_VARS))
    if all(v in env for v in SLURM_VARS):
        return (slurm_coordinator(env),
                *(int(env[v]) for v in SLURM_VARS[2:]))
    return None


def host_place(hosts: list, rank: int,
               local_id: int | None) -> tuple[int, int]:
    """(local rank, local world) of ``rank`` from every rank's host name
    (``hosts``, by rank): the local world counts the ranks on its host;
    the local rank is ``local_id`` where the launcher gives one, else the
    rank's place among them."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return (mine.index(rank) if local_id is None else local_id), len(mine)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the gloo process group and make the rank's card current.

    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``
    win where given; the rest comes from torchrun's ``env://`` variables
    (only with none given), Open MPI or SLURM (module docstring).  What
    no launcher supplies is a ValueError.  ``timeout_s`` bounds the
    rendezvous and every barrier.  Returns (rank, world_size)."""
    import torch.distributed as dist

    given = (coordinator, num_processes, process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    env = os.environ
    if all(a is None for a in given) and all(v in env for v in ENV_VARS):
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
        local_id = env.get("LOCAL_RANK")
    else:
        found = cluster_launch(env)
        local_id = None
        if found is not None:
            coord, world, rank, local_id = found
            coordinator = coordinator if coordinator is not None else coord
            num_processes = (num_processes if num_processes is not None
                             else world)
            process_id = process_id if process_id is not None else rank
        missing = [o for o, a in zip(("--dist-coordinator", "--dist-nprocs",
                                      "--dist-rank"),
                                     (coordinator, num_processes,
                                      process_id)) if a is None]
        if missing:
            raise ValueError(
                "--dist: no launcher found for " + ", ".join(missing)
                + " (no torchrun env://, Open MPI or SLURM environment): "
                "run under torchrun, mpirun or srun, or pass "
                "--dist-coordinator HOST:PORT --dist-nprocs N "
                "--dist-rank I")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    local_rank, local_world = host_place(
        hosts, rank, None if local_id is None else int(local_id))
    _state.update(rank=rank, world=world, timeout_s=timeout_s,
                  local_rank=local_rank, local_world=local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_devices()[0])
    return rank, world


def initialized() -> bool:
    return bool(_state)


def local_devices() -> list[torch.device]:
    """The cards this rank owns: with fewer ranks on the host than cards,
    every ``local_world``-th card from ``local_rank`` on; otherwise the
    one card ``local_rank % device_count`` (shared with other ranks)."""
    n = torch.cuda.device_count()
    lr, lw = _state["local_rank"], _state["local_world"]
    if lw >= n:
        return [torch.device("cuda", lr % n)]
    return [torch.device("cuda", i) for i in range(lr, n, lw)]


def barrier(name: str, timeout_ms: int | None = None) -> None:
    """Block until every rank reaches the barrier; raise on a rank that
    does not come within the timeout (``initialize``'s by default)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"barrier {name}: torch.distributed is not "
                           "initialized")
    if timeout_ms is None:
        timeout_ms = int(_state["timeout_s"] * 1000)
    dist.monitored_barrier(timeout=datetime.timedelta(
        milliseconds=timeout_ms), wait_all_ranks=True)


def shutdown() -> None:
    """Leave the process group (a process that keeps it hangs at exit)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _state.clear()


def part_path(output: str, rank: int) -> str:
    return f"{output}.part{rank}"


def merge_marked_parts(parts: list[str], out_path: str) -> int:
    """K-way merge marker-tagged shard outputs into ``out_path``.

    Each part is (header, then blocks of `#f5c-dist\\t<idx>` + rows).
    Blocks within a part are strictly increasing in read index (BAM
    iteration order), so a heap merge restores global order.  The
    header is taken from the first part.  Returns merged block count.
    """

    def blocks(path):
        idx, buf = None, []
        with open(path) as fh:
            for line in fh:
                if line.startswith(MARKER):
                    if idx is not None:
                        yield idx, "".join(buf)
                    idx = int(line[len(MARKER):])
                    buf = []
                elif idx is None:
                    continue  # shard header
                else:
                    buf.append(line)
            if idx is not None:
                yield idx, "".join(buf)

    header = ""
    if parts:
        with open(parts[0]) as fh:
            for line in fh:
                if line.startswith(MARKER):
                    break
                header += line
    n = 0
    with open(out_path, "w") as out:
        out.write(header)
        for _idx, text in heapq.merge(*(blocks(p) for p in parts)):
            out.write(text)
            n += 1
    return n


def finalize(outputs: list[str], rank: int, nprocs: int,
             keep_parts: bool = False) -> None:
    """Barrier, then rank 0 merges every output's shard parts and removes
    them, then a second barrier releases every rank; every rank leaves
    the group, also when a barrier fails.

    Each rank must already have written ``<output>.part<rank>`` with
    ``#f5c-dist`` markers (``opt.dist_markers``) for every path in
    ``outputs``."""
    try:
        barrier("f5c-output-done")
        if rank == 0:
            for output in outputs:
                parts = [part_path(output, r) for r in range(nprocs)]
                merge_marked_parts(parts, output)
                if not keep_parts:
                    for p in parts:
                        os.remove(p)
        barrier("f5c-merge-done")
    finally:
        shutdown()
