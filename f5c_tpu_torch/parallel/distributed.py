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

Launchers: with ``--dist-coordinator HOST:PORT --dist-nprocs N
--dist-rank I`` the group meets at ``tcp://HOST:PORT`` (rank 0 listens
there); with none of the three it reads the ``env://`` variables that
``torchrun`` (``python -m torch.distributed.run``) sets: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, and ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` where present.  A rank's card is ``LOCAL_RANK``
(else its rank) modulo the visible cards, so ranks on a one-card host
share ``cuda:0``.
"""

from __future__ import annotations

import datetime
import heapq
import os

import torch

MARKER = "#f5c-dist\t"
TIMEOUT_S = 3600      # the JAX package's barrier timeout
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")

# this process's place in the group: rank, world, local_rank, local_world
_state: dict = {}


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the gloo process group and make the rank's card current.

    Pass all of ``coordinator`` ("host:port"), ``num_processes`` and
    ``process_id`` for a manual launch, or none of them under ``torchrun``
    (the ``env://`` variables); anything else, or no launcher, is a
    ValueError.  ``timeout_s`` bounds the rendezvous and every barrier.
    Returns (rank, world_size)."""
    import torch.distributed as dist

    manual = (coordinator, num_processes, process_id)
    timeout = datetime.timedelta(seconds=timeout_s)
    if all(a is not None for a in manual):
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif all(a is None for a in manual):
        missing = [v for v in ENV_VARS if v not in os.environ]
        if missing:
            raise ValueError(
                "--dist: no launcher found (" + ", ".join(missing)
                + " unset): run under torchrun, or pass --dist-coordinator "
                "HOST:PORT --dist-nprocs N --dist-rank I")
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        raise ValueError("--dist-coordinator, --dist-nprocs and --dist-rank "
                         "are given together or not at all")
    rank, world = dist.get_rank(), dist.get_world_size()
    _state.update(rank=rank, world=world, timeout_s=timeout_s,
                  local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                  local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
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
