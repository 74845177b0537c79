"""Data-parallel dispatch of read batches over several devices.

Counterpart of ``f5c_tpu/parallel/mesh.py``, whose ``shard_map`` runs the
single-chip program on every device of a 1-D 'data' mesh.  Here one host
thread does it by hand: a dispatch deals its items (reads, or a round's
chunks) round-robin over the devices, launches each device's part under
that device's guard (``ops._build.device_guard``) on its current stream
-- the launches are asynchronous, so the devices run side by side -- and
un-deals the results into the single-device order.  The model tables are
replicated, once a device.  Reads are independent of their batchmates in
every kernel, so the results are the single-device run's bit for bit.

Only dispatches of at least ``2 * D`` items are dealt (the JAX runner's
rule); a smaller one runs on the first device.  No slot is launched
with zero items.

``data_devices`` picks the devices: every visible card by default, the
rank's own cards under ``--dist`` (``jax.local_devices()``'s role), none
with ``F5C_TPU_MESH=0``, or an explicit list from the library API
(``Pipeline(..., devices=[...])``), which is how the CPU tests deal over
``[cpu] * D`` and how a one-card host deals over ``[cuda:0, cuda:0]``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..backend import HostCopy, canonical_device, h2d
from ..ops import _build, abea_cuda, hmm_cuda, viterbi_cuda

# per-device transfer accounting for sharded dispatches: evidence that
# the host can feed N chips (per-device H2D shrinks with the mesh while
# replicated tables stay constant).  Keys: <kind>.{n_dispatch,
# sharded_bytes, replicated_bytes, per_device_bytes}.
TRANSFER_LOG: dict[str, float] = {}
# per slot of a sharded dispatch: "<kind>.slot<d>" -> parts launched there
# (kinds abea, hmm, viterbi_round), "<kernel>.slot<d>" -> that slot's
# kernel launches (the wrappers' counts: abea_fill, abea_walk,
# hmm_forward, viterbi)
SLOT_LOG: dict[str, int] = {}


def data_devices(primary: torch.device, devices=None) -> list[torch.device]:
    """The devices a pipeline deals over, ``primary`` first, or [] for a
    single-device run.  ``devices``: an explicit list (its first entry
    must be ``primary``); otherwise every visible card when there are
    several, the rank's own cards under --dist, none with F5C_TPU_MESH=0
    or on the CPU.  An unindexed ``cuda`` is the current card."""
    primary = canonical_device(primary)
    if devices is not None:
        devs = [canonical_device(d) for d in devices]
        if not devs or devs[0] != primary:
            raise ValueError(f"devices {devs}: the first must be the "
                             f"pipeline's device {primary}")
        return devs if len(devs) > 1 else []
    if os.environ.get("F5C_TPU_MESH", "1") == "0" or primary.type != "cuda":
        return []
    from . import distributed

    if distributed.initialized():
        devs = distributed.local_devices()
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [primary] + [d for d in devs if d != primary]
    return devs if len(devs) > 1 else []


def slot_devices(devices, primary: torch.device, n: int) -> list:
    """The devices a dispatch of ``n`` items runs on: all of ``devices``
    when it has at least two items a device (the JAX runner's rule),
    else ``primary`` alone."""
    if devices and n >= 2 * len(devices):
        return list(devices)
    return [primary]


def deal(n: int, n_dev: int) -> list[np.ndarray]:
    """Item indices of each of ``n_dev`` slots, dealt round-robin."""
    return [np.arange(d, n, n_dev) for d in range(n_dev)]


def record_dispatch(kind: str, sharded_bytes: int, replicated_bytes: int,
                    n_dev: int) -> None:
    def add(key, v):
        TRANSFER_LOG[key] = TRANSFER_LOG.get(key, 0.0) + v

    add(f"{kind}.n_dispatch", 1)
    add(f"{kind}.sharded_bytes", float(sharded_bytes))
    add(f"{kind}.replicated_bytes", float(replicated_bytes))
    add(f"{kind}.per_device_bytes",
        float(sharded_bytes) / max(n_dev, 1) + float(replicated_bytes))


def transfer_table() -> str:
    """Human-readable per-device H2D table (one row per dispatch kind)."""
    kinds = sorted({k.rsplit(".", 1)[0] for k in TRANSFER_LOG})
    rows = ["kind            disp   sharded_MB  replicated_MB  "
            "per_device_MB"]
    for k in kinds:
        g = lambda f: TRANSFER_LOG.get(f"{k}.{f}", 0.0)  # noqa: E731
        rows.append(f"{k:<15} {int(g('n_dispatch')):>4}   "
                    f"{g('sharded_bytes') / 1e6:>10.3f}  "
                    f"{g('replicated_bytes') / 1e6:>13.3f}  "
                    f"{g('per_device_bytes') / 1e6:>13.3f}")
    return "\n".join(rows)


def table_bytes(model) -> int:
    """Bytes of a model's three f32 device tables, replicated a device."""
    return 3 * 4 * len(model.level_mean)


def _kernel_counts() -> dict:
    return {k: v for d in (abea_cuda.launches, hmm_cuda.launches,
                           viterbi_cuda.launches) for k, v in d.items()}


def deal_slots(devices, n: int) -> list:
    """[(slot, device, item indices)]: ``n`` items dealt over ``devices``."""
    return list(zip(range(len(devices)), devices, deal(n, len(devices))))


def on_slots(kind: str, slots, launch, replicated_bytes: int) -> list:
    """Run ``launch(dev, idx, *args) -> (result, sharded_bytes)`` for each
    slot ``(slot, dev, idx, *args)`` whose ``idx`` is not empty, under the
    device's guard.  One slot is a single-device launch; several are a
    sharded dispatch, which is accounted in TRANSFER_LOG and SLOT_LOG.
    Returns [(slot, idx, result)] of the launched slots.  The counterpart
    of the JAX package's ``shard_align_ring`` and ``shard_hmm_forward``
    (the callers' ``launch`` is the single-device program)."""
    sharded = len(slots) > 1
    out, nbytes_all = [], 0
    for d, dev, idx, *args in slots:
        if len(idx) == 0:
            continue
        before = _kernel_counts() if sharded else None
        with _build.device_guard(dev):
            result, nbytes = launch(dev, idx, *args)
        out.append((d, idx, result))
        nbytes_all += nbytes
        if sharded:
            for name, n in _kernel_counts().items():
                if n > before[name]:
                    key = f"{name}.slot{d}"
                    SLOT_LOG[key] = SLOT_LOG.get(key, 0) + n - before[name]
            key = f"{kind}.slot{d}"
            SLOT_LOG[key] = SLOT_LOG.get(key, 0) + 1
    if sharded:
        record_dispatch(kind, nbytes_all, replicated_bytes, len(slots))
    return out


def shard_viterbi_rounds(devices, spec_i32, spec_f32, consts, pools,
                         max_path: int):
    """One lockstep round of chunk Viterbis (``viterbi_cuda.viterbi_rounds``)
    with the chunk axis dealt over ``devices`` (one device: one launch);
    ``pools[dev]`` holds the batch's (rank pool, event pool, model tables)
    on ``dev``, uploaded once a batch.  Each slot's launch is planned on
    its own chunks.  Returns host (movements u8 [N, max_path // 2],
    n_steps i32 [N]) in the round's order.  Counterpart of
    ``shard_viterbi_rounds``."""

    def launch(dev, idx):
        si, sf = spec_i32[idx], spec_f32[idx]
        rank_pool, ev_pool, tables = pools[dev]
        movs, n_steps = viterbi_cuda.viterbi_rounds(
            h2d(si, dev), h2d(sf, dev), consts, rank_pool, ev_pool,
            *tables, max_path, host_spec=si)
        return HostCopy([movs, n_steps]), si.nbytes + sf.nbytes

    n = spec_i32.shape[0]
    parts = on_slots("viterbi_round", deal_slots(devices, n), launch, 0)
    movs = np.empty((n, max_path // 2), np.uint8)
    n_steps = np.empty(n, np.int32)
    for _slot, idx, copy in parts:
        movs[idx], n_steps[idx] = copy.wait()
    return movs, n_steps
