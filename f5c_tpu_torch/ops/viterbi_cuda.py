"""The chunk Viterbi of eventalign's re-alignment (K8): a CUDA tensor goes
to the hand-written kernel of ``csrc/viterbi.cu``, a CPU tensor to the
plain PyTorch version ``ops/hmm.py:viterbi_rounds_plain``.  Counterpart
of ``f5c_tpu/ops/hmm.py:hmm_viterbi_rounds``.

The wrapper checks device, dtype, shape and contiguity, sizes the
kernel's shared memory from the round (no shape buckets), places each
chunk's movement table in shared memory or, when it is larger than
``TABLE_SMEM_MAX``, in a global scratch, launches on torch's current
stream and counts the launch in ``launches``.  There is no fallback: a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .hmm import viterbi_rounds_plain

launches = {"viterbi": 0}

THREADS = 128          # csrc/viterbi.cu VT_THREADS
MAX_SMEM = 232448      # the opt-in shared memory of one block
# the largest movement table (n_events x (n_kmers + 1) bytes) a block keeps
# in shared memory; a larger one goes to the global scratch
TABLE_SMEM_MAX = 160 * 1024


def state_bytes(k_max: int) -> int:
    """csrc/viterbi.cu table_base: the per-chunk state of ``k_max``
    k-mers, rounded to 16 bytes."""
    floats = 3 * k_max + 6 * (k_max + 1) + THREADS // 32
    return (4 * floats + 15) // 16 * 16


def table_plan(n_kmers: np.ndarray, n_events: np.ndarray):
    """(scratch_off i64 [N]: -1 for a table in shared memory, else its
    offset in the scratch; scratch bytes; the launch's dynamic shared
    memory) for a round of chunks.  The per-chunk state stays in shared
    memory: an eventalign chunk spans at most ALIGN_STRIDE + 1 bases
    (pipeline/eventalign.py), about 3.5 KB of state, far below the
    ~6,400 k-mers that would fill it (the C entry point rejects such a
    launch with cudaErrorInvalidValue)."""
    cells = (n_events.astype(np.int64) * (n_kmers.astype(np.int64) + 1))
    k_max = int(n_kmers.max()) if n_kmers.shape[0] else 1
    base = state_bytes(max(k_max, 1))
    room = min(TABLE_SMEM_MAX, MAX_SMEM - base)
    big = cells > room
    off = np.full(cells.shape[0], -1, np.int64)
    sizes = cells[big]
    off[big] = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) \
        if sizes.shape[0] else off[big]
    in_smem = cells[~big]
    table = int(in_smem.max()) if in_smem.shape[0] else 0
    return off, int(sizes.sum()), base + (table + 15) // 16 * 16


def viterbi_rounds(spec_i32, spec_f32, consts, rank_pool, ev_pool,
                   level_mean, level_stdv, level_log_stdv, max_path: int,
                   host_spec: np.ndarray | None = None):
    """One lockstep round of chunk Viterbis (the layout of
    ``ops/hmm.py``): spec_i32 i32 [N, 6], spec_f32 f32 [N, 6], ``consts``
    the f32 [8] host array of ``hmm.viterbi_consts``, the batch's rank
    and event pools, the model tables; ``max_path`` even.  ``host_spec``
    is spec_i32's host copy where the caller has one (else it is read
    back from the card to size the launch).  Returns (movements u8 [N,
    max_path//2], n_steps i32 [N])."""
    dev = spec_i32.device
    N = spec_i32.shape[0]
    for name, t, dt, nd in (
            ("spec_i32", spec_i32, torch.int32, 2),
            ("spec_f32", spec_f32, torch.float32, 2),
            ("rank_pool", rank_pool, torch.int32, 1),
            ("ev_pool", ev_pool, torch.float32, 1),
            ("level_mean", level_mean, torch.float32, 1),
            ("level_stdv", level_stdv, torch.float32, 1),
            ("level_log_stdv", level_log_stdv, torch.float32, 1)):
        _build.check_tensor(name, t, dt, nd, dev)
    consts = np.ascontiguousarray(consts, dtype=np.float32)
    if spec_i32.shape[1] != 6 or spec_f32.shape != (N, 6):
        raise ValueError("viterbi_rounds: specs are [N, 6]")
    if consts.shape != (8,) or max_path % 2:
        raise ValueError("viterbi_rounds: 8 constants and an even max_path")
    if dev.type == "cpu":
        return viterbi_rounds_plain(spec_i32, spec_f32, consts, rank_pool,
                                    ev_pool, level_mean, level_stdv,
                                    level_log_stdv, max_path)
    if dev.type != "cuda":
        raise ValueError(f"viterbi_rounds: unsupported device {dev}")
    spec = (np.asarray(host_spec) if host_spec is not None
            else spec_i32.cpu().numpy())
    off, scratch_bytes, smem = table_plan(spec[:, 2], spec[:, 5])
    movs = torch.zeros((N, max_path // 2), dtype=torch.uint8, device=dev)
    n_steps = torch.empty(N, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8,
                          device=dev)
    off_dev = torch.from_numpy(off).to(dev, non_blocking=True)
    k_max = max(int(spec[:, 2].max()) if N else 1, 1)
    lib = _build.library()
    span = _build.span_start(dev)
    err = lib.f5c_viterbi_rounds(
        spec_i32.data_ptr(), spec_f32.data_ptr(), consts.ctypes.data,
        rank_pool.data_ptr(), ev_pool.data_ptr(), level_mean.data_ptr(),
        level_stdv.data_ptr(), level_log_stdv.data_ptr(),
        off_dev.data_ptr(), scratch.data_ptr(), movs.data_ptr(),
        n_steps.data_ptr(), N, max_path, k_max, smem,
        _build.stream_handle(dev))
    _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_viterbi_rounds", err)
    launches["viterbi"] += 1
    return movs, n_steps
