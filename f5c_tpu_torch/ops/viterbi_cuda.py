"""The chunk Viterbi of eventalign's re-alignment (K8): a CUDA tensor goes
to the hand-written kernels of ``csrc/viterbi.cu``, a CPU tensor to the
plain PyTorch version ``ops/hmm.py:viterbi_rounds_plain``.  Counterpart
of ``f5c_tpu/ops/hmm.py:hmm_viterbi_rounds``.

The wrapper checks device, dtype, shape and contiguity, plans the launch
(``table_plan``: the chunks ordered by event count, one chunk a block,
each movement table in the block's shared memory or in a global
scratch), launches on torch's current stream of the tensors' device
(under ``_build.device_guard``) and counts the launch in ``launches``.  There is no fallback: a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .hmm import viterbi_rounds_plain

launches = {"viterbi": 0}

GROUP = 32             # csrc/viterbi.cu VITERBI_GROUP: lanes a chunk
REG_CAP = 128          # csrc/viterbi.cu REG_CAP: k-mers kept in registers
TILE_ITEMS = 4         # csrc/viterbi.cu TILE_ITEMS: the tiled path's items
MAX_SMEM = 232448      # the opt-in shared memory of one block
# the largest movement table (n_events x (n_kmers + 1) bytes) a block keeps
# in shared memory; a larger one goes to the global scratch
TABLE_SMEM_MAX = 160 * 1024


def partitions() -> list[tuple[int, int, str]]:
    """(lanes, items a lane, how the running max crosses the lanes) of
    every KMER_SKIP running max csrc/viterbi.cu is built with
    (hmm.skip_chain_partitioned): the register kernel's GROUP x q items
    for q = 1..4 (up to 32q k-mers), lane to lane; the tiled kernel's 32
    x TILE_ITEMS (tiles of 128 columns), by shuffle rounds."""
    return ([(GROUP, 32 * q // GROUP, "carry") for q in (1, 2, 3, 4)]
            + [(32, TILE_ITEMS, "shuffle")])


def items_of(k_max: int) -> int:
    """Items a lane keeps for a launch whose widest chunk has ``k_max``
    k-mers (TILE_ITEMS on the tiled path)."""
    if k_max > REG_CAP:
        return TILE_ITEMS
    return 32 * max(-(-k_max // 32), 1) // GROUP


def state_bytes(k_max: int) -> int:
    """csrc/viterbi.cu state_bytes: the tiled path's per-chunk state of
    ``k_max`` k-mers in shared memory, rounded to 16 bytes."""
    return (4 * (3 * k_max + 6 * (k_max + 1)) + 15) // 16 * 16


def table_plan(n_kmers: np.ndarray, n_events: np.ndarray):
    """The launch plan of a round: (plan i64 [2, N]: the chunk of each
    launch slot, most events first, and that slot's table offset -- >= 0
    in the scratch, else -1 - its byte offset in the block's shared
    memory; scratch bytes; the launch's dynamic shared memory).  A block
    holds one chunk: its table, after the tiled path's state (above
    REG_CAP k-mers), in shared memory when it takes at most TABLE_SMEM_MAX
    bytes and fits there, else in the scratch, packed in slot order (an
    empty chunk's table is sized as any other's; the kernel writes
    none).  An
    eventalign chunk spans at most ALIGN_STRIDE + 1 bases
    (pipeline/eventalign.py); the tiled state of a chunk fills a block at
    ~6,450 k-mers (the C entry point rejects such a launch with
    cudaErrorInvalidValue)."""
    nk = np.asarray(n_kmers, np.int64)
    ne = np.asarray(n_events, np.int64)
    k_max = max(int(nk.max()), 1) if nk.shape[0] else 1
    base = state_bytes(k_max) if k_max > REG_CAP else 0
    plan = np.empty((2, nk.shape[0]), np.int64)
    plan[0] = np.argsort(-ne, kind="stable")
    cells = (ne * (nk + 1))[plan[0]]
    big = cells > min(TABLE_SMEM_MAX, MAX_SMEM - base)
    if not big.any():
        plan[1] = -1 - base
        return plan, 0, base + int(cells.max(initial=0))
    glob = np.where(big, cells, 0)
    end = np.cumsum(glob)
    plan[1] = np.where(big, end - glob, -1 - base)
    return plan, int(end[-1]), base + int((cells - glob).max())


def viterbi_rounds(spec_i32, spec_f32, consts, rank_pool, ev_pool,
                   level_mean, level_stdv, level_log_stdv, max_path: int,
                   host_spec: np.ndarray | None = None):
    """One lockstep round of chunk Viterbis (the layout of
    ``ops/hmm.py``): spec_i32 i32 [N, 6], spec_f32 f32 [N, 6], ``consts``
    the f32 [8] host array of ``hmm.viterbi_consts``, the batch's rank
    and event pools, the model tables; ``max_path`` even.  ``host_spec``
    is spec_i32's host copy where the caller has one (else it is read
    back from the card to plan the launch).  Returns (movements u8 [N,
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
    plan, scratch_bytes, smem = table_plan(spec[:, 2], spec[:, 5])
    movs = torch.zeros((N, max_path // 2), dtype=torch.uint8, device=dev)
    n_steps = torch.empty(N, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8,
                          device=dev)
    plan_dev = torch.from_numpy(plan).to(dev, non_blocking=True)
    k_max = max(int(spec[:, 2].max()) if N else 1, 1)
    lib = _build.library()
    with _build.device_guard(dev):
        span = _build.span_start(dev)
        err = lib.f5c_viterbi_rounds(
            spec_i32.data_ptr(), spec_f32.data_ptr(), consts.ctypes.data,
            rank_pool.data_ptr(), ev_pool.data_ptr(), level_mean.data_ptr(),
            level_stdv.data_ptr(), level_log_stdv.data_ptr(),
            plan_dev.data_ptr(), scratch.data_ptr(), movs.data_ptr(),
            n_steps.data_ptr(), N, max_path, k_max, smem,
            _build.stream_handle(dev))
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_viterbi_rounds", err)
    launches["viterbi"] += 1
    return movs, n_steps


def division_probe(a, b):
    """(the register kernel's fast division of a by b, __fdiv_rn's), f32
    CUDA tensors of a's shape: the probe that holds the fast path to the
    correctly rounded quotient on the card (tests/test_torch_kernels_cuda.py).
    Not counted in ``launches``."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("division_probe: the probe runs on the card")
    _build.check_tensor("a", a, torch.float32, 1, dev)
    _build.check_tensor("b", b, torch.float32, 1, dev)
    if b.shape != a.shape:
        raise ValueError("division_probe: a and b differ in shape")
    fast, ref = torch.empty_like(a), torch.empty_like(a)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_viterbi_division_probe(
            a.data_ptr(), b.data_ptr(), fast.data_ptr(), ref.data_ptr(),
            a.shape[0], _build.stream_handle(dev))
    _build.check_error(lib, "f5c_viterbi_division_probe", err)
    return fast, ref
