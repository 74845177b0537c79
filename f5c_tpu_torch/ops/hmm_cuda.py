"""HMM forward wrapper: a CUDA tensor goes to the hand-written kernel of
``csrc/hmm.cu``, which builds each window's inputs itself (K6 fused into
K2), a CPU tensor to the plain PyTorch version
``ops/hmm_meta.hmm_forward_meta_plain``.  Counterpart of
``f5c_tpu/ops/hmm_meta.hmm_forward_meta`` (the Pallas scorer
``f5c_tpu/ops/hmm_pallas.py`` fed by ``build_inputs``).

The wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on torch's current stream of the tensors' device (under
``_build.device_guard``) and counts the launch in ``launches``.  There is no fallback: a CUDA tensor launches the kernel or
raises.

The kernel scores windows of <= ``NARROW`` k-mers two to a warp; the
host puts them first (``order_windows``) and passes their count.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .hmm import CONSTS
from .hmm_meta import (META_BYTES, build_inputs, hmm_forward_meta_plain,
                       window_fields)

launches = {"hmm_forward": 0}

NARROW = 16          # k-mers of a narrow window: half a warp
CHUNK = 32           # k-mers a warp steps at once
REG_KM = 2 * CHUNK   # widest window whose state the kernel keeps in registers
# widest window (k-mers) one warp's shared memory holds: 6 f32 arrays
MAX_KW = 232448 // (6 * 4)


def order_windows(n_km, n_ev):
    """Host: the launch order of windows with ``n_km`` k-mers and ``n_ev``
    events (NumPy).  Narrow windows (<= NARROW k-mers, empty ones
    included) first, each class by event count, longest first.  Returns
    (order, n_narrow): window ``order[i]`` goes to launch slot ``i``, and
    the first ``n_narrow`` slots are narrow."""
    n_km = np.asarray(n_km)
    narrow = n_km <= NARROW
    order = np.lexsort((-np.asarray(n_ev, np.int64), ~narrow))
    return order, int(narrow.sum())


def launch_shape(n_km, n_ev, n_narrow: int) -> dict:
    """Host: the kernel's work for windows in launch order (NumPy): narrow
    windows two to a warp, each other a warp over ceil(n_km / CHUNK)
    chunks.  ``warp_steps`` counts a warp's event steps times its chunks:
    the pairs' longer event count, the others' events times chunks."""
    n_km = np.maximum(np.asarray(n_km, np.int64), 0)
    n_ev = np.where(n_km > 0, np.asarray(n_ev, np.int64), 0)
    pair = np.zeros(2 * ((n_narrow + 1) // 2), np.int64)
    pair[:n_narrow] = n_ev[:n_narrow]
    wide_km, wide_ev = n_km[n_narrow:], n_ev[n_narrow:]
    chunks = np.maximum(-(-wide_km // CHUNK), 1)
    return dict(
        windows=int(n_km.shape[0]), narrow=n_narrow,
        wide=int(wide_km.shape[0]),
        multi_chunk=int((wide_km > CHUNK).sum()),
        in_smem=int((wide_km > REG_KM).sum()),
        warps=pair.shape[0] // 2 + int(wide_km.shape[0]),
        warp_steps=int(pair.reshape(-1, 2).max(axis=1).sum()
                       + (wide_ev * chunks).sum()),
        cells=int((n_km * n_ev).sum()))


def _check_inputs(meta, packed_ref, read_tab, dev):
    _build.check_tensor("meta", meta, torch.uint8, 2, dev)
    _build.check_tensor("packed_ref", packed_ref, torch.uint8, 1, dev)
    _build.check_tensor("read_tab", read_tab, torch.float32, 2, dev)
    if meta.shape[1] != META_BYTES or read_tab.shape[1] != 8:
        raise ValueError("hmm_forward_meta: meta is [N, 16] u8 and read_tab "
                         "[n_reads, 8] f32")
    if packed_ref.shape[0] == 0:
        raise ValueError("hmm_forward_meta: empty packed reference")


def hmm_forward_meta(meta, packed_ref, read_tab, ev_pool, level_mean,
                     level_stdv, level_log_stdv, k: int,
                     allow_pre: bool = True, allow_post: bool = True,
                     n_narrow: int = 0, max_km: int | None = None):
    """Forward log-likelihood of every window, f32 [N].

    meta: u8 [N, 16] (``hmm_meta.pack_meta``), its first ``n_narrow``
    windows of <= NARROW k-mers (``order_windows``); packed_ref: the 2-bit
    reference concat with its zero sentinel; read_tab: f32 [n_reads, 8];
    ev_pool: f32 events; the model tables; ``max_km``: at least the widest
    window's k-mers (read from meta, one device read, when None)."""
    dev = meta.device
    _check_inputs(meta, packed_ref, read_tab, dev)
    _build.check_tensor("ev_pool", ev_pool, torch.float32, 1, dev)
    for name, t in (("level_mean", level_mean), ("level_stdv", level_stdv),
                    ("level_log_stdv", level_log_stdv)):
        _build.check_tensor(name, t, torch.float32, 1, dev)
    if not (level_mean.shape == level_stdv.shape == level_log_stdv.shape):
        raise ValueError("hmm_forward_meta: model tables differ in length")
    N = meta.shape[0]
    if not 0 <= n_narrow <= N:
        raise ValueError(f"hmm_forward_meta: n_narrow {n_narrow} of {N}")
    if dev.type == "cpu":
        return hmm_forward_meta_plain(meta, packed_ref, read_tab, ev_pool,
                                      level_mean, level_stdv, level_log_stdv,
                                      k, allow_pre=allow_pre,
                                      allow_post=allow_post)
    if dev.type != "cuda":
        raise ValueError(f"hmm_forward_meta: unsupported device {dev}")
    if meta.data_ptr() % 16:
        raise ValueError("hmm_forward_meta: meta is not 16-byte aligned")
    if max_km is None:
        max_km = int(window_fields(meta, k)["n_km"].max()) if N else 0
    kw_smem = 0 if max_km <= REG_KM else -(-max_km // CHUNK) * CHUNK
    if kw_smem > MAX_KW:
        raise ValueError(f"hmm_forward_meta: windows of {max_km} k-mers "
                         f"exceed the kernel's {MAX_KW}")
    out = torch.empty(N, dtype=torch.float32, device=dev)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_hmm_forward_meta(
            meta.data_ptr(), packed_ref.data_ptr(), read_tab.data_ptr(),
            ev_pool.data_ptr(), level_mean.data_ptr(),
            level_stdv.data_ptr(), level_log_stdv.data_ptr(),
            CONSTS.ctypes.data, out.data_ptr(), 4 * packed_ref.shape[0],
            level_mean.shape[0], k, int(allow_pre), int(allow_post), N,
            n_narrow, kw_smem, _build.stream_handle(dev))
    _build.check_error(lib, "f5c_hmm_forward_meta", err)
    launches["hmm_forward"] += 1
    return out


def hmm_window_ranks(meta, packed_ref, read_tab, k: int, kw: int):
    """The rank probe: the k-mer ranks the kernel's prologue computes, i32
    [N, kw] as ``hmm_meta.build_inputs`` lays them out (0 past a window's
    k-mers); on the CPU, build_inputs' own.  Not counted as a launch."""
    dev = meta.device
    _check_inputs(meta, packed_ref, read_tab, dev)
    if dev.type == "cpu":
        return build_inputs(meta, packed_ref, read_tab, k=k, kw=kw)[0]
    if dev.type != "cuda":
        raise ValueError(f"hmm_window_ranks: unsupported device {dev}")
    if meta.data_ptr() % 16:
        raise ValueError("hmm_window_ranks: meta is not 16-byte aligned")
    out = torch.empty((meta.shape[0], kw), dtype=torch.int32, device=dev)
    lib = _build.library()
    with _build.device_guard(dev):
        err = lib.f5c_hmm_window_ranks(
            meta.data_ptr(), packed_ref.data_ptr(), read_tab.data_ptr(),
            out.data_ptr(), 4 * packed_ref.shape[0], k, kw, meta.shape[0],
            _build.stream_handle(dev))
    _build.check_error(lib, "f5c_hmm_window_ranks", err)
    return out
