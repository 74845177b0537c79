"""HMM forward wrapper: a CUDA tensor goes to the hand-written kernel of
``csrc/hmm.cu``, a CPU tensor to the plain PyTorch version of
``ops/hmm.py``.  Counterpart of ``f5c_tpu/ops/hmm_pallas.py``.

The wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on torch's current stream and counts the launch in
``launches``.  There is no fallback: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .hmm import CONSTS, hmm_forward_plain

launches = {"hmm_forward": 0}

# widest window row (k-mers) one warp's shared memory holds: 6 f32 arrays
MAX_KW = 232448 // (6 * 4)


def hmm_forward(ranks, n_km, ev_pool, ev_start, stride, n_ev, scale, shift,
                var, lp_stay, lp_step, level_mean, level_stdv,
                level_log_stdv, allow_pre: bool = True,
                allow_post: bool = True):
    """Forward log-likelihood of every window, f32 [N] (inputs as
    ``ops/hmm_meta.build_inputs`` returns them)."""
    dev = ranks.device
    N = ranks.shape[0]
    _build.check_tensor("ranks", ranks, torch.int32, 2, dev)
    _build.check_tensor("ev_pool", ev_pool, torch.float32, 1, dev)
    _build.check_tensor("ev_start", ev_start, torch.int64, 1, dev)
    for name, t in (("n_km", n_km), ("stride", stride), ("n_ev", n_ev)):
        _build.check_tensor(name, t, torch.int32, 1, dev)
    for name, t in (("scale", scale), ("shift", shift), ("var", var),
                    ("lp_stay", lp_stay), ("lp_step", lp_step),
                    ("level_mean", level_mean), ("level_stdv", level_stdv),
                    ("level_log_stdv", level_log_stdv)):
        _build.check_tensor(name, t, torch.float32, 1, dev)
    if any(t.shape[0] != N for t in (n_km, ev_start, stride, n_ev, scale,
                                     shift, var, lp_stay, lp_step)):
        raise ValueError("hmm_forward: per-window arrays disagree on N")
    if not (level_mean.shape == level_stdv.shape == level_log_stdv.shape):
        raise ValueError("hmm_forward: model tables differ in length")
    kw = ranks.shape[1]
    if dev.type == "cpu":
        return hmm_forward_plain(ranks, n_km, ev_pool, ev_start, stride,
                                 n_ev, scale, shift, var, lp_stay, lp_step,
                                 level_mean, level_stdv, level_log_stdv,
                                 allow_pre=allow_pre, allow_post=allow_post)
    if dev.type != "cuda":
        raise ValueError(f"hmm_forward: unsupported device {dev}")
    if kw > MAX_KW:
        raise ValueError(f"hmm_forward: windows of {kw} k-mers exceed the "
                         f"kernel's {MAX_KW}")
    out = torch.empty(N, dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.f5c_hmm_forward(
        ranks.data_ptr(), n_km.data_ptr(), ev_pool.data_ptr(),
        ev_start.data_ptr(), stride.data_ptr(), n_ev.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), var.data_ptr(),
        lp_stay.data_ptr(), lp_step.data_ptr(), level_mean.data_ptr(),
        level_stdv.data_ptr(), level_log_stdv.data_ptr(), CONSTS.ctypes.data,
        out.data_ptr(), kw, level_mean.shape[0], int(allow_pre),
        int(allow_post), N, _build.stream_handle(dev))
    _build.check_error(lib, "f5c_hmm_forward", err)
    launches["hmm_forward"] += 1
    return out
