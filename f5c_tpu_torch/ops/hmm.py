"""CpG profile-HMM forward pass: constants and the plain PyTorch version.

Counterpart of ``f5c_tpu/ops/hmm.py`` (``hmm_forward_packed`` /
``_forward_single``) and of the Pallas scorer
``f5c_tpu/ops/hmm_pallas.py:_hmm_kernel``.  Algorithm reference:
hmm.c:115-335.

Windows are rows of a [N, KW] rank matrix, any width: one code path
covers what the JAX package splits into 32- and 128-k-mer Pallas rows and
the XLA scan for wider windows.  The fused kernel's plain version,
``ops/hmm_meta.hmm_forward_meta_plain``, builds that matrix from window
metadata and runs ``hmm_forward_plain`` on it.  Per window: ``n_km``
k-mers, ``n_ev`` events read from the event slab at ``ev_start +
stride*i`` (stride +1 or -1), the calibrated ``scale``/``shift``/``var``
and the transition log probabilities ``lp_stay``/``lp_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (HMM_BACKGROUND_EMISSION, HMM_P_BAD, HMM_P_SKIP,
                         HMM_P_SKIP_SELF, TRANS_CLIP_SELF,
                         TRANS_START_TO_CLIP)

# f5c_tpu/ops/hmm.py:42-52
_LP_SC = float(np.log(TRANS_START_TO_CLIP))
_LP_NSC = float(np.log(1 - TRANS_START_TO_CLIP))
_LP_CS = float(np.log(TRANS_CLIP_SELF))
_LP_NCS = float(np.log(1 - TRANS_CLIP_SELF))
_BG = HMM_BACKGROUND_EMISSION
_LP_MK = float(np.log(HMM_P_SKIP))
_LP_MB = float(np.log(HMM_P_BAD))
_LP_KK = float(np.log(HMM_P_SKIP_SELF))
_LP_KM = float(np.log(1 - HMM_P_SKIP_SELF))
_LP_B3 = float(np.log((1.0 - HMM_P_BAD) / 3))  # bk / bm_next / bm_self
_LP_BB = float(np.log(HMM_P_BAD))

LOG_INV_SQRT_2PI = float(np.float32(-0.918938))
NEG_INF = float("-inf")

# The kernel's f32 scores agree with this plain version's (float64) to
# |a - b| <= RTOL*|b| + ATOL.  The kernel rounds each step's ex2/lg2.approx
# results (~2^-22 each) and its f32 states (kept near zero by a per-step
# offset) and reassociates the KMER_SKIP chain (a running-max scan); the
# error grows about linearly over a window's steps: on an H100, 1.4e-4
# nats on the golden windows and 0.066 on a 5,000-k-mer window scoring
# about -16,000 (4e-6 relative; chip_smoke.py).  The JAX package's f32
# scorers lie within the same bound of this version at their widths.  It
# is still 20x tighter than f5c's output tolerance 0.1|t| + 0.02.
RTOL = 1e-5
ATOL = 1e-3

# the f32 constants of the recurrence, in the order csrc/hmm.cu reads them
# (the flank terms as the reference forms them: f32 of the f64 sums)
CONSTS = np.array([_LP_MK, _LP_MB, _LP_KK, _LP_KM, _LP_B3, _LP_BB, _LP_NSC,
                   _LP_SC + _BG + _LP_NCS, _LP_CS + _BG], np.float32)
(LP_MK, LP_MB, LP_KK, LP_KM, LP_B3, LP_BB, LP_NSC, PRE_A,
 PRE_B) = (float(x) for x in CONSTS)


def transition_params(read_epb: np.ndarray):
    """Per-read (lp_stay, lp_step) f32 from events per base, as the JAX
    runner forms them (runner.py:1963-1969)."""
    p_stay = 1.0 - 1.0 / read_epb.astype(np.float64)
    lp_stay = np.log(p_stay).astype(np.float32)
    lp_step = np.log(1.0 - p_stay - HMM_P_SKIP - HMM_P_BAD).astype(
        np.float32)
    return lp_stay, lp_step


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(-torch.abs(a - b)))
    return torch.where(torch.isneginf(m), NEG_INF, out)


def _shift_prev(x):
    return torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)


def _pre_flank(i: int) -> float:
    """f32 pre-flank soft-clip term of event step i (hmm.py:_pre_flank)."""
    f = np.float32
    return float(f(PRE_A) + (f(i) - f(1)) * f(PRE_B)) if i else LP_NSC


def hmm_forward_plain(ranks, n_km, ev_pool, ev_start, stride, n_ev, scale,
                      shift, var, lp_stay, lp_step, level_mean, level_stdv,
                      level_log_stdv, allow_pre: bool = True,
                      allow_post: bool = True):
    """Forward log-likelihood per window, [N] in the float type of
    ``scale``: a loop over event steps, vectorised over windows and
    k-mers; the KMER_SKIP chain is ``torch.logcumsumexp`` (as
    hmm._logcumsumexp_chain).  The recurrence runs in float64 (the f32
    constants and flank terms as the reference forms them), so that this
    version is the exact yardstick of the f32 kernel: in f32 the states of
    a wide window's far k-mers lie thousands of nats below the best
    state, and their rounding adds up over the steps (on a 5,000-k-mer
    window, f32 runs of this same code differ from float64 by about the
    tolerance below)."""
    dev = ranks.device
    N, KW = ranks.shape
    dt = scale.dtype
    f64 = torch.float64
    (ev_pool, scale, shift, var, lp_stay, lp_step, level_mean, level_stdv,
     level_log_stdv) = (t.to(f64) for t in (
         ev_pool, scale, shift, var, lp_stay, lp_step, level_mean,
         level_stdv, level_log_stdv))
    n_model = level_mean.shape[0]
    r = ranks.long().clamp(0, n_model - 1)
    gp_mean = scale[:, None] * level_mean[r] + shift[:, None]
    gp_inv = 1.0 / (level_stdv[r] * var[:, None])
    gp_log = level_log_stdv[r] + torch.log(var)[:, None]
    kidx = torch.arange(KW, device=dev)
    kf = kidx.to(f64)[None, :]
    in_window = kidx[None, :] < n_km[:, None]
    last = (n_km - 1).clamp(min=0).long()[:, None]
    n_ev_f = n_ev.float()
    ninf = torch.full((N, KW), NEG_INF, dtype=f64, device=dev)
    M, B, K = ninf, ninf, ninf
    lp_end = torch.full((N,), NEG_INF, dtype=f64, device=dev)
    L = ev_pool.shape[0]
    steps = int(n_ev.max()) if N else 0
    for i in range(steps):
        e = ev_pool[(ev_start + i * stride.long()).clamp(0, L - 1)]
        a = (e[:, None] - gp_mean) * gp_inv
        lp_em = (LOG_INV_SQRT_2PI - gp_log) + (-0.5 * a) * a

        t = torch.stack([lp_stay[:, None] + M,
                         lp_step[:, None] + _shift_prev(M),
                         LP_B3 + B, LP_B3 + _shift_prev(B),
                         LP_KM + _shift_prev(K)])
        mx = torch.maximum(torch.maximum(torch.maximum(t[0], t[1]),
                                         torch.maximum(t[2], t[3])), t[4])
        mx_s = torch.where(torch.isneginf(mx), 0.0, mx)
        ex = torch.exp(t - mx_s)
        ssum = (((ex[0] + ex[1]) + ex[2]) + ex[3]) + ex[4]
        m_new = torch.where(torch.isneginf(mx), NEG_INF,
                            mx_s + torch.log(ssum))
        if allow_pre or i == 0:
            pre = torch.tensor(_pre_flank(i), dtype=f64, device=dev)
            m_new = torch.cat([_logaddexp(m_new[:, :1], pre), m_new[:, 1:]],
                              dim=1)
        m_new = m_new + lp_em
        b_new = _logaddexp(LP_MB + M, LP_BB + B)

        c = _logaddexp(LP_MK + _shift_prev(m_new), LP_B3 + _shift_prev(b_new))
        c = torch.where(in_window, c, NEG_INF)
        p = torch.logcumsumexp(c - kf * LP_KK, dim=1)
        k_new = torch.where(torch.isneginf(p), NEG_INF, kf * LP_KK + p)

        active = (i < n_ev)[:, None]
        M = torch.where(active, m_new, M)
        B = torch.where(active, b_new, B)
        K = torch.where(active, k_new, K)

        # post-flank: LP_NSC at the window's last event, else geometric
        pf = torch.where(i == n_ev - 1, LP_NSC,
                         PRE_A + ((n_ev_f - 2.0) - float(i)) * PRE_B)
        end = (_logaddexp(_logaddexp(M.gather(1, last), B.gather(1, last)),
                          K.gather(1, last))[:, 0] + pf)
        do_end = (i < n_ev) & (n_km > 0)
        if not allow_post:
            do_end &= i == n_ev - 1
        lp_end = torch.where(do_end, _logaddexp(lp_end, end), lp_end)
    return lp_end.to(dt)
