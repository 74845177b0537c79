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

from .. import native
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


# --- Viterbi (eventalign re-alignment, K8) ----------------------------------
#
# The same 3-state-per-k-mer profile HMM in the max-plus semiring, with
# movement tracking for the backtrace (hmm.c:313-533, the
# ProfileHMMViterbiOutputR9 policy; eventalign.c:765 sets no soft clips, so
# the start transition goes only into row 1 and the backtrace starts at
# the last row's MATCH of the last k-mer).  Counterpart of
# ``f5c_tpu/ops/hmm.py:hmm_viterbi_rounds`` (contract) with the arithmetic
# of the port's host DP, ``native.viterbi_chunk``, operation for
# operation: its f32 transition log probabilities and log(var) come from
# ``native.viterbi_params``, and the emission divides by the scaled stdv.
#
# A round of chunks: spec_i32 [N, 6] = rank_start, rank_stride, n_kmers,
# ev_start, ev_stride, n_events (k-mer i's rank at rank_pool[rank_start +
# i*rank_stride], event row r's mean at ev_pool[ev_start +
# (r-1)*ev_stride]); spec_f32 [N, 6] = scale, shift, var, log_var,
# lp_stay, lp_step; the 8 constants of viterbi_consts.
# Output: movements, 3-bit HMT codes in walk order two to a byte (u8 [N,
# max_path/2]), and n_steps i32 [N].

HMT_FROM_SAME_M = 0
HMT_FROM_PREV_M = 1
HMT_FROM_SAME_B = 2
HMT_FROM_PREV_B = 3
HMT_FROM_PREV_K = 4
HMT_FROM_SOFT = 5

# next profile state per movement code: M, M, B, B, K
_NEXT_PS = (2, 2, 1, 1, 0)


def viterbi_consts() -> np.ndarray:
    """f32 [8]: lp_mk, lp_mb, lp_bb, lp_b3, lp_kk, lp_km, pre0,
    LOG_INV_SQRT_2PI, as the host DP forms them (csrc/viterbi.cu reads
    them in this order)."""
    p = native.viterbi_params(2.0, 1.0)  # these do not depend on the read
    return np.array([p[0], p[1], p[4], p[5], p[6], p[7], p[9],
                     LOG_INV_SQRT_2PI], np.float32)


def viterbi_read_params(events_per_base: float, var: float):
    """(log_var, lp_stay, lp_step) f32 of one read, as the host DP forms
    them."""
    p = native.viterbi_params(events_per_base, var)
    return p[8], p[2], p[3]


def viterbi_max_path(n_kmers, n_events) -> int:
    """Movement capacity of a round: a walk takes at most one step per
    event row and one per k-mer (plus the soft start), rounded to even."""
    m = int(np.max(np.asarray(n_kmers) + np.asarray(n_events))) + 2
    return m + (m & 1)


def viterbi_rounds_plain(spec_i32, spec_f32, consts, rank_pool, ev_pool,
                         level_mean, level_stdv, level_log_stdv,
                         max_path: int):
    """Plain PyTorch version of csrc/viterbi.cu: the fill as a loop over
    event rows vectorised over the round's chunks and k-mers (the
    KMER_SKIP chain a ``torch.cummax`` in d-space), each cell's movement
    codes in one byte (MATCH bits 0-2, BAD_EVENT's SAME_B bit 3, KMER_SKIP
    bits 4-6), then the backtraces, vectorised over chunks.  Returns
    (movements u8 [N, max_path//2], n_steps i32 [N])."""
    dev = spec_i32.device
    f32 = torch.float32
    N = spec_i32.shape[0]
    movs = torch.zeros((N, max_path // 2), dtype=torch.uint8, device=dev)
    n_steps = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0:
        return movs, n_steps
    si = spec_i32.long()
    nk, ne = si[:, 2], si[:, 5]
    K, E = int(nk.max()), int(ne.max())
    if K < 1 or E < 1:
        return movs, n_steps
    (lp_mk, lp_mb, lp_bb, lp_b3, lp_kk, lp_km, pre0,
     log_inv) = torch.as_tensor(consts, dtype=f32, device=dev).unbind(0)
    scale, shift, var, log_var, lp_stay, lp_step = (
        spec_f32[:, i, None] for i in range(6))
    cols = torch.arange(K, device=dev)
    in_k = cols[None, :] < nk[:, None]
    r = rank_pool[torch.where(in_k, si[:, :1] + cols[None, :] * si[:, 1:2],
                              0)].long()
    gm = scale * level_mean[r] + shift
    gs = level_stdv[r] * var
    gl = level_log_stdv[r] + log_var
    ig = cols.to(f32) * lp_kk                     # (b-1)*lp_kk, exact f32
    ninf_col = torch.full((N, 1), NEG_INF, dtype=f32, device=dev)
    M = B = Kst = torch.full((N, K + 1), NEG_INF, dtype=f32, device=dev)
    tab = torch.zeros((E, N, K + 1), dtype=torch.uint8, device=dev)
    L = ev_pool.shape[0]
    for row in range(1, E + 1):
        active = (row <= ne)[:, None]
        e = ev_pool[(si[:, 3] + (row - 1) * si[:, 4]).clamp(0, L - 1)]
        a = (e[:, None] - gm) / gs
        em = (log_inv - gl) + (-0.5 * a) * a
        s0 = lp_stay + M[:, 1:]
        s1 = lp_step + M[:, :-1]
        s2 = lp_b3 + B[:, 1:]
        s3 = lp_b3 + B[:, :-1]
        s4 = lp_km + Kst[:, :-1]
        mx = torch.where(s1 > s0, s1, s0)
        mx23 = torch.where(s3 > s2, s3, s2)
        mx = torch.where(mx > mx23, mx, mx23)
        mx = torch.where(s4 > mx, s4, mx)
        frm = torch.zeros((N, K), dtype=torch.uint8, device=dev)
        for code, s in ((1, s1), (2, s2), (3, s3), (4, s4)):
            frm = torch.where(s == mx, code, frm)
        if row == 1:
            # the soft start into k-mer 0: every other candidate is -inf
            # in row 1, so the sequential running max picks pre0
            mx = torch.cat([pre0.expand(N, 1), mx[:, 1:]], dim=1)
            frm[:, 0] = HMT_FROM_SOFT
        m_new = mx + em
        b_m = lp_mb + M[:, 1:]
        b_b = lp_bb + B[:, 1:]
        same_b = b_b >= b_m
        b_new = torch.where(same_b, b_b, b_m)
        m_full = torch.cat([ninf_col, m_new], dim=1)
        b_full = torch.cat([ninf_col, b_new], dim=1)
        incl, kc = skip_chain(lp_mk + m_full[:, :-1], lp_b3 + b_full[:, :-1],
                              ig)
        k_new = ig + incl
        tab[row - 1, :, 1:] = frm | (same_b.to(torch.uint8) << 3) | (kc << 4)
        M = torch.where(active, m_full, M)
        B = torch.where(active, b_full, B)
        Kst = torch.where(active, torch.cat([ninf_col, k_new], dim=1), Kst)
    return _viterbi_backtrace(tab, nk, ne, max_path, movs, n_steps)


def skip_chain(c1, c2, ig):
    """The KMER_SKIP chain of one event row, the cummax form of
    viterbi_rounds_plain: c1, c2 f32 [N, K] the candidates from column
    b-1's MATCH and BAD_EVENT (lp_mk + M, lp_b3 + B), ig f32 [K] the
    offsets (b-1) lp_kk.  K_b = max(c_b, K_{b-1} + lp_kk) is ig + the
    running max of d = max(c1, c2) - ig.  Returns (incl: that running
    max, f32 [N, K]; each column's code u8 [N, K]: PREV_K when the running
    max before the column is >= d, else PREV_B on c2 == c, else
    PREV_M)."""
    c = torch.where(c1 > c2, c1, c2)
    d = c - ig
    incl = torch.cummax(d, dim=1).values
    cp = torch.cat([torch.full_like(d[:, :1], NEG_INF), incl[:, :-1]], dim=1)
    return incl, _skip_codes(cp, d, c2, c)


def _skip_codes(cp, d, c2, c):
    return torch.where(cp >= d, HMT_FROM_PREV_K,
                       torch.where(c2 == c, HMT_FROM_PREV_B,
                                   HMT_FROM_PREV_M)).to(torch.uint8)


def skip_chain_partitioned(c1, c2, ig, group: int, items: int,
                           lanes: str = "shuffle"):
    """Plain model of csrc/viterbi.cu's KMER_SKIP running max: skip_chain
    with the running max taken as a kernel takes it.  Lane l of ``group``
    holds columns l*items .. l*items + items-1 of a tile of group x items
    columns.  ``lanes="carry"`` (viterbi_regs_kernel, whose chunk is one
    tile): lane l receives the running max through lane l-1's last item
    (its i_out, a wavefront step late; -inf for lane 0) and runs it over
    its own items in order.  ``lanes="shuffle"`` (viterbi_tiled_kernel's
    skip_scan, tiles carried from one to the next): each lane takes a
    serial prefix max over its items, the lanes' totals an inclusive scan
    in log2(group) rounds of shfl_up (a lane below the offset keeps its
    value), and the exclusive value -- the carry for lane 0, else
    max(carry, lane l-1's inclusive total) -- is combined back into each
    item.  Every max is the select ``a > b ? a : b`` with its operands in
    the kernel's order (the kernels take it with fmaxf: the same value,
    their operands being never -0 or NaN).  Returns what skip_chain
    returns."""
    def sel(a, b):
        return torch.where(a > b, a, b)

    c = torch.where(c1 > c2, c1, c2)
    d = c - ig
    N, K = d.shape
    tw = group * items
    if lanes == "carry" and K > tw:
        raise ValueError("skip_chain_partitioned: the register kernel "
                         "holds at most group x items columns")
    lane_ids = torch.arange(group, device=d.device)[None, :]
    incl = torch.empty_like(d)
    cp = torch.empty_like(d)
    carry = torch.full((N,), NEG_INF, dtype=d.dtype, device=d.device)
    for t0 in range(0, K, tw):
        n = min(tw, K - t0)
        x = torch.full((N, tw), NEG_INF, dtype=d.dtype, device=d.device)
        x[:, :n] = d[:, t0:t0 + n]
        x = x.view(N, group, items)
        if lanes == "carry":
            run = carry                 # lane 0's: column 0 is -inf
            inc, before = [], []
            for lane in range(group):   # run = lane l-1's i_out
                for j in range(items):
                    before.append(run)
                    run = sel(run, x[:, lane, j])
                    inc.append(run)
            inc, before = torch.stack(inc, 1), torch.stack(before, 1)
        else:
            lp = [x[:, :, 0]]
            for j in range(1, items):
                lp.append(sel(lp[-1], x[:, :, j]))
            t = lp[-1]
            off = 1
            while off < group:
                up = torch.cat([t[:, :off], t[:, :-off]], dim=1)
                t = torch.where(lane_ids >= off, sel(up, t), t)
                off *= 2
            up = torch.cat([t[:, :1], t[:, :-1]], dim=1)
            ex = torch.where(lane_ids == 0, carry[:, None],
                             sel(carry[:, None], up))
            inc = torch.stack([sel(ex, v) for v in lp], dim=2)
            before = torch.stack([ex] + [sel(ex, v) for v in lp[:-1]], dim=2)
            carry = sel(carry, t[:, -1])
        incl[:, t0:t0 + n] = inc.reshape(N, tw)[:, :n]
        cp[:, t0:t0 + n] = before.reshape(N, tw)[:, :n]
    return incl, _skip_codes(cp, d, c2, c)


def _viterbi_backtrace(tab, nk, ne, max_path: int, movs, n_steps):
    """The backtraces of viterbi_rounds_plain, vectorised over chunks."""
    dev = tab.device
    N = nk.shape[0]
    next_ps = torch.tensor(_NEXT_PS + (0,), device=dev)
    idx = torch.arange(N, device=dev)
    row, blk = ne.clone(), nk.clone()
    ps = torch.full((N,), 2, dtype=torch.long, device=dev)
    live = (row > 0) & (blk > 0)
    out = torch.zeros((N, max_path), dtype=torch.long, device=dev)
    n = torch.zeros(N, dtype=torch.long, device=dev)
    for step in range(max_path):
        if not bool(live.any()):
            break
        code = tab[(row - 1).clamp(min=0), idx, blk.clamp(min=0)].long()
        mv = torch.where(ps == 2, code & 7,
                         torch.where(ps == 1,
                                     torch.where((code & 8) != 0,
                                                 HMT_FROM_SAME_B,
                                                 HMT_FROM_SAME_M),
                                     (code >> 4) & 7))
        out[:, step] = torch.where(live, mv, 0)
        n = n + live.long()
        dec_k = ((mv == HMT_FROM_PREV_M) | (mv == HMT_FROM_PREV_B)
                 | (mv == HMT_FROM_PREV_K))
        go = live & (mv != HMT_FROM_SOFT)
        row = torch.where(go & (ps != 0), row - 1, row)
        blk = torch.where(go, blk - dec_k.long(), blk)
        ps = torch.where(go, next_ps[mv.clamp(0, 5)], ps)
        live = go & (row > 0) & (blk >= 0)
    m2 = out.reshape(N, max_path // 2, 2)
    movs[:] = (m2[..., 0] | (m2[..., 1] << 3)).to(torch.uint8)
    n_steps[:] = n.to(torch.int32)
    return movs, n_steps


def unpack_movements(packed_row: np.ndarray, n_steps: int) -> np.ndarray:
    """Host-side unpack of the 2-per-byte movements of one chunk."""
    b = packed_row[: (n_steps + 1) // 2]
    out = np.empty(2 * b.shape[0], dtype=np.uint8)
    out[0::2] = b & 7
    out[1::2] = b >> 3
    return out[:n_steps]


def decode_viterbi_movements(movs: np.ndarray, n_steps: int, e_start: int,
                             event_stride: int, n_events: int,
                             n_kmers: int):
    """Reconstruct the reference's HMMAlignmentState list from the walk.

    Returns (event_idx, kmer_idx, state u8 0=K/1=B/2=M) arrays in FORWARD
    path order (the walk is reversed, eventalign.c:905).  Vectorised.
    """
    if n_steps == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.uint8)
    mv = movs[:n_steps].astype(np.int64)
    next_ps = np.array(_NEXT_PS + (0,), dtype=np.int64)
    # state at step i: ps_0 = M; ps_{i+1} = next_ps[mv_i]
    ps = np.empty(n_steps, dtype=np.int64)
    ps[0] = 2
    ps[1:] = next_ps[mv[:-1]]
    dec_k = ((mv == HMT_FROM_PREV_M) | (mv == HMT_FROM_PREV_B)
             | (mv == HMT_FROM_PREV_K)).astype(np.int64)
    kmer_idx = (n_kmers - 1) - (np.cumsum(dec_k) - dec_k)
    # row decrements when the visited state is not KMER_SKIP (silent)
    dec_r = (ps != 0).astype(np.int64)
    row = n_events - (np.cumsum(dec_r) - dec_r)
    event_idx = e_start + (row - 1) * event_stride
    return (event_idx[::-1].copy(), kmer_idx[::-1].copy(),
            ps[::-1].astype(np.uint8))
