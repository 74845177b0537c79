"""HMM scorer inputs built from window metadata (K6), and the plain
version of the fused forward kernel.

Counterpart of ``f5c_tpu/ops/hmm_meta.py``: every input of the forward
pass is rebuilt from the batch's 2-bit packed disambiguated reference, a
small per-read scalar table and 16 bytes of metadata per window.  Ranks
are bit-identical to native ``hmm_window_ranks`` (f5chost.cpp; reference
methylate meth.c:362-385 and meth-aware revcomp meth.c:390-423),
including the two window-edge corrections the global rank planes need:

- forward meth window whose last base is a C followed (outside the
  window) by a G: the plane made that C an M; the window-local methylate
  keeps C, so the window's last k-mer rank drops by 2;
- reverse meth window whose first base is a G preceded (outside the
  window) by a C: the plane made that G an M; the window-local revcomp
  complements it, so the first k-mer rank drops by 2.

The packed reference must end in >= 1 zero sentinel byte so the shifted
adds never wrap a window across the buffer end.

On the card none of this runs: csrc/hmm.cu ranks each window's k-mers in
its prologue (csrc/hmm_ranks.cuh, held to ``build_inputs`` bit for bit
through the probe ``hmm_cuda.hmm_window_ranks``), and ``build_inputs`` is
the first half of the plain version ``hmm_forward_meta_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from .hmm import hmm_forward_plain
from .seq_ranks import unpack_codes

META_BYTES = 16

# read_tab column layout (f32): scale shift var lp_stay lp_step rc - -
RT_SCALE, RT_SHIFT, RT_VAR, RT_LP_STAY, RT_LP_STEP, RT_RC = range(6)


def pack_meta(gstart, ev_start, n_ev_signed, wlen, meth, read_id):
    """Host: per-window int arrays -> the (N, 16) u8 meta buffer
    (f5c_tpu/ops/hmm_meta.py:52).  Layout (little-endian i32 words):
    [gstart][ev_start][n_ev * stride][wlen | meth<<15 | read_id<<16]."""
    n = gstart.shape[0]
    w = np.empty((n, 4), np.int32)
    w[:, 0] = gstart
    w[:, 1] = ev_start
    w[:, 2] = n_ev_signed
    w[:, 3] = (wlen.astype(np.int32)
               | (meth.astype(np.int32) << 15)
               | (read_id.astype(np.int32) << 16))
    return w.view(np.uint8)


def _plane_fwd(x, k):
    acc = x * (5 ** (k - 1))
    for j in range(1, k):
        acc = acc + torch.roll(x, -j) * (5 ** (k - 1 - j))
    return acc


def _plane_rev(x, k):
    acc = x.clone()
    for u in range(1, k):
        acc = acc + torch.roll(x, -u) * (5 ** u)
    return acc


def window_fields(meta, k: int) -> dict:
    """The per-window fields of the (N, 16) u8 meta buffer as tensors on
    its device: gstart, ev_start (i64), stride (+1/-1), n_ev, wlen, meth,
    read_id (i64) and n_km = wlen - (k - 1) (<= 0 for an empty window)."""
    w = meta.contiguous().view(torch.int32)          # [N, 4]
    nev_s = w[:, 2]
    w3 = w[:, 3]
    wlen = w3 & 0x7FFF
    return dict(gstart=w[:, 0].long(), ev_start=w[:, 1].long(),
                stride=torch.where(nev_s < 0, -1, 1).to(torch.int32),
                n_ev=nev_s.abs(), wlen=wlen, meth=(w3 >> 15) & 1,
                read_id=((w3 >> 16) & 0xFFFF).long(), n_km=wlen - (k - 1))


def build_inputs(meta, packed_ref, read_tab, k: int, kw: int):
    """Device-side assembly of the forward pass's inputs
    (f5c_tpu/ops/hmm_meta.py:69-154) as torch integer ops.

    meta: u8 [N, 16] (pack_meta); packed_ref: u8 2-bit codes of the
    reference concat; read_tab: f32 [n_reads, 8].  Returns (ranks i32
    [N, kw], n_km i32, ev_start i64, stride i32, n_ev i32, scale, shift,
    var, lp_stay, lp_step), each per-window array of length N."""
    dev = meta.device
    f = window_fields(meta, k)
    gstart, ev_start, stride, n_ev = (f["gstart"], f["ev_start"],
                                      f["stride"], f["n_ev"])
    wlen, meth, read_id, n_km = f["wlen"], f["meth"], f["read_id"], f["n_km"]

    # rank planes over the whole reference concat
    c5 = unpack_codes(packed_ref)
    P = c5.shape[0]
    c5 = c5 + (c5 == 3).to(torch.int32)             # A0 C1 G2 T4
    m5 = torch.where((c5 == 1) & (torch.roll(c5, -1) == 2), 3, c5)
    comp_tab = torch.tensor([4, 2, 1, 0, 0], dtype=torch.int32, device=dev)
    val_u = comp_tab[c5]
    prev_m = torch.roll(m5, 1)
    val_m = torch.where(m5 == 3, 2,
                        torch.where((m5 == 2) & (prev_m == 3), 3,
                                    comp_tab[torch.where(m5 == 3, 0, m5)]))
    planes = torch.cat([_plane_fwd(c5, k), _plane_fwd(m5, k),
                        _plane_rev(val_u, k), _plane_rev(val_m, k)])

    # per-window rank gather + window-edge corrections
    rc = (read_tab[read_id, RT_RC] > 0).long()
    sel = meth.long() + 2 * rc
    ki = torch.arange(kw, device=dev)[None, :]
    pos = (gstart[:, None] + ki).clamp(0, P - 1)
    ranks = planes[sel[:, None] * P + pos]

    def cg(p):
        return c5[p.clamp(0, P - 1)]

    gend = gstart + wlen.long() - 1
    edge_f = (meth == 1) & (rc == 0) & (cg(gend) == 1) & (cg(gend + 1) == 2)
    edge_r = ((meth == 1) & (rc == 1) & (cg(gstart - 1) == 1)
              & (cg(gstart) == 2))
    corr = (torch.where(edge_f[:, None] & (ki == (n_km - 1)[:, None]), 2, 0)
            + torch.where(edge_r[:, None] & (ki == 0), 2, 0))
    ranks = torch.where(ki < n_km[:, None], ranks - corr, 0).to(torch.int32)

    rt = read_tab[read_id]
    return (ranks, n_km.to(torch.int32), ev_start, stride, n_ev,
            rt[:, RT_SCALE].contiguous(), rt[:, RT_SHIFT].contiguous(),
            rt[:, RT_VAR].contiguous(), rt[:, RT_LP_STAY].contiguous(),
            rt[:, RT_LP_STEP].contiguous())


def hmm_forward_meta_plain(meta, packed_ref, read_tab, ev_pool, level_mean,
                           level_stdv, level_log_stdv, k: int,
                           allow_pre: bool = True, allow_post: bool = True):
    """The plain version of the fused HMM kernel (csrc/hmm.cu): the
    forward log-likelihood of every window of ``meta``, f32 [N], as
    ``build_inputs`` (k-mer rows as wide as the widest window) followed by
    ``ops/hmm.py:hmm_forward_plain``."""
    n_km = window_fields(meta, k)["n_km"]
    kw = max(int(n_km.max()), 1) if n_km.numel() else 1
    (ranks, n_km, ev_start, stride, n_ev, scale, shift, var, lp_stay,
     lp_step) = build_inputs(meta, packed_ref, read_tab, k=k, kw=kw)
    return hmm_forward_plain(ranks, n_km, ev_pool, ev_start, stride, n_ev,
                             scale, shift, var, lp_stay, lp_step, level_mean,
                             level_stdv, level_log_stdv, allow_pre=allow_pre,
                             allow_post=allow_post)
