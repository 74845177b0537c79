"""Seeded synthetic inputs for the kernel checks (tests and chip_smoke.py).

Reads are random sequences with events drawn from the model along an
even walk over their k-mers plus noise (the construction of
``__graft_entry__.entry``); a read listed in ``unrelated`` gets events
that do not follow its sequence, so its alignment fails QC.  HMM windows
are random CpG-model windows of given widths with events drawn near
their k-mers' levels, as rank rows (``hmm_windows``) or as the fused
kernel's inputs (``hmm_meta_windows``: window metadata over a packed
reference).  Everything is made from the caller's
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.abea import band_offsets, byte_offsets, ragged_offsets, read_params
from .ops.hmm import transition_params
from .ops.hmm_cuda import order_windows
from .ops.hmm_meta import (RT_LP_STAY, RT_LP_STEP, RT_RC, RT_SCALE, RT_SHIFT,
                           RT_VAR, build_inputs, pack_meta)
from .ops.seq_ranks import pack_codes, seq_codes


def random_seq(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def abea_reads(rng, n_kmers, model, events_per_kmer=1.7, noise=1.0,
               unrelated=()):
    """(seqs, events): one read per entry of ``n_kmers``."""
    seqs, events = [], []
    for i, nk in enumerate(n_kmers):
        seq = random_seq(rng, nk + model.k - 1)
        ne = max(int(nk * events_per_kmer), 1)
        if i in unrelated:
            ev = rng.normal(90.0, 20.0, ne)
        else:
            kr = model.kmer_ranks(seq)
            which = np.floor(np.linspace(0, nk, ne, endpoint=False))
            ev = model.level_mean[kr[which.astype(np.int64)]] + rng.normal(
                0.0, noise, ne)
        seqs.append(seq)
        events.append(ev.astype(np.float32))
    return seqs, events


def abea_inputs(seqs, events, model, scale=None, shift=None) -> dict:
    """The ragged ABEA layout of ops/abea.py as NumPy arrays, ranks from
    the model's NumPy ranker."""
    B = len(seqs)
    ev_len = np.array([e.shape[0] for e in events], np.int32)
    ranks = [model.kmer_ranks(s).astype(np.int32) for s in seqs]
    rk_len = np.array([r.shape[0] for r in ranks], np.int32)
    scale = np.ones(B, np.float32) if scale is None else scale
    shift = np.zeros(B, np.float32) if shift is None else shift
    band_off = band_offsets(ev_len, rk_len)
    byte_off = byte_offsets(ev_len, rk_len)
    return dict(
        ev_pool=np.concatenate(events).astype(np.float32),
        ev_off=ragged_offsets(ev_len)[:-1], ev_len=ev_len,
        rk_pool=np.concatenate(ranks), rk_off=ragged_offsets(rk_len)[:-1],
        rk_len=rk_len, level_mean=model.level_mean,
        level_stdv=model.level_stdv, level_log_stdv=model.level_log_stdv,
        params=read_params(ev_len, rk_len, scale, shift),
        band_off=band_off, byte_off=byte_off,
        n_bands=int(band_off[-1]), n_bytes=int(byte_off[-1]))


def hmm_windows(rng, n_kmers, model, kw=None) -> dict:
    """HMM forward inputs (the layout of ops/hmm_meta.build_inputs) for
    windows of ``n_kmers`` k-mers: events near the window's levels, half
    of the windows read backwards through the event pool."""
    N = len(n_kmers)
    kw = kw or max(32, -(-max(n_kmers) // 32) * 32)
    ranks = np.zeros((N, kw), np.int32)
    pool, ev_start, stride, n_ev = [], [], [], []
    pos = 0
    for i, nk in enumerate(n_kmers):
        r = rng.integers(0, model.num_kmers, nk)
        ranks[i, :nk] = r
        ne = int(rng.integers(max(nk // 2, 1), 2 * nk + 2))
        which = np.sort(rng.integers(0, nk, ne))
        ev = model.level_mean[r[which]] + rng.normal(0.0, 1.5, ne)
        st = 1 if i % 2 == 0 else -1
        pool.append(ev if st == 1 else ev[::-1])
        ev_start.append(pos if st == 1 else pos + ne - 1)
        stride.append(st)
        n_ev.append(ne)
        pos += ne
    epb = rng.uniform(1.3, 2.5, N)
    lp_stay, lp_step = transition_params(epb)
    return dict(
        ranks=ranks, n_km=np.asarray(n_kmers, np.int32),
        ev_pool=np.concatenate(pool).astype(np.float32),
        ev_start=np.asarray(ev_start, np.int64),
        stride=np.asarray(stride, np.int32), n_ev=np.asarray(n_ev, np.int32),
        scale=rng.uniform(0.9, 1.1, N).astype(np.float32),
        shift=rng.uniform(-2.0, 2.0, N).astype(np.float32),
        var=rng.uniform(1.0, 1.6, N).astype(np.float32),
        lp_stay=lp_stay, lp_step=lp_step, level_mean=model.level_mean,
        level_stdv=model.level_stdv, level_log_stdv=model.level_log_stdv)


def _cpg_seq(rng, n: int) -> bytearray:
    """Random bases with a CpG planted at about every eighth position."""
    seq = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes())
    for p in rng.integers(0, max(n - 1, 1), n // 8):
        seq[p:p + 2] = b"CG"[:n - p]
    return seq


def hmm_meta_windows(rng, n_kmers, model, ordered: bool = True) -> dict:
    """Fused HMM kernel inputs (``ops/hmm_cuda.hmm_forward_meta``) for
    windows of ``n_kmers`` k-mers (<= 0: an empty window): each window
    its own stretch of a random CpG-rich reference concat, the first at
    the concat's start and the last at its end (before the zero
    sentinel), with a C-then-G across its right edge or a C before its
    first base G half of the time; reads of both strands, windows of both
    ``meth`` values; events near the window's levels, half of them read
    backwards through the pool.  With ``ordered``, the windows come in
    the kernel's launch order (``hmm_cuda.order_windows``).  Returns the
    wrapper's arguments by name, with n_km, n_ev, n_narrow and max_km."""
    k = model.k
    n_kmers = np.asarray(n_kmers, np.int64)
    N = n_kmers.shape[0]
    wlen = np.maximum(n_kmers + k - 1, 0)
    ref, gstart = bytearray(), np.zeros(N, np.int64)
    for i, wl in enumerate(wlen):
        left = 0 if i == 0 else 2
        right = 0 if i == N - 1 else 2
        seg = _cpg_seq(rng, left + int(wl) + right)
        if wl and right and rng.random() < 0.5:
            seg[left + wl - 1:left + wl + 1] = b"CG"
        if wl and left and rng.random() < 0.5:
            seg[left - 1:left + 1] = b"CG"
        gstart[i] = len(ref) + left
        ref += seg
    packed = pack_codes(seq_codes(bytes(ref) + b"\0" * 8))

    n_reads = max(N // 4, 1)
    read_id = np.arange(N) % n_reads
    epb = rng.uniform(1.3, 2.5, n_reads)
    read_tab = np.zeros((n_reads, 8), np.float32)
    read_tab[:, RT_SCALE] = rng.uniform(0.9, 1.1, n_reads)
    read_tab[:, RT_SHIFT] = rng.uniform(-2.0, 2.0, n_reads)
    read_tab[:, RT_VAR] = rng.uniform(1.0, 1.6, n_reads)
    read_tab[:, RT_LP_STAY], read_tab[:, RT_LP_STEP] = transition_params(epb)
    read_tab[:, RT_RC] = np.arange(n_reads) % 2
    meth = rng.integers(0, 2, N)

    # the ranks (events follow them), from the plain input assembly
    probe = pack_meta(gstart, np.zeros(N), np.ones(N), wlen, meth, read_id)
    ranks = build_inputs(torch.from_numpy(probe), torch.from_numpy(packed),
                         torch.from_numpy(read_tab), k=k,
                         kw=max(int(n_kmers.max()), 1))[0].numpy()
    pool, ev_start, n_ev = [], np.zeros(N, np.int64), np.zeros(N, np.int64)
    pos = 0
    for i, nk in enumerate(n_kmers):
        ne = int(rng.integers(max(nk // 2, 1), 2 * max(nk, 1) + 2))
        which = np.sort(rng.integers(0, max(nk, 1), ne))
        rt = read_tab[read_id[i]]
        ev = (rt[RT_SCALE] * model.level_mean[ranks[i, which]]
              + rt[RT_SHIFT] + rng.normal(0.0, 1.5, ne))
        fwd = i % 2 == 0
        pool.append(ev if fwd else ev[::-1])
        ev_start[i] = pos if fwd else pos + ne - 1
        n_ev[i] = ne if fwd else -ne
        pos += ne
    x = dict(meta=pack_meta(gstart, ev_start, n_ev, wlen, meth, read_id),
             n_km=n_kmers, n_ev=np.abs(n_ev))
    n_narrow = 0
    if ordered:
        order, n_narrow = order_windows(n_kmers, np.abs(n_ev))
        x = {key: v[order] for key, v in x.items()}
    return dict(x, packed_ref=packed, read_tab=read_tab,
                ev_pool=np.concatenate(pool).astype(np.float32),
                level_mean=model.level_mean, level_stdv=model.level_stdv,
                level_log_stdv=model.level_log_stdv, k=k, n_narrow=n_narrow,
                max_km=int(n_kmers.max()))


def rank_cases(rng, k: int) -> list[dict]:
    """Window batches for the rank probe (``hmm_cuda.hmm_window_ranks``
    against ``hmm_meta.build_inputs``): the cases of
    tests/test_torch_ranks.py -- window edges on forward and reverse
    reads, a C then a G across a read boundary (both strands), random
    windows -- and windows at both ends of the concat, with the zero
    sentinel and without it (where the rank planes wrap).  Each batch:
    meta, packed_ref, read_tab and kw (its widest window's k-mers)."""

    def case(refs, items, read_rc, sentinel=True):
        off = np.concatenate([[0], np.cumsum([len(r) for r in refs])[:-1]])
        rd, ss, se, meth = (np.array(c, np.int64) for c in zip(*items))
        wlen = se - ss + 1
        read_tab = np.zeros((len(read_rc), 8), np.float32)
        read_tab[:, RT_RC] = read_rc
        n = len(items)
        codes = seq_codes(b"".join(refs) + (b"\0" * 8 if sentinel else b""))
        return dict(meta=pack_meta(off[rd] + ss, np.zeros(n), np.ones(n),
                                   wlen, meth, rd),
                    packed_ref=pack_codes(codes), read_tab=read_tab,
                    kw=int(wlen.max()) - k + 1)

    edges = [b"AACGTACGTTTCGGATTCG", b"GGTACGTACCGTAAACGTA"]
    cross = [b"ATTACGTACATTACCTAGC", b"GATTACAGGATCCGATTAC"]
    cases = [case(edges, [(0, 8, 17, 1), (0, 8, 17, 0), (0, 8, 18, 1),
                          (1, 10, 18, 1), (1, 10, 18, 0), (1, 2, 12, 1),
                          (0, 6, 17, 1)], [0, 1])]
    for rc in ([0, 0], [1, 1]):
        cases.append(case(cross, [(0, 7, 18, 1), (0, 7, 18, 0),
                                  (1, 0, 11, 1), (1, 0, 11, 0)], rc))
    refs = [bytes(_cpg_seq(rng, int(rng.integers(60, 120))))
            for _ in range(3)]
    items = []
    for _ in range(24):
        rd = int(rng.integers(0, 3))
        L = len(refs[rd])
        ss = int(rng.integers(0, L - k - 2))
        se = int(rng.integers(ss + k - 1, min(ss + 37, L - 1)))
        items.append((rd, ss, se, int(rng.integers(0, 2))))
    cases.append(case(refs, items, [0, 1, 1]))
    ends = [b"GCGTACGATTCGCG", b"ATCGGCATTACG", b"CGATTCGACGTAGC"]
    items = [(0, 0, 11, m) for m in (0, 1)] + [(2, 2, 13, m) for m in (0, 1)]
    items += [(1, 0, 11, 1), (2, 0, 13, 1)]
    for sentinel in (True, False):
        for rc in ([0, 0, 0], [1, 1, 1]):
            cases.append(case(ends, items, rc, sentinel))
    return cases


def event_signals(rng, model, rna_model=None) -> dict:
    """pA signals for the event detector's checks: {"dna": [...], "rna":
    [...]}.  DNA: simulated reads of a few lengths (k-mers dwelling 6-12
    samples), one signal of tiny values, whose prefix sums round (so a
    parallel scan must fall back to sample order), and the densest
    pattern found for the detector (a 15-sample motif repeated: about one
    event every three samples; no signal was found that gives more).
    RNA (with ``rna_model``): a transcript's k-mers emitted 3' to 5', as
    tests/test_rna.py builds it."""
    dna = []
    for n in (40, 700, 3000, 12000):
        seq = random_seq(rng, n + model.k - 1)
        ranks = model.kmer_ranks(seq)
        dwell = rng.integers(6, 13, ranks.shape[0])
        mean = np.repeat(model.level_mean[ranks].astype(np.float64), dwell)
        dna.append(rng.normal(mean, 1.2).astype(np.float32))
    dna.append((rng.normal(0.0, 1.0, 20000) * 1e-3).astype(np.float32))
    motif = np.array([81.2, 0.27, 116.51, 188.76, 195.11, 37.82, 109.5,
                      31.15, 195.98, 164.45, 100.73, 74.41, 68.34, 138.61,
                      16.56], np.float32)
    dna.append(np.tile(motif, 1100) + rng.normal(0, 0.01, 16500).astype(
        np.float32))
    dna += [rng.uniform(60, 120, n).astype(np.float32) for n in (1, 5, 11)]
    out = {"dna": dna, "rna": []}
    if rna_model is not None:
        seq = random_seq(rng, 400)
        levels = rna_model.level_mean[rna_model.kmer_ranks(seq)[::-1]]
        sig = np.repeat(levels, rng.integers(6, 14, levels.shape[0]))
        out["rna"].append((sig + rng.normal(0, 1.0, sig.shape[0])).astype(
            np.float32))
    return out


def viterbi_round(rng, model, n_chunks: int, n_ref=(12, 105),
                  events_per_kmer=(0.5, 2.0)) -> dict:
    """One lockstep round of eventalign chunks (layout: ops/hmm.py): each
    chunk a random window of ``n_ref`` bases (a range) whose events
    follow its k-mers with noise, its ranks forward or backward in the
    rank pool and its events read with stride +1 or -1.  Returns the
    pools, both specs and, per chunk, the arguments of
    ``native.viterbi_chunk``."""
    from .ops.hmm import viterbi_read_params

    rk_parts, ev_parts, chunks = [], [], []
    spec_i32 = np.zeros((n_chunks, 6), np.int32)
    spec_f32 = np.zeros((n_chunks, 6), np.float32)
    rk_off = ev_off = 0
    for i in range(n_chunks):
        seq = random_seq(rng, int(rng.integers(n_ref[0], n_ref[1] + 1)))
        ranks = model.kmer_ranks(seq).astype(np.int32)
        n_k = ranks.shape[0]
        epk = rng.uniform(*events_per_kmer)
        n_ev = max(int(n_k * epk), 2)
        which = np.sort(rng.integers(0, n_k, n_ev))
        means = (model.level_mean[ranks[which]]
                 + rng.normal(0, 1.0, n_ev)).astype(np.float32)
        pool = rng.uniform(60, 120, n_ev + 40).astype(np.float32)
        stride = int(rng.choice([1, -1]))
        if stride == 1:
            e0 = 20
            pool[e0:e0 + n_ev] = means
        else:
            pool[20:20 + n_ev] = means[::-1]
            e0 = 20 + n_ev - 1
        r_stride = int(rng.choice([1, -1]))
        if r_stride == 1:
            rk_parts.append(ranks)
            r0 = 0
        else:
            rk_parts.append(ranks[::-1].copy())
            r0 = n_k - 1
        scale = float(rng.uniform(0.95, 1.05))
        shift = float(rng.uniform(-1, 1))
        var = float(rng.uniform(0.9, 1.3))
        epb = float(rng.uniform(1.3, 3.0))
        spec_i32[i] = (rk_off + r0, r_stride, n_k, ev_off + e0, stride,
                       n_ev)
        spec_f32[i] = (scale, shift, var, *viterbi_read_params(epb, var))
        chunks.append(dict(ranks=rk_parts[-1], rank_start=r0,
                           rank_stride=r_stride, n_kmers=n_k, ev_pool=pool,
                           e_start=e0, stride=stride, n_events=n_ev,
                           scale=scale, shift=shift, var=var,
                           events_per_base=epb))
        ev_parts.append(pool)
        rk_off += n_k
        ev_off += pool.shape[0]
    return dict(rank_pool=np.concatenate(rk_parts).astype(np.int32),
                ev_pool=np.concatenate(ev_parts).astype(np.float32),
                spec_i32=spec_i32, spec_f32=spec_f32, chunks=chunks)
