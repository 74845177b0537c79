"""Seeded synthetic inputs for the kernel checks (tests and chip_smoke.py).

Reads are random sequences with events drawn from the model along an
even walk over their k-mers plus noise (the construction of
``__graft_entry__.entry``); a read listed in ``unrelated`` gets events
that do not follow its sequence, so its alignment fails QC.  HMM windows
are random CpG-model windows of given widths with events drawn near
their k-mers' levels.  Everything is NumPy, made from the caller's
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

from .ops.abea import band_offsets, byte_offsets, ragged_offsets, read_params
from .ops.hmm import transition_params


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
