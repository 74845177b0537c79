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

import os
from types import SimpleNamespace

import numpy as np
import torch

from .ops.abea import (PAD, band_offsets, byte_offsets, pack_trace,
                       ragged_offsets, read_params)
from .ops.hmm import transition_params
from .ops.hmm_cuda import order_windows
from .ops.hmm_meta import (RT_LP_STAY, RT_LP_STEP, RT_RC, RT_SCALE, RT_SHIFT,
                           RT_VAR, build_inputs, pack_meta)
from .ops.seq_ranks import pack_codes, pack_seqs, seq_codes


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
    """The ragged ABEA layout of ops/abea.py as NumPy arrays: ranks from
    the model's NumPy ranker (``rk_pool``, ``rk_off``) for the plain
    fills, and the sequences 2-bit packed (``seq_packed``, ``seq_off``:
    ``pack_seqs``) with the model's ``k`` for the kernel wrappers."""
    B = len(seqs)
    ev_len = np.array([e.shape[0] for e in events], np.int32)
    ranks = [model.kmer_ranks(s).astype(np.int32) for s in seqs]
    rk_len = np.array([r.shape[0] for r in ranks], np.int32)
    scale = np.ones(B, np.float32) if scale is None else scale
    shift = np.zeros(B, np.float32) if shift is None else shift
    band_off = band_offsets(ev_len, rk_len)
    byte_off = byte_offsets(ev_len, rk_len)
    seq_packed, seq_off = pack_seqs(seqs)
    return dict(
        ev_pool=np.concatenate(events).astype(np.float32),
        ev_off=ragged_offsets(ev_len)[:-1], ev_len=ev_len,
        rk_pool=np.concatenate(ranks), rk_off=ragged_offsets(rk_len)[:-1],
        seq_packed=seq_packed, seq_off=seq_off, k=model.k,
        rk_len=rk_len, level_mean=model.level_mean,
        level_stdv=model.level_stdv, level_log_stdv=model.level_log_stdv,
        params=read_params(ev_len, rk_len, scale, shift),
        band_off=band_off, byte_off=byte_off,
        n_bands=int(band_off[-1]), n_bytes=int(byte_off[-1]))


def _random_rows(rng, n: int):
    """n trace rows of random directions (0, 1, 2: a walk always
    descends) and llk that moves by 0 or 1 a band, as a fill's does."""
    llk = np.cumsum(rng.random(n) < 0.5) - 51 + int(rng.integers(-3, 3))
    dirs = rng.choice(3, size=(n, PAD), p=[0.4, 0.3, 0.3]).astype(np.uint8)
    return dirs, llk.astype(np.int32)


def walk_cases(rng, n_bands) -> dict:
    """Unchunked walk inputs over random traces (``ops/abea.py`` layout,
    NumPy): a read of each band count in ``n_bands``, started at a
    random event (one in ten, and the last, at -1: no walk).  Its paths wander off the
    band, where a fill's never go (the tiled walk's cell-by-cell chase)."""
    nbs = np.asarray(n_bands, np.int64)
    rows = [_random_rows(rng, int(nb)) for nb in nbs]
    rk_len = np.array([max(1, int(nb * rng.uniform(0.2, 0.6)))
                       for nb in nbs], np.int32)
    ev_len = (nbs - rk_len - 2).astype(np.int32)
    start_e = np.array([rng.integers(0, max(1, ne)) for ne in ev_len],
                       np.int32)
    start_e[rng.random(nbs.shape[0]) < 0.1] = -1
    start_e[-1] = -1
    byte_off = byte_offsets(ev_len, rk_len)
    return dict(
        trace=pack_trace(torch.as_tensor(np.concatenate([d for d, _ in rows])
                                         )).numpy(),
        llk=np.concatenate([lk for _, lk in rows]),
        band_off=band_offsets(ev_len, rk_len), start_e=start_e,
        rk_len=rk_len, byte_off=byte_off, n_bytes=int(byte_off[-1]))


def _window_steps(dirs, llk, base: int, k: int, e: int, cap: int) -> int:
    """Steps of one window's walk from (k, e) (the last-row clamp
    included), or cap + 1 once it passes ``cap``."""
    win = dirs.shape[0]
    steps = 0
    while k >= 0 and e >= 0 and e + k + 2 - base >= 0 and steps <= cap:
        r = min(e + k + 2 - base, win - 1)
        d = dirs[r, min(max(k - llk[r], 0), PAD - 1)]
        k -= d != 1
        e -= d != 2
        steps += 1
    return steps


def window_walk_cases(rng, B: int, win: int, base: int) -> dict:
    """One window's walk inputs over random traces (``ops/abea_ultra.py``
    walk_window layout, NumPy): each read carries a random (k, e, n) --
    read 0 just above the window's last row (the last-row clamp), others
    below its first row or with k < 0 (no walk) -- and an output whose
    carried byte holds random low bits below n (what an earlier window
    wrote) and zeros above.  Every walk takes at most ``win`` steps, as a
    window's walk does (the JAX walk_window's bound)."""
    rows = [_random_rows(rng, win) for _ in range(B)]
    k = np.zeros(B, np.int64)
    e = np.zeros(B, np.int64)
    for i, (dirs, llk) in enumerate(rows):
        while True:
            if i == 0:
                k[i] = rng.integers(0, max(1, win // 3))
                v = win + int(rng.integers(0, 3))
            else:
                k[i] = rng.integers(-1, 200)
                v = int(rng.integers(-2, win + 20))
            e[i] = v + base - 2 - k[i]
            steps = _window_steps(dirs, llk, base, int(k[i]), int(e[i]),
                                  win)
            if steps <= win and (i > 0 or steps > 0):
                break
    n = rng.integers(0, 37, B)
    n[0] |= 1                                # mid-byte
    cap = rng.integers(5, 200, B)
    byte_off = ragged_offsets(cap)
    flat = np.zeros(int(cap.sum()), np.uint8)
    for i in range(B):
        if n[i] // 4 < cap[i]:
            flat[byte_off[i]:byte_off[i] + n[i] // 4] = rng.integers(
                0, 256, n[i] // 4)
            flat[byte_off[i] + n[i] // 4] = rng.integers(
                0, 1 << (2 * (n[i] % 4)))
    return dict(
        trace=pack_trace(torch.as_tensor(np.stack([d for d, _ in rows]))
                         ).numpy(),
        llk=np.stack([lk for _, lk in rows]),
        kst=np.stack([k, e, n], axis=1).astype(np.int32), flat=flat,
        byte_off=byte_off, base=base)


def nucleotide_model(k: int):
    """A nucleotide model of ``k`` (5, 6 or 9) for the kernel checks: the
    R9.4 RNA 5-mer and DNA 6-mer tables, the synthetic 9-mer table."""
    from .models import builtin_model

    if k == K9:
        return k9_models()[0]
    return builtin_model({5: "rna_r9_nucleotide",
                          6: "dna_r9_nucleotide"}[k])


def abea_rank_cases(rng, k: int) -> list[str]:
    """Reads for the rank probe (``abea_cuda.abea_ranks``) and the fills
    that rank packed sequences: one read of exactly k bases (one k-mer),
    then reads of 4m + 1 bases, so that the reads start at every base
    offset mod 4 of the packed buffer (``pack_seqs``), one read with runs
    of N (ranked as A), and random reads of up to 300 bases."""
    step = k + (1 - k) % 4                 # the least 4m + 1 >= k
    lengths = [k] + [step + 4 * j for j in range(5)]
    lengths += [int(n) for n in rng.integers(k, 300, 8)]
    seqs = [random_seq(rng, n) for n in lengths]
    with_n = list(random_seq(rng, 3 * k + 7))
    for j in (0, 1, k, k + 1, k + 2, 3 * k + 6):
        with_n[j] = "N"
    seqs.insert(3, "".join(with_n))
    return seqs


def kmer_events(rng, seqs, model) -> list[np.ndarray]:
    """Events along each sequence's k-mers, ~1.7 a k-mer, with noise
    (``abea_reads``' construction for given sequences)."""
    events = []
    for seq in seqs:
        kr = model.kmer_ranks(seq)
        ne = max(int(kr.shape[0] * 1.7), 1)
        which = np.floor(np.linspace(0, kr.shape[0], ne, endpoint=False))
        events.append((model.level_mean[kr[which.astype(np.int64)]]
                       + rng.normal(0.0, 1.0, ne)).astype(np.float32))
    return events


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


def simulated_pa(rng, model, n: int) -> np.ndarray:
    """A pA signal of exactly ``n`` samples: random k-mers dwelling 6-12
    samples around the model's levels, noise 1.2 pA (as event_signals)."""
    m = n // 6 + 1
    dwell = rng.integers(6, 13, m)
    levels = model.level_mean[rng.integers(0, model.level_mean.shape[0], m)]
    mean = np.repeat(levels.astype(np.float64), dwell)[:n]
    return rng.normal(mean, 1.2).astype(np.float32)


def carry_join_signal(tile: int) -> np.ndarray:
    """A signal whose prefix sums, taken tile by tile as csrc/events.cu
    takes them, round only where a tile's carry joins: a tile of 1024.0
    (its sums 2^22 and 2^32, exact in any order), then two tiles of
    2^-41.  Added one at a time (in sample order, or onto a thread's or a
    warp's prefix) each rounds away against 2^22, so every sum within the
    second tile stays 2^22; but that tile's total, 2^-29, does not, and
    the third tile's carry, 2^22 + 2^-29, disagrees with the second
    tile's last sum at the third tile's first sample, sample 2 * tile.
    (The squares, 2^-82, never reach 2^32.)"""
    return np.concatenate([np.full(tile, 1024.0, np.float32),
                           np.full(2 * tile, 2.0 ** -41, np.float32)])


def peak_tracks(rng) -> list[dict]:
    """Adversarial t-stat tracks for the chunk-parallel peak scan, each
    {"name", "t1", "t2" (f32), "rna"}: all zeros; a slow ramp that never
    emits; sawtooths whose peaks fall on multiples of 32 and on the first
    sample of 32-sample chunks; uniform noise, which emits densely; the
    worst case, a rise of t1 above threshold 1 followed by a long stretch
    within the peak height below its maximum (the short detector tracks
    without emitting and resets the long one at every sample, so a chunk
    run from any other state never falls back into step), for DNA and for
    RNA; and reads shorter than twice the long window."""
    f32 = np.float32
    i = np.arange(4000)
    cases = [
        ("zeros", np.zeros(3000), np.zeros(3000), False),
        ("ramp", np.linspace(0.0, 0.15, 1500), np.linspace(0.0, 0.15, 1500),
         False),
        ("saw32", 10.0 - 0.3 * (i % 32), 12.0 - 0.35 * ((i + 16) % 32),
         False),
        ("saw32_first", 10.0 - 0.3 * ((i - 1) % 32),
         12.0 - 0.35 * ((i + 15) % 32), False),
        ("noise", rng.uniform(0.0, 20.0, 6000), rng.uniform(0.0, 20.0, 6000),
         False),
    ]
    for name, top, drop, rna in (("plateau", 5.0, 0.15, False),
                                 ("plateau_rna", 8.0, 0.9, True)):
        t1 = top - rng.uniform(0.0, drop, 1500)
        t1[:2] = 0.0
        t1[2] = top
        cases.append((name, t1, rng.uniform(0.0, 20.0, 1500), rna))
    for n in (0, 1, 2, 5, 11):
        cases.append((f"short{n}", rng.uniform(0.0, 20.0, n),
                      rng.uniform(0.0, 20.0, n), False))
    return [dict(name=name, t1=t1.astype(f32), t2=t2.astype(f32), rna=rna)
            for name, t1, t2, rna in cases]


def peak_probe_batches(rng, golden=()) -> list[dict]:
    """The peak-scan probe's launches (``events_cuda.peaks_from_tracks``):
    the plain t-stat tracks of the DNA pA signals in ``golden`` (named
    golden0, ...) and ``peak_tracks(rng)``, one ragged batch a chemistry:
    [{"rna", "t1", "t2" (f32 tensors [S]), "sig_off" (i64 [B+1]),
    "names"}]."""
    from .ops.events_device import tracks_plain

    parts = {False: [], True: []}
    if golden:
        off = np.zeros(len(golden) + 1, np.int64)
        np.cumsum([p.shape[0] for p in golden], out=off[1:])
        t1, t2 = tracks_plain(torch.from_numpy(np.concatenate(golden)),
                              torch.from_numpy(off), False)
        parts[False] += [(f"golden{i}", t1[a:b].numpy(), t2[a:b].numpy())
                         for i, (a, b) in enumerate(zip(off[:-1], off[1:]))]
    for c in peak_tracks(rng):
        parts[c["rna"]].append((c["name"], c["t1"], c["t2"]))
    out = []
    for rna, items in parts.items():
        off = np.zeros(len(items) + 1, np.int64)
        np.cumsum([t1.shape[0] for _, t1, _ in items], out=off[1:])
        out.append(dict(
            rna=rna, names=[name for name, _, _ in items],
            t1=torch.from_numpy(np.concatenate([t for _, t, _ in items])),
            t2=torch.from_numpy(np.concatenate([t for _, _, t in items])),
            sig_off=torch.from_numpy(off)))
    return out


def viterbi_round(rng, model, n_chunks: int, n_ref=(12, 105),
                  events_per_kmer=(0.5, 2.0), shapes=None) -> dict:
    """One lockstep round of eventalign chunks (layout: ops/hmm.py): each
    chunk a random window of ``n_ref`` bases (a range) whose events
    follow its k-mers with noise, its ranks forward or backward in the
    rank pool and its events read with stride +1 or -1.  ``shapes``, a
    list of (k-mers, events, event stride, rank stride), fixes those of
    each chunk instead (n_chunks is its length).  Returns the pools, both
    specs and, per chunk, the arguments of ``native.viterbi_chunk``."""
    from .ops.hmm import viterbi_read_params

    if shapes is not None:
        n_chunks = len(shapes)
    rk_parts, ev_parts, chunks = [], [], []
    spec_i32 = np.zeros((n_chunks, 6), np.int32)
    spec_f32 = np.zeros((n_chunks, 6), np.float32)
    rk_off = ev_off = 0
    for i in range(n_chunks):
        n_bases = (int(rng.integers(n_ref[0], n_ref[1] + 1))
                   if shapes is None else shapes[i][0] + model.k - 1)
        ranks = model.kmer_ranks(random_seq(rng, n_bases)).astype(np.int32)
        n_k = ranks.shape[0]
        n_ev = (max(int(n_k * rng.uniform(*events_per_kmer)), 2)
                if shapes is None else shapes[i][1])
        which = np.sort(rng.integers(0, n_k, n_ev))
        means = (model.level_mean[ranks[which]]
                 + rng.normal(0, 1.0, n_ev)).astype(np.float32)
        pool = rng.uniform(60, 120, n_ev + 40).astype(np.float32)
        stride = (int(rng.choice([1, -1])) if shapes is None
                  else shapes[i][2])
        if stride == 1:
            e0 = 20
            pool[e0:e0 + n_ev] = means
        else:
            pool[20:20 + n_ev] = means[::-1]
            e0 = 20 + n_ev - 1
        r_stride = (int(rng.choice([1, -1])) if shapes is None
                    else shapes[i][3])
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



def viterbi_far_round(rng, model, n_chunks: int) -> dict:
    """viterbi_round with values outside the range in which the chunk
    Viterbi's register kernel takes its fast division (csrc/viterbi.cu
    div_rn: events and gm in +-[2^-30, 2^30) or 0, gs in +-[2^-60,
    2^60)), so that it takes __fdiv_rn: of every five chunks, one has an
    event of 3 x 2^31, one an event of 2^-40, one gm near 2^31 (its
    shift), one gs of at least 2^60 (its var, 2^62, with the read's log
    var and transitions made from it), and one stays in range."""
    from .ops.hmm import viterbi_read_params

    x = viterbi_round(rng, model, n_chunks)
    si, sf = x["spec_i32"], x["spec_f32"]
    for i, c in enumerate(x["chunks"]):
        kind = i % 5
        if kind < 2:
            r = int(rng.integers(0, c["n_events"]))
            v = np.float32(3 * 2.0 ** 31 if kind == 0 else 2.0 ** -40)
            c["ev_pool"][c["e_start"] + r * c["stride"]] = v
            x["ev_pool"][si[i, 3] + r * si[i, 4]] = v
        elif kind == 2:
            c["shift"] = sf[i, 1] = 2.0 ** 31
        elif kind == 3:
            c["var"] = 2.0 ** 62
            sf[i, 2:] = (c["var"], *viterbi_read_params(
                c["events_per_base"], c["var"]))
    return x


def viterbi_edge_shapes(group: int, reg_cap: int, tiled: bool) -> list:
    """Chunk shapes (k-mers, events, event stride, rank stride) at the
    edges of the chunk Viterbi kernel's partition (csrc/viterbi.cu): k-mers
    1, 2, group - 1, group, group + 1, 96, 97 and reg_cap (the register
    kernel's capacity), with ``tiled`` also reg_cap + 1 and 400 (the tiled
    kernel), each with 1, 2 and 4,000 events; both strides of each kind."""
    ks = [1, 2, group - 1, group, group + 1, 96, 97, reg_cap]
    if tiled:
        ks += [reg_cap + 1, 400]
    shapes = []
    for k in ks:
        for n_ev in (1, 2, 4000):
            i = len(shapes)
            shapes.append((k, n_ev, 1 - 2 * (i % 2), 1 - 2 * (i // 2 % 2)))
    return shapes

# --- other pore configurations: R10.4.1-style 9-mer DNA, RNA004 --------

K9 = 9


def write_model_file(path: str, kmer_bytes: np.ndarray, means, stdvs,
                     k: int) -> None:
    """An f5c/nanopolish text model (``#k`` header, one ``kmer mean
    stdv`` row a k-mer in rank order), written vectorised."""
    km = kmer_bytes.view(f"S{k}").ravel().astype(f"U{k}")
    rows = np.char.add(
        np.char.add(np.char.add(km, "\t"), np.char.mod("%.2f", means)),
        np.char.add(np.char.add("\t", np.char.mod("%.2f", stdvs)), "\n"))
    with open(path, "w") as f:
        f.write(f"#k\t{k}\n")
        f.write("".join(rows.tolist()))


def _k9_tables(seed: int) -> dict:
    """Synthetic 9-mer tables: {"nucleotide": (k-mer bytes, means,
    stdvs), "meth": (...)}: 4^9 random levels, and 5^9 CpG levels whose
    k-mers without M share the nucleotide levels (the construction of
    tests/test_pore_configs_cli.py)."""
    rng = np.random.default_rng(seed)
    n4 = 4 ** K9
    means4 = rng.uniform(60.0, 130.0, n4).astype(np.float32)
    stdv4 = rng.uniform(1.2, 3.0, n4).astype(np.float32)
    i4 = np.arange(n4, dtype=np.int64)
    km4 = np.stack([np.frombuffer(b"ACGT", np.uint8)[(i4 >> (2 * p)) & 3]
                    for p in range(K9 - 1, -1, -1)], axis=1)
    n5 = 5 ** K9
    i5 = np.arange(n5, dtype=np.int64)
    dig = np.stack([(i5 // 5 ** p) % 5 for p in range(K9 - 1, -1, -1)],
                   axis=1)
    km5 = np.frombuffer(b"ACGMT", np.uint8)[dig]
    has_m = (dig == 3).any(axis=1)
    rank4 = np.zeros(n5, np.int64)
    for c in range(K9):
        rank4 = rank4 * 4 + np.where(dig[:, c] == 4, 3, dig[:, c])
    means5 = means4[rank4]
    stdv5 = stdv4[rank4]
    shift_m = rng.uniform(-8, 8, n5).astype(np.float32)
    means5[has_m] = 90.0 + shift_m[has_m]
    stdv5[has_m] = 2.0
    return {"nucleotide": (km4, means4, stdv4), "meth": (km5, means5, stdv5)}


def k9_models(seed: int = 5) -> tuple:
    """The synthetic 9-mer tables as (nucleotide, CpG) PoreModels."""
    from .models.pore_model import PoreModel

    return tuple(PoreModel(k=K9, alphabet=a, level_mean=m, level_stdv=s)
                 for a, (_, m, s) in _k9_tables(seed).items())


def r10_models(dst: str, seed: int = 5) -> tuple[str, str]:
    """The synthetic 9-mer tables (``k9_models``) as full-size model files
    in ``dst``, levels to two decimals as in ONT's and f5c's files.
    Returns the (nucleotide, CpG) paths."""
    os.makedirs(dst, exist_ok=True)
    paths = []
    for name, (km, means, stdvs) in zip(("nucleotide", "cpg"),
                                        _k9_tables(seed).values()):
        paths.append(os.path.join(dst, f"r10.{name}.9mer.model"))
        write_model_file(paths[-1], km, means, stdvs, K9)
    return tuple(paths)


def _pore_reads(dst, contig, genome, reads, model, rng, spb, noise,
                channel, attrs, transcribe=False) -> dict:
    """Write a dataset (datasets.ROLES) of ``reads`` = (qname, read seq,
    flag, pos, BAM seq) over ``genome``, each read's raw signal drawn from
    ``model`` at ``spb`` samples a k-mer (3' to 5' with ``transcribe``,
    the RNA order, its reads FASTA in U), indexed."""
    from .datasets import _index, dataset
    from .io.bam import write_bam
    from .io.fast5 import Signal
    from .io.slow5 import write_blow5

    digitisation, offset, rng_pa, rate = channel
    os.makedirs(dst, exist_ok=True)
    out = dataset(dst)
    with open(out["genome"], "w") as f:
        f.write(f">{contig}\n{genome}\n")
    with open(out["reads"], "w") as f:
        for q, seq, *_ in reads:
            f.write(f">{q}\n{seq.replace('T', 'U') if transcribe else seq}"
                    "\n")
    write_bam(out["bam"], [(contig, len(genome))], [
        SimpleNamespace(qname=q, flag=flag, tid=0, pos=pos, mapq=60,
                        cigar=[(0, len(bam_seq))], seq=bam_seq)
        for q, _s, flag, pos, bam_seq in reads])
    signals = []
    for q, seq, *_ in reads:
        levels = model.level_mean[model.kmer_ranks(seq)]
        if transcribe:
            levels = levels[::-1]
        pa = np.repeat(levels, rng.integers(spb[0], spb[1],
                                            levels.shape[0]))
        pa = (pa + rng.normal(0, noise, pa.shape[0])).astype(np.float32)
        raw = np.clip(pa * digitisation / rng_pa - offset, -32000, 32000)
        signals.append(Signal(raw=raw.astype(np.int16),
                              digitisation=digitisation, offset=offset,
                              range=rng_pa, sample_rate=rate, read_id=q))
    write_blow5(out["slow5"], signals, attrs=attrs)
    _index(out)
    return out


def r10_dataset(dst: str, nuc_model_path: str, seed: int = 7,
                lengths=(900, 1400, 1100, 700)) -> dict:
    """A synthetic R10 DNA dataset (the read of tests/test_r10_kmer9.py,
    more of them): reads of ``lengths`` bases over a random genome, every
    other one on the reverse strand, squiggles drawn from the 9-mer model
    at 5-11 samples a k-mer, a BLOW5 whose header names an R10.4.1 kit
    (``sqk-lsk114``), so that the chemistry is detected from it."""
    from .datasets import _revcomp
    from .models import load_model_file

    rng = np.random.default_rng(seed)
    model = load_model_file(nuc_model_path)
    span = sum(lengths) + 50 * len(lengths)
    genome = "".join(rng.choice(list("ACGT"), p=[.3, .2, .2, .3],
                                size=span))
    reads, pos = [], 0
    for i, n in enumerate(lengths):
        seg = genome[pos:pos + n]
        rev = i % 2 == 1
        reads.append((f"r10-read{i}", _revcomp(seg) if rev else seg,
                      16 if rev else 0, pos, seg))
        pos += n + 50
    return _pore_reads(dst, "ctg", genome, reads, model, rng, (5, 12), 1.0,
                       (8192.0, 0.0, 1500.0, 4000.0),
                       {"sequencing_kit": "sqk-lsk114"})


def rna004_dataset(dst: str, seed: int = 13, lengths=(500, 650)) -> dict:
    """A synthetic RNA004 dataset (the read of
    tests/test_pore_configs_cli.py::test_rna004_m6anet_cli, more of
    them): one transcript per read, its k-mers emitted 3' to 5' from the
    RNA004 table at 20-39 samples a k-mer, a BLOW5 whose header says
    ``experiment_type rna`` and ``sequencing_kit sqk-rna004``."""
    from .models import builtin_model

    rng = np.random.default_rng(seed)
    model = builtin_model("rna004_nucleotide")
    seqs = [random_seq(rng, n) for n in lengths]
    genome = "".join(seqs)
    reads, pos = [], 0
    for i, seq in enumerate(seqs):
        reads.append((f"rna004-read{i}", seq, 0, pos, seq))
        pos += len(seq)
    return _pore_reads(dst, "tx1", genome, reads, model, rng, (20, 40), 1.0,
                       (8192.0, 0.0, 1200.0, 3000.0),
                       {"experiment_type": "rna",
                        "sequencing_kit": "sqk-rna004"}, transcribe=True)
