"""The port's CUDA kernels against their plain PyTorch versions, on the
card (csrc/abea.cu, csrc/hmm.cu, csrc/events.cu, csrc/viterbi.cu; built
with nvcc at first use).

ABEA must be bit-identical (trace, band placement, start event, walk
length and bytes); the fused HMM forward scores (window metadata in)
agree to ops/hmm.py's stated f32 tolerance, and the ranks its prologue
computes (the rank probe) equal build_inputs' bit for bit, as do the
k-mer ranks that the ABEA fills compute from the packed sequences (their
probe) ranks_from_packed's.  Without a
CUDA device every test here skips; run them on the card with ``python -m
pytest tests/test_torch_kernels_cuda.py``; the windowed ABEA kernels of
csrc/abea_ultra.cu are held to the same bits, and the event detector and
the chunk Viterbi to their plain versions and the host code bit for bit,
and the event detector's peak scan alone (the probe) to the sequential
scan and its plain model's rounds, its sums and tracks alone (their probe)
to their plain model, on a read of 2.75 M samples, at the sample budget,
on reads of 0, 1 and 5 samples and where the sums round (a refused launch
raises).  The unchunked walk by each route (the tile-parallel walk of
csrc/abea_walk_tiled.cu, the one-warp walk, the crossover's mix) and every
window walk by both are held to the plain walks and the plain tiled walk
on fills and on random traces (the chase's cell-by-cell path, the
last-row clamp); K1 and both K3 instances on a 13,600-band chain.
"""

import numpy as np
import pytest
import torch

from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import (abea, abea_cuda, hmm, hmm_cuda, hmm_meta,
                               viterbi_cuda)
from f5c_tpu_torch.ops.seq_ranks import (kmer_positions, pack_seqs,
                                         ranks_at_kmers, ranks_from_packed)

pytestmark = pytest.mark.needs_cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _on(arrays: dict, device):
    return {k: (torch.as_tensor(np.ascontiguousarray(v), device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in arrays.items()}


def _fill_args(x: dict) -> list:
    """The fill wrappers' arguments from a synthetic.abea_inputs batch: the
    sequences 2-bit packed, ranked by the kernel."""
    return [x[k] for k in ("ev_pool", "ev_off", "ev_len", "seq_packed",
                           "seq_off", "rk_len", "k", "level_mean",
                           "level_stdv", "level_log_stdv", "params",
                           "band_off")]


def test_abea_kernels_match_plain(cuda):
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(11)
    n_kmers = [20, 64, 127, 128, 129, 300, 700, 1500, 45, 90, 5000]
    seqs, events = synthetic.abea_reads(rng, n_kmers, model, unrelated=(8,))
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    got = abea_cuda.abea_fill(*_fill_args(x), x["n_bands"])
    want = abea.abea_fill_packed_plain(*_fill_args(x))
    torch.cuda.synchronize()
    # the trace 2 bits a cell, byte for byte the plain version's packing
    assert got[0].shape == (x["n_bands"], abea.TRACE_ROW_BYTES)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    trace, llk, start_e = want
    walk_args = (trace, llk, x["band_off"], start_e, x["rk_len"],
                 x["byte_off"])
    got = abea_cuda.abea_walk(*walk_args, x["n_bytes"])
    want = abea.abea_walk_plain(*walk_args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].min()) > 0


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_abea_tiled_walk_matches_warp_and_plain(cuda):
    """The unchunked walk by each route (the one-warp kernel, the tiled
    kernels, and the crossover's mix) against the plain walk and the
    plain tiled walk, bit for bit: on fills of mixed reads (one of
    13,600 bands, 107 tiles; one-tile reads) and on random traces whose
    paths leave the mapped cells (the chase's cell-by-cell path)."""
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(15)
    n_kmers = [20, 64, 129, 700, 1500, 45, 5000, 900]
    seqs, events = synthetic.abea_reads(rng, n_kmers, model, unrelated=(5,))
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    trace, llk, start_e = abea_cuda.abea_fill(*_fill_args(x), x["n_bands"])
    cases = [(trace, llk, x["band_off"], start_e, x["rk_len"],
              x["byte_off"], x["n_bytes"])]
    r = _on(synthetic.walk_cases(rng, [3, 50, 128, 129, 400, 3000, 7000]),
            cuda)
    cases.append(tuple(r[k] for k in ("trace", "llk", "band_off", "start_e",
                                       "rk_len", "byte_off", "n_bytes")))
    for args in cases:
        want = abea.abea_walk_plain(*args[:-1])
        assert _same(abea.abea_walk_tiled_plain(*args[:-1]), want)
        bands = np.diff(args[2].cpu().numpy())
        assert (bands >= abea_cuda.TILED_MIN_BANDS).any()
        assert (bands < abea_cuda.TILED_MIN_BANDS).any()
        for route in ("warp", "tiled", None):
            got = abea_cuda.abea_walk(*args, route=route)
            torch.cuda.synchronize()
            assert _same(got, want), route


@pytest.mark.parametrize("win", [97, 1000, 4097])
def test_abea_tiled_window_walk_matches_warp_and_plain(cuda, win):
    """Every window of the windowed path, last to first, walked by the
    tiled kernels, the one-warp kernel and the plain walk from the same
    carried (k, e, n): the same (k, e, n) and bytes after each window
    (windows that start mid-byte included); then random windows whose
    walks start above the last row (the clamp) or do not walk."""
    from f5c_tpu_torch.ops import abea_ultra, abea_ultra_cuda

    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(16)
    seqs, events = synthetic.abea_reads(rng, [20, 700, 1500, 45, 3000],
                                        model, unrelated=(3,))
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    args = _fill_args(x)
    nb_max = int(np.diff(x["band_off"].cpu().numpy()).max())
    nw = abea_ultra.n_windows(nb_max, win)
    s0 = abea_ultra.initial_state(x["params"])
    ckpt, _, _ = abea_ultra_cuda.abea_fill_window(*args, s0, 2, win, nw,
                                                  False)
    start_e = ckpt[:, -1].view(torch.int32)[:, abea_ultra.ST_BEST_E]
    kst = abea_ultra.walk_start(start_e.contiguous(), x["rk_len"])
    flat = torch.zeros(x["n_bytes"], dtype=torch.uint8, device=cuda)
    mid_byte = 0
    for w in range(nw - 1, -1, -1):
        state = s0 if w == 0 else ckpt[:, w - 1].contiguous()
        base = 2 + w * win
        _, trace, llk = abea_ultra_cuda.abea_fill_window(*args, state, base,
                                                         win, 1, True)
        mid_byte += int((kst[:, 2] % 4 != 0).sum())
        want = abea_ultra.walk_window_plain(trace, llk, base, kst, flat,
                                            x["byte_off"])
        warp = abea_ultra_cuda.abea_walk_window(trace, llk, base, kst, flat,
                                                x["byte_off"], route="warp")
        got = abea_ultra_cuda.abea_walk_window(trace, llk, base, kst, flat,
                                               x["byte_off"])
        torch.cuda.synchronize()
        assert _same(warp, want) and _same(got, want), w
        kst, flat = want
    if win == 97:   # many windows: some walks carry n % 4 != 0
        assert mid_byte > 0
    y = _on(synthetic.window_walk_cases(rng, 8, win, 40), cuda)
    wa = (y["trace"], y["llk"], 40, y["kst"], y["flat"], y["byte_off"])
    want = abea_ultra.walk_window_plain(*wa)
    assert _same(abea_ultra.walk_window_tiled_plain(*wa), want)
    for route in ("warp", "tiled"):
        got = abea_ultra_cuda.abea_walk_window(*wa, route=route)
        torch.cuda.synchronize()
        assert _same(got, want), route


def test_abea_fills_match_plain_on_a_long_chain(cuda):
    """K1 and both instances of K3 (the forward pass without a trace, the
    re-fill with one) bit for bit against the plain fills on a read of
    13,600 bands among short ones: the band step scores both placements
    before Suzuki's rule and must still select the plain version's
    bits."""
    from f5c_tpu_torch.ops import abea_ultra, abea_ultra_cuda

    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(17)
    seqs, events = synthetic.abea_reads(rng, [5000, 30, 400], model)
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    args = _fill_args(x)
    want = abea.abea_fill_packed_plain(*args)
    got = abea_cuda.abea_fill(*args, x["n_bands"])
    torch.cuda.synchronize()
    assert _same(got, want)
    win = 4096
    nb_max = int(np.diff(x["band_off"].cpu().numpy()).max())
    nw = abea_ultra.n_windows(nb_max, win)
    s0 = abea_ultra.initial_state(x["params"])
    fwd = abea_ultra_cuda.abea_fill_window(*args, s0, 2, win, nw, False)
    fwd_p = abea_ultra.fill_window_packed_plain(*args, s0, 2, win, nw, False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(fwd[0]), _bits(fwd_p[0]))
    state = fwd_p[0][:, 0].contiguous()
    got = abea_ultra_cuda.abea_fill_window(*args, state, 2 + win, win, 1,
                                           True)
    want = abea_ultra.fill_window_packed_plain(*args, state, 2 + win, win,
                                               1, True)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


HMM_META = ("meta", "packed_ref", "read_tab", "ev_pool", "level_mean",
            "level_stdv", "level_log_stdv")


def _hmm_meta_case(x, cuda, allow_pre=True, allow_post=True):
    """The fused kernel on a synthetic.hmm_meta_windows batch, in launch
    order and with every window on a warp of its own, against the plain
    version."""
    t = _on(x, cuda)
    args = [t[k] for k in HMM_META] + [x["k"]]
    allow = dict(allow_pre=allow_pre, allow_post=allow_post)
    want = hmm_meta.hmm_forward_meta_plain(*args, **allow)
    for n_narrow in {x["n_narrow"], 0}:
        got = hmm_cuda.hmm_forward_meta(*args, n_narrow=n_narrow,
                                        max_km=x["max_km"], **allow)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all()
        torch.testing.assert_close(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)


@pytest.mark.parametrize("allow_pre,allow_post", [(True, True),
                                                  (False, False)])
def test_hmm_kernel_matches_plain(cuda, allow_pre, allow_post):
    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(12)
    n_kmers = [1, 5, 17, 31, 32, 33, 64, 100, 128, 129, 200, 300]
    x = synthetic.hmm_meta_windows(rng, n_kmers, model)
    _hmm_meta_case(x, cuda, allow_pre, allow_post)


@pytest.mark.parametrize("n_kmers", [[600, 20], [2500], [5000]])
def test_hmm_kernel_wide_windows(cuda, n_kmers):
    """Windows whose state needs more than 48 KB of shared memory per
    block (the opt-in attribute), then 2 and 1 warps per block."""
    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(13)
    x = synthetic.hmm_meta_windows(rng, n_kmers, model)
    _hmm_meta_case(x, cuda)


def test_hmm_kernel_marks_a_wrong_class_split(cuda):
    """A window the launch puts in too narrow a class (a narrow slot, or
    past ``max_km``) scores NaN, and every other window its score."""
    model = builtin_model("dna_r9_cpg")
    x = synthetic.hmm_meta_windows(np.random.default_rng(16),
                                   [8, 12, 20, 100], model)
    t = _on(x, cuda)
    args = [t[k] for k in HMM_META] + [x["k"]]
    want = hmm_meta.hmm_forward_meta_plain(*args)
    assert x["n_narrow"] == 2
    for n_narrow, max_km, too_wide in ((4, 100, x["n_km"] > 16),
                                       (2, 40, x["n_km"] > 64)):
        got = hmm_cuda.hmm_forward_meta(*args, n_narrow=n_narrow,
                                        max_km=max_km)
        torch.cuda.synchronize()
        bad = torch.from_numpy(too_wide).to(cuda)
        assert torch.isnan(got[bad]).all()
        torch.testing.assert_close(got[~bad], want[~bad], rtol=hmm.RTOL,
                                   atol=hmm.ATOL)


def test_kernels_match_plain_with_9mer_tables(cuda):
    """K1 and K4 with a 4^9 nucleotide table and K2 with a 5^9 CpG table
    (the synthetic R10 tables of synthetic.k9_models), and K2's in-kernel
    9-mer ranks, against their plain versions."""
    nuc, cpg = synthetic.k9_models()
    rng = np.random.default_rng(19)
    seqs, events = synthetic.abea_reads(rng, [40, 300, 900, 2500], nuc,
                                        unrelated=(1,))
    x = _on(synthetic.abea_inputs(seqs, events, nuc), cuda)
    got = abea_cuda.abea_fill(*_fill_args(x), x["n_bands"])
    want = abea.abea_fill_packed_plain(*_fill_args(x))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    walk_args = (want[0], want[1], x["band_off"], want[2], x["rk_len"],
                 x["byte_off"])
    got = abea_cuda.abea_walk(*walk_args, x["n_bytes"])
    want_w = abea.abea_walk_plain(*walk_args)
    torch.cuda.synchronize()
    for g, w in zip(got, want_w):
        assert torch.equal(g, w)
    m = synthetic.hmm_meta_windows(rng, [1, 9, 17, 40, 128, 300], cpg)
    assert m["k"] == 9
    _hmm_meta_case(m, cuda)
    t = _on(m, cuda)
    args = (t["meta"], t["packed_ref"], t["read_tab"])
    got = hmm_cuda.hmm_window_ranks(*args, 9, m["max_km"])
    assert torch.equal(got, hmm_meta.build_inputs(*args, k=9,
                                                  kw=m["max_km"])[0])
    assert int(got.max()) >= 4 ** 9


@pytest.mark.parametrize("k", [5, 6, 9])
def test_abea_rank_probe(cuda, k):
    """The ranks the fill kernels compute where they stage a k-mer (the
    probe f5c_abea_ranks), bit for bit ranks_from_packed's at every k-mer
    of every read and 0 elsewhere, on synthetic.abea_rank_cases (reads at
    every offset mod 4 of the packed buffer, Ns, a read of one k-mer) and
    on 2,000 random reads."""
    rng = np.random.default_rng(60 + k)
    for seqs in (synthetic.abea_rank_cases(rng, k),
                 [synthetic.random_seq(rng, int(n))
                  for n in rng.integers(k, 3000, 2000)]):
        packed, off = pack_seqs(seqs)
        rk_len = np.array([len(q) - k + 1 for q in seqs], np.int32)
        args = [torch.as_tensor(a, device=cuda) for a in (packed, off,
                                                          rk_len)]
        got = abea_cuda.abea_ranks(*args, k)
        torch.cuda.synchronize()
        assert torch.equal(got, ranks_at_kmers(*args, k))
        pos = kmer_positions(args[1], args[2])
        assert torch.equal(got[pos], ranks_from_packed(args[0], k)[pos])


def test_hmm_rank_probe_matches_build_inputs(cuda):
    """The kernel's in-prologue k-mer ranks, bit for bit build_inputs', on
    the cases of tests/test_torch_ranks.py and windows at both ends of
    the reference concat (with and without its zero sentinel)."""
    k = builtin_model("dna_r9_cpg").k
    for c in synthetic.rank_cases(np.random.default_rng(15), k):
        t = _on(c, cuda)
        args = (t["meta"], t["packed_ref"], t["read_tab"])
        got = hmm_cuda.hmm_window_ranks(*args, k, c["kw"])
        want = hmm_meta.build_inputs(*args, k=k, kw=c["kw"])[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _bits(t):
    """State records hold ints as f32 bits: compare them as bits."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("win", [97, 1000, 4097])
def test_abea_window_kernels_match_plain(cuda, win):
    """The windowed fill (forward over the whole reads, then one window
    with the trace) and the window walk, against their plain versions;
    the whole windowed path against the unchunked kernels."""
    from f5c_tpu_torch.ops import abea_ultra, abea_ultra_cuda

    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(14)
    n_kmers = [20, 128, 129, 700, 1500, 45, 3000]
    seqs, events = synthetic.abea_reads(rng, n_kmers, model, unrelated=(5,))
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    args = _fill_args(x)
    nb_max = int(np.diff(x["band_off"].cpu().numpy()).max())
    nw = abea_ultra.n_windows(nb_max, win)
    s0 = abea_ultra.initial_state(x["params"])
    got = abea_ultra_cuda.abea_fill_window(*args, s0, 2, win, nw, False)
    want = abea_ultra.fill_window_packed_plain(*args, s0, 2, win, nw, False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    w = nw - 1
    state = want[0][:, w - 1].contiguous() if w else s0
    base = 2 + w * win
    got = abea_ultra_cuda.abea_fill_window(*args, state, base, win, 1, True)
    want = abea_ultra.fill_window_packed_plain(*args, state, base, win, 1,
                                               True)
    torch.cuda.synchronize()
    assert got[1].shape == (len(n_kmers), win, abea.TRACE_ROW_BYTES)
    for g, p in zip(got, want):
        assert torch.equal(_bits(g), _bits(p))
    trace, llk = want[1], want[2]
    _, start_e, _ = abea_cuda.abea_align(*args, x["byte_off"], x["n_bands"],
                                         x["n_bytes"])
    kst = abea_ultra.walk_start(start_e, x["rk_len"])
    flat = torch.zeros(x["n_bytes"], dtype=torch.uint8, device=cuda)
    got = abea_ultra_cuda.abea_walk_window(trace, llk, base, kst, flat,
                                           x["byte_off"])
    want = abea_ultra.walk_window_plain(trace, llk, base, kst, flat,
                                        x["byte_off"])
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    got = abea_ultra_cuda.abea_align_windowed(
        *args, x["byte_off"], x["n_bytes"], nb_max, win)
    ref = abea_cuda.abea_align(*args, x["byte_off"], x["n_bands"],
                               x["n_bytes"])
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_events_kernels_match_plain_and_native(cuda):
    """The event detector (csrc/events.cu) on the golden signals and the
    synthetic ones of synthetic.event_signals (tiny values whose prefix
    sums round, the densest pattern, RNA), bit for bit its plain version
    and native.detect_events."""
    from f5c_tpu_torch import datasets, native
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import events_cuda, events_device

    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    sig = synthetic.event_signals(np.random.default_rng(17),
                                  builtin_model("dna_r9_nucleotide"),
                                  builtin_model("rna_r9_nucleotide"))
    golden = [f.get(r).to_pa() for r in f.read_ids()]
    for rna, pas in ((False, golden + sig["dna"]), (True, sig["rna"])):
        off = np.zeros(len(pas) + 1, np.int64)
        np.cumsum([p.shape[0] for p in pas], out=off[1:])
        slab = torch.from_numpy(np.concatenate(pas)).to(cuda)
        so = torch.from_numpy(off).to(cuda)
        got = events_cuda.detect_events(slab, so, rna)
        want = events_device.detect_events_plain(slab, so, rna)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        eo = got[0].cpu().numpy()
        for i, p in enumerate(pas):
            et = native.detect_events(p, rna=rna)
            a, b = eo[i], eo[i + 1]
            assert np.array_equal(got[1][a:b].cpu().numpy(), et.start)
            for g, w in zip(got[2:], (et.length, et.mean, et.stdv)):
                assert g[a:b].cpu().numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("chunk", [0, 32, 1000])
def test_events_peak_probe_matches_model(cuda, chunk):
    """The peak scan alone (events_cuda.peaks_from_tracks) on the golden
    signals' tracks and the adversarial synthetic.peak_tracks, at the
    kernel's own chunk length (0) and pinned ones: events_device.peak_scan's
    peaks in order, and the rounds of the plain model peak_scan_chunked
    at the same chunk lengths."""
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import events_cuda, events_device

    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    golden = [f.get(r).to_pa() for r in f.read_ids()]
    for x in synthetic.peak_probe_batches(np.random.default_rng(2034),
                                          golden):
        args = (x["t1"], x["t2"], x["sig_off"])
        got, rounds = events_cuda.peaks_from_tracks(
            *(a.to(cuda) for a in args), x["rna"], chunk)
        want, want_rounds = events_cuda.peaks_from_tracks(*args, x["rna"],
                                                          chunk)
        assert got == want
        assert np.array_equal(rounds, want_rounds)
        so = x["sig_off"].tolist()
        for i, p in enumerate(got):
            lo, hi = so[i], so[i + 1]
            assert p == events_device.peak_scan(
                x["t1"][lo:hi].tolist(), x["t2"][lo:hi].tolist(), hi - lo,
                x["rna"])


def _same_events(got, want) -> bool:
    """Equal bit for bit, but that a NaN (the mean of an empty read's
    event, 0 / 0) matches any NaN: the card's and the host's NaNs differ
    in their bits."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype.kind != "f":
        return np.array_equal(got, want)
    nan = np.isnan(got)
    return (np.array_equal(nan, np.isnan(want))
            and got[~nan].tobytes() == want[~nan].tobytes())


def _hold_events(cuda, pas, rna, fixed, plain=True):
    """K9's sums and tracks (the probe events_cuda.sums_tracks) and its
    events (detect_events) on one launch of the signals ``pas``, held bit
    for bit to the plain model (sums_tracks_model, with its ``fixed``, and
    detect_events_model, unless ``plain`` is False) and read by read to
    native.detect_events; fixed_reads counts the reads given as
    ``fixed``.  Returns the launch's tile count."""
    from f5c_tpu_torch import native
    from f5c_tpu_torch.ops import events_cuda, events_device

    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    pa, so = torch.from_numpy(np.concatenate(pas)), torch.from_numpy(off)
    got = events_cuda.sums_tracks(pa.to(cuda), so.to(cuda), rna)
    want = events_device.sums_tracks_model(pa, so, rna)
    torch.cuda.synchronize()
    assert want[4].tolist() == fixed
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    before = events_cuda.fixed_reads["events"]
    ev = [t.cpu() for t in events_cuda.detect_events(pa.to(cuda),
                                                     so.to(cuda), rna)]
    assert events_cuda.fixed_reads["events"] - before == sum(fixed)
    if plain:
        for g, w in zip(ev, events_device.detect_events_model(pa, so, rna)):
            assert _same_events(g.numpy(), w.numpy())
    eo = ev[0].numpy()
    for i, p in enumerate(pas):
        et = native.detect_events(p, rna=rna)
        a, b = eo[i], eo[i + 1]
        for g, w in zip(ev[1:], (et.start, et.length, et.mean, et.stdv)):
            assert _same_events(g[a:b].numpy(), w)
    return int(events_device.tile_table(np.diff(off))[-1])


def test_events_sums_on_a_long_read(cuda):
    """One read of 2.75 M samples: the sums on its 672 tiles (at least a
    block an SM) bit for bit the model's and the host's, its events
    native's."""
    rng = np.random.default_rng(61)
    p = synthetic.simulated_pa(rng, builtin_model("dna_r9_nucleotide"),
                               2_750_000)
    tiles = _hold_events(cuda, [p], False, [0])
    assert tiles >= torch.cuda.get_device_properties(
        cuda).multi_processor_count


def test_events_sums_redo_where_they_round(cuda):
    """The tiny-value signal (its sums round within a tile), the
    carry-join signal (only where the third tile's carry joins) and a
    real read between them: the first two redone on the card (fixed_reads
    counts them), every sum and event the host's."""
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import events_device

    sig = synthetic.event_signals(np.random.default_rng(2031),
                                  builtin_model("dna_r9_nucleotide"))
    golden = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    pas = [sig["dna"][4], golden.get(golden.read_ids()[0]).to_pa(),
           synthetic.carry_join_signal(events_device.SUM_TILE)]
    _hold_events(cuda, pas, False, [1, 0, 1])


def test_events_kernels_mixed_batch(cuda):
    """Reads of 0, 1 and 5 samples among golden reads and a read of one
    tile and one sample, DNA, then the RNA signal beside them."""
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import events_device

    rng = np.random.default_rng(62)
    nuc = builtin_model("dna_r9_nucleotide")
    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    golden = [f.get(r).to_pa() for r in f.read_ids()]
    short = [synthetic.simulated_pa(rng, nuc, n) for n in (0, 1, 5)]
    one_more = synthetic.simulated_pa(rng, nuc, events_device.SUM_TILE + 1)
    pas = [short[0], golden[0], short[1], short[0], golden[1], short[2],
           one_more, short[0]]
    _hold_events(cuda, pas, False, [0] * len(pas))
    sig = synthetic.event_signals(rng, nuc, builtin_model("rna_r9_nucleotide"))
    _hold_events(cuda, [short[0]] + sig["rna"] + short[1:], True, [0] * 4)


def test_events_kernels_at_the_sample_budget(cuda):
    """A launch of SAMPLE_BUDGET samples (reads of 2 k to 400 k samples,
    8,192 tiles): the sums and tracks the model's, the events native's."""
    from f5c_tpu_torch.ops import events_cuda

    rng = np.random.default_rng(63)
    nuc = builtin_model("dna_r9_nucleotide")
    lens, left = [], events_cuda.SAMPLE_BUDGET
    while left > 0:
        lens.append(min(left, int(rng.integers(2_000, 400_000))))
        left -= lens[-1]
    pas = [synthetic.simulated_pa(rng, nuc, n) for n in lens]
    tiles = _hold_events(cuda, pas, False, [0] * len(pas), plain=False)
    assert tiles >= events_cuda.SAMPLE_BUDGET // 4096


def test_events_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (a peak-scan block of 2,048 threads)
    raises with its CUDA error; the next call runs and is right."""
    from f5c_tpu_torch.ops import events_cuda, events_device

    x = synthetic.simulated_pa(np.random.default_rng(64),
                               builtin_model("dna_r9_nucleotide"), 20_000)
    pa = torch.from_numpy(x).to(cuda)
    so = torch.tensor([0, x.shape[0]], device=cuda)
    monkeypatch.setattr(events_cuda, "peak_threads", lambda n: 2048)
    with pytest.raises(RuntimeError, match="CUDA error"):
        events_cuda.detect_events(pa, so, False)
    monkeypatch.undo()
    got = events_cuda.detect_events(pa, so, False)
    for g, w in zip(got, events_device.detect_events_plain(pa.cpu(), so.cpu(),
                                                          False)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("table_cap", [None, 1])
@pytest.mark.parametrize("case", ["mixed", "edges", "edges_tiled", "k9",
                                  "far"])
def test_viterbi_kernel_matches_plain_and_native(cuda, monkeypatch, case,
                                                 table_cap):
    """The chunk Viterbi (csrc/viterbi.cu), the movement tables in shared
    memory and all in the global scratch: the plain version's bytes,
    native.viterbi_chunk's movements, chunk by chunk.  The rounds: 200
    mixed chunks; the partition's edge chunks
    (synthetic.viterbi_edge_shapes: 1, 2, G - 1, G, G + 1, 96, 97 and
    REG_CAP k-mers on the register kernel, with REG_CAP + 1 and 400 on the
    tiled one; 1, 2 and 4,000 events; both strides of each kind); 200
    mixed chunks on the synthetic R10 9-mer tables; 200 mixed chunks, four
    of every five with an event, gm or gs outside the range of the
    register kernel's fast division, which so takes __fdiv_rn
    (synthetic.viterbi_far_round)."""
    from f5c_tpu_torch import native

    if table_cap is not None:
        monkeypatch.setattr(viterbi_cuda, "TABLE_SMEM_MAX", table_cap)
    model = (synthetic.k9_models()[0] if case == "k9"
             else builtin_model("dna_r9_nucleotide"))
    rng = np.random.default_rng(18)
    if case in ("edges", "edges_tiled"):
        x = synthetic.viterbi_round(rng, model, 0, shapes=(
            synthetic.viterbi_edge_shapes(viterbi_cuda.GROUP,
                                          viterbi_cuda.REG_CAP,
                                          case == "edges_tiled")))
    elif case == "far":
        x = synthetic.viterbi_far_round(rng, model, 200)
    else:
        x = synthetic.viterbi_round(rng, model, 200)
    t = _on({k: v for k, v in x.items() if k != "chunks"}, cuda)
    tables = [torch.as_tensor(np.asarray(v, np.float32), device=cuda)
              for v in (model.level_mean, model.level_stdv,
                        model.level_log_stdv)]
    mp = hmm.viterbi_max_path(x["spec_i32"][:, 2], x["spec_i32"][:, 5])
    args = (t["spec_i32"], t["spec_f32"], hmm.viterbi_consts(),
            t["rank_pool"], t["ev_pool"], *tables, mp)
    got = viterbi_cuda.viterbi_rounds(*args)
    want = hmm.viterbi_rounds_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    movs, ns = got[0].cpu().numpy(), got[1].cpu().numpy()
    for i, c in enumerate(x["chunks"]):
        mv = native.viterbi_chunk(
            c["ranks"], c["rank_start"], c["rank_stride"], c["n_kmers"],
            c["ev_pool"], c["e_start"], c["stride"], c["n_events"],
            c["scale"], c["shift"], c["var"], c["events_per_base"],
            model.level_mean, model.level_stdv, model.level_log_stdv)
        assert np.array_equal(hmm.unpack_movements(movs[i], int(ns[i])), mv)


def test_viterbi_fast_division_is_div_rn(cuda):
    """The chunk Viterbi's fast division (csrc/viterbi.cu div_rn<true>,
    taken where events and gm lie in +-[2^-30, 2^30) or are 0 and gs in
    [2^-60, 2^60)) against __fdiv_rn, bit for bit: a = e - gm as the
    kernel forms it and b = gs, over that whole range (exponents at its
    edges, ties of e and gm, zeros) and at eventalign's values."""
    from f5c_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(31)
    n = 1 << 21

    def moderate(lo, hi):
        x = (rng.uniform(1, 2, n) * np.exp2(rng.integers(lo, hi + 1, n))
             ).astype(np.float32) * rng.choice([-1, 1], n)
        x[rng.random(n) < 0.01] = 0
        return x.astype(np.float32)

    e, gm, gs = moderate(-30, 29), moderate(-30, 29), moderate(-60, 59)
    gs[gs == 0] = 1
    tie = rng.random(n) < 0.05
    gm[tie] = e[tie]
    near = rng.random(n) < 0.2                   # pA-like events and levels
    e[near] = rng.uniform(40, 160, near.sum())
    gm[near] = rng.uniform(40, 160, near.sum())
    gs[near] = rng.uniform(0.5, 8, near.sum())
    a = torch.from_numpy(e).to(cuda) - torch.from_numpy(gm).to(cuda)
    fast, ref = viterbi_cuda.division_probe(a, torch.from_numpy(gs).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(fast.view(torch.int32), ref.view(torch.int32))


def test_wrappers_launch_on_their_tensors_device(cuda):
    """Every wrapper (probes included) and HostCopy with another device
    current than its tensors' (on one card, ``torch.cuda.device(0)``
    around tensors on cuda:0, which still runs the guard): the kernels'
    results are their plain versions', as the tests above hold them."""
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.backend import HostCopy
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import (abea_ultra, abea_ultra_cuda, events_cuda,
                                   events_device)

    dev0 = torch.device("cuda", 0)
    other = 1 if torch.cuda.device_count() > 1 else 0
    rng = np.random.default_rng(41)
    nuc, cpg = (builtin_model("dna_r9_nucleotide"),
                builtin_model("dna_r9_cpg"))
    seqs, events = synthetic.abea_reads(rng, [20, 300, 1500], nuc)
    x = _on(synthetic.abea_inputs(seqs, events, nuc), dev0)
    fill_args = _fill_args(x)
    m = synthetic.hmm_meta_windows(rng, [1, 17, 40, 300, 2500], cpg)
    t = _on(m, dev0)
    hmm_args = [t[k] for k in HMM_META] + [m["k"]]
    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    pas = [f.get(r).to_pa() for r in f.read_ids()[:3]]
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    slab = torch.from_numpy(np.concatenate(pas)).to(dev0)
    so = torch.from_numpy(off).to(dev0)
    v = synthetic.viterbi_round(rng, nuc, 50)
    vt = _on({k: val for k, val in v.items() if k != "chunks"}, dev0)
    tables = [torch.as_tensor(np.asarray(a, np.float32), device=dev0)
              for a in (nuc.level_mean, nuc.level_stdv, nuc.level_log_stdv)]
    mp = hmm.viterbi_max_path(v["spec_i32"][:, 2], v["spec_i32"][:, 5])
    vit_args = (vt["spec_i32"], vt["spec_f32"], hmm.viterbi_consts(),
                vt["rank_pool"], vt["ev_pool"], *tables, mp)
    nb_max = int(np.diff(x["band_off"].cpu().numpy()).max())
    s0 = abea_ultra.initial_state(x["params"])
    pk = next(iter(synthetic.peak_probe_batches(rng, pas)))
    pk_args = (pk["t1"], pk["t2"], pk["sig_off"])
    with torch.cuda.device(other):
        assert torch.cuda.current_device() == other
        fill = abea_cuda.abea_fill(*fill_args, x["n_bands"])
        walk_args = (fill[0], fill[1], x["band_off"], fill[2], x["rk_len"],
                     x["byte_off"])
        walk = abea_cuda.abea_walk(*walk_args, x["n_bytes"])
        seq_ranks = abea_cuda.abea_ranks(x["seq_packed"], x["seq_off"],
                                         x["rk_len"], x["k"])
        win = abea_ultra_cuda.abea_fill_window(*fill_args, s0, 2, 97, 1,
                                               True)
        windowed = abea_ultra_cuda.abea_align_windowed(
            *fill_args, x["byte_off"], x["n_bytes"], nb_max, 300)
        scores = hmm_cuda.hmm_forward_meta(*hmm_args, n_narrow=m["n_narrow"],
                                           max_km=m["max_km"])
        ranks = hmm_cuda.hmm_window_ranks(t["meta"], t["packed_ref"],
                                          t["read_tab"], m["k"], m["max_km"])
        ev = events_cuda.detect_events(slab, so, False)
        sums = events_cuda.sums_tracks(slab, so, False)
        peaks = events_cuda.peaks_from_tracks(
            *(a.to(dev0) for a in pk_args), pk["rna"])
        vit = viterbi_cuda.viterbi_rounds(*vit_args)
        a = torch.linspace(-50, 50, 4096, device=dev0)
        fast, ref = viterbi_cuda.division_probe(a, torch.full_like(a, 3.0))
        host = HostCopy([walk[0], scores]).wait()
    torch.cuda.synchronize(dev0)
    for g, w in zip(fill, abea.abea_fill_packed_plain(*fill_args)):
        assert g.device == dev0 and torch.equal(g, w)
    for g, w in zip(walk, abea.abea_walk_plain(*walk_args)):
        assert torch.equal(g, w)
    assert torch.equal(seq_ranks, ranks_at_kmers(
        x["seq_packed"], x["seq_off"], x["rk_len"], x["k"]))
    for g, w in zip(win, abea_ultra.fill_window_packed_plain(
            *fill_args, s0, 2, 97, 1, True)):
        assert torch.equal(_bits(g), _bits(w))
    for g, w in zip(windowed, abea_cuda.abea_align(
            *fill_args, x["byte_off"], x["n_bands"], x["n_bytes"])):
        assert torch.equal(g, w)
    torch.testing.assert_close(scores, hmm_meta.hmm_forward_meta_plain(
        *hmm_args), rtol=hmm.RTOL, atol=hmm.ATOL)
    assert torch.equal(ranks, hmm_meta.build_inputs(
        t["meta"], t["packed_ref"], t["read_tab"], k=m["k"],
        kw=m["max_km"])[0])
    for g, w in zip(ev, events_device.detect_events_plain(slab, so, False)):
        assert torch.equal(g, w)
    for g, w in zip(sums, events_device.sums_tracks_model(slab, so, False)):
        assert torch.equal(g.cpu(), w)
    want_peaks = events_cuda.peaks_from_tracks(*pk_args, pk["rna"])
    assert peaks[0] == want_peaks[0]
    assert np.array_equal(peaks[1], want_peaks[1])
    for g, w in zip(vit, hmm.viterbi_rounds_plain(*vit_args)):
        assert torch.equal(g, w)
    assert torch.equal(fast.view(torch.int32), ref.view(torch.int32))
    assert np.array_equal(host[0], walk[0].cpu().numpy())
    assert np.array_equal(host[1], scores.cpu().numpy())
