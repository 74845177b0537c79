"""The port's CUDA kernels against their plain PyTorch versions, on the
card (csrc/abea.cu, csrc/hmm.cu, csrc/events.cu, csrc/viterbi.cu; built
with nvcc at first use).

ABEA must be bit-identical (trace, band placement, start event, walk
length and bytes); the fused HMM forward scores (window metadata in)
agree to ops/hmm.py's stated f32 tolerance, and the ranks its prologue
computes (the rank probe) equal build_inputs' bit for bit.  Without a
CUDA device every test here skips; run them on the card with ``python -m
pytest tests/test_torch_kernels_cuda.py``; the windowed ABEA kernels of
csrc/abea_ultra.cu are held to the same bits, and the event detector and
the chunk Viterbi to their plain versions and the host code bit for bit.
"""

import numpy as np
import pytest
import torch

from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import abea, abea_cuda, hmm, hmm_cuda, hmm_meta

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


def test_abea_kernels_match_plain(cuda):
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(11)
    n_kmers = [20, 64, 127, 128, 129, 300, 700, 1500, 45, 90, 5000]
    seqs, events = synthetic.abea_reads(rng, n_kmers, model, unrelated=(8,))
    x = _on(synthetic.abea_inputs(seqs, events, model), cuda)
    fill_args = [x[k] for k in ("ev_pool", "ev_off", "ev_len", "rk_pool",
                                "rk_off", "rk_len", "level_mean",
                                "level_stdv", "level_log_stdv", "params",
                                "band_off")]
    got = abea_cuda.abea_fill(*fill_args, x["n_bands"])
    want = abea.abea_fill_plain(*fill_args)
    torch.cuda.synchronize()
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
    fill_args = [x[k] for k in ("ev_pool", "ev_off", "ev_len", "rk_pool",
                                "rk_off", "rk_len", "level_mean",
                                "level_stdv", "level_log_stdv", "params",
                                "band_off")]
    got = abea_cuda.abea_fill(*fill_args, x["n_bands"])
    want = abea.abea_fill_plain(*fill_args)
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
    args = [x[k] for k in ("ev_pool", "ev_off", "ev_len", "rk_pool",
                           "rk_off", "rk_len", "level_mean", "level_stdv",
                           "level_log_stdv", "params", "band_off")]
    nb_max = int(np.diff(x["band_off"].cpu().numpy()).max())
    nw = abea_ultra.n_windows(nb_max, win)
    s0 = abea_ultra.initial_state(x["params"])
    got = abea_ultra_cuda.abea_fill_window(*args, s0, 2, win, nw, False)
    want = abea_ultra.fill_window_plain(*args, s0, 2, win, nw, False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    w = nw - 1
    state = want[0][:, w - 1].contiguous() if w else s0
    base = 2 + w * win
    got = abea_ultra_cuda.abea_fill_window(*args, state, base, win, 1, True)
    want = abea_ultra.fill_window_plain(*args, state, base, win, 1, True)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("table_cap", [None, 1])
def test_viterbi_kernel_matches_plain_and_native(cuda, monkeypatch,
                                                 table_cap):
    """The chunk Viterbi (csrc/viterbi.cu) on a synthetic round of mixed
    chunks, with the movement tables in shared memory and all in the
    global scratch: the plain version's bytes, native.viterbi_chunk's
    movements."""
    from f5c_tpu_torch import native
    from f5c_tpu_torch.ops import viterbi_cuda

    if table_cap is not None:
        monkeypatch.setattr(viterbi_cuda, "TABLE_SMEM_MAX", table_cap)
    model = builtin_model("dna_r9_nucleotide")
    x = synthetic.viterbi_round(np.random.default_rng(18), model, 200)
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
