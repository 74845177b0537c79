"""The port's CUDA kernels against their plain PyTorch versions, on the
card (csrc/abea.cu, csrc/hmm.cu; built with nvcc at first use).

ABEA must be bit-identical (trace, band placement, start event, walk
length and bytes); the HMM forward scores agree to ops/hmm.py's stated
f32 tolerance.  Without a CUDA device every test here skips; run them on
the card with ``python -m pytest tests/test_torch_kernels_cuda.py``; the
windowed ABEA kernels of csrc/abea_ultra.cu are held to the same bits.
"""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import abea, abea_cuda, hmm, hmm_cuda

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


@pytest.mark.parametrize("allow_pre,allow_post", [(True, True),
                                                  (False, False)])
def test_hmm_kernel_matches_plain(cuda, allow_pre, allow_post):
    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(12)
    n_kmers = [1, 5, 17, 31, 32, 33, 64, 100, 128, 129, 200, 300]
    x = _on(synthetic.hmm_windows(rng, n_kmers, model), cuda)
    args = [x[k] for k in ("ranks", "n_km", "ev_pool", "ev_start", "stride",
                           "n_ev", "scale", "shift", "var", "lp_stay",
                           "lp_step", "level_mean", "level_stdv",
                           "level_log_stdv")]
    got = hmm_cuda.hmm_forward(*args, allow_pre=allow_pre,
                               allow_post=allow_post)
    want = hmm.hmm_forward_plain(*args, allow_pre=allow_pre,
                                 allow_post=allow_post)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)


@pytest.mark.parametrize("n_kmers", [[600, 20], [2500], [5000]])
def test_hmm_kernel_wide_windows(cuda, n_kmers):
    """Windows whose state needs more than 48 KB of shared memory per
    block (the opt-in attribute), then 2 and 1 warps per block."""
    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(13)
    x = _on(synthetic.hmm_windows(rng, n_kmers, model), cuda)
    args = [x[k] for k in ("ranks", "n_km", "ev_pool", "ev_start", "stride",
                           "n_ev", "scale", "shift", "var", "lp_stay",
                           "lp_step", "level_mean", "level_stdv",
                           "level_log_stdv")]
    got = hmm_cuda.hmm_forward(*args)
    want = hmm.hmm_forward_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)


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
