"""The port's plain HMM forward pass (f5c_tpu_torch/ops/hmm.py) against
the JAX package and the NumPy oracle, to ops/hmm.py's stated f32
tolerance |got - want| <= RTOL*|want| + ATOL, with the pre/post soft
clips both allowed and not:

- the Pallas scorer hmm_forward_pallas in interpret mode, at SEG=32 and
  SEG=128 (one program of 16 rows each);
- the XLA scan hmm.hmm_forward_packed, for windows wider than 128 k-mers;
- the oracle hmm_ref.profile_hmm_score (hmm.c semantics, f64 sums);
- the whole fused scorer: the port's hmm_meta.hmm_forward_meta_plain
  (window metadata in, scores out) against the JAX
  hmm_meta.hmm_forward_meta in interpret mode.

And on the host: the launch order of the fused kernel (narrow windows
first, two to a warp) covers every window once and hands the scores
back in the caller's order.

The XLA scan solves the KMER_SKIP chain by renormalising every prefix by
the window's global max in f32; where a window's terms span more than
~88 nats, the early k-mers' prefixes underflow to 0 (ROADMAP.md Queue 3,
R4).  The wide-window test therefore holds the port to the same
recurrence run in float64 on every window, and to the XLA scan on the
windows where the XLA scan itself is within tolerance of float64.
"""

import numpy as np
import pytest
import torch

from f5c_tpu.constants import HAF_ALLOW_POST_CLIP, HAF_ALLOW_PRE_CLIP
from f5c_tpu.models import builtin_model
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import hmm, hmm_cuda, hmm_meta

ARGS = ("ranks", "n_km", "ev_pool", "ev_start", "stride", "n_ev", "scale",
        "shift", "var", "lp_stay", "lp_step", "level_mean", "level_stdv",
        "level_log_stdv")
WINDOW = ("n_km", "ev_start", "stride", "n_ev", "scale", "shift", "var",
          "lp_stay", "lp_step")


def _port(x, allow_pre, allow_post):
    t = [torch.from_numpy(np.array(x[k])) for k in ARGS]
    return hmm.hmm_forward_plain(*t, allow_pre=allow_pre,
                                 allow_post=allow_post).numpy()


def _tensors(x):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in x.items()}


META_ARGS = ("meta", "packed_ref", "read_tab", "ev_pool", "level_mean",
             "level_stdv", "level_log_stdv", "k")


def _close(got, want):
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)


@pytest.mark.parametrize("seg,allow", [(32, True), (128, False)])
def test_plain_matches_pallas_interpret(seg, allow):
    from f5c_tpu.ops.hmm_pallas import RT, hmm_forward_pallas

    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(seg)
    segs = 128 // seg
    n_win = RT * segs
    n_km = rng.integers(max(seg // 4, 1), seg + 1, n_win)
    x = synthetic.hmm_windows(rng, n_km, model, kw=seg)
    got = _port(x, allow, allow)
    ranks = x["ranks"].reshape(RT, 128)
    per_win = [x[k].reshape(RT, segs) for k in WINDOW]
    want = hmm_forward_pallas(
        ranks, per_win[0], x["ev_pool"], *per_win[1:], x["level_mean"],
        x["level_stdv"], x["level_log_stdv"], SEG=seg, allow_pre=allow,
        allow_post=allow, interpret=True)
    _close(got, np.asarray(want).reshape(-1))


@pytest.mark.parametrize("allow", [True, False])
def test_plain_matches_xla_wide_windows(allow):
    from f5c_tpu.ops.hmm import hmm_forward_packed

    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(5)
    n_km = [129, 150, 200, 256, 300, 140]
    x = synthetic.hmm_windows(rng, n_km, model)
    got = _port(x, allow, allow)
    t64 = [torch.from_numpy(np.array(x[k], np.float64 if x[k].dtype
                                     == np.float32 else x[k].dtype))
           for k in ARGS]
    exact = hmm.hmm_forward_plain(*t64, allow_pre=allow,
                                  allow_post=allow).numpy()
    _close(got, exact)
    xla = np.asarray(hmm_forward_packed(
        *(x[k] for k in ARGS), pad_events=int(x["n_ev"].max()),
        allow_pre=allow, allow_post=allow))
    xla_ok = np.abs(xla - exact) <= hmm.RTOL * np.abs(exact) + hmm.ATOL
    assert xla_ok.sum() >= len(n_km) - 1
    _close(got[xla_ok], xla[xla_ok])


@pytest.mark.parametrize("allow", [True, False])
def test_plain_matches_oracle(allow):
    from f5c_tpu.ops.abea_ref import Scalings
    from f5c_tpu.ops.hmm_ref import profile_hmm_score, window_kmer_ranks
    from f5c_tpu.pipeline.methylation import (methylate,
                                              reverse_complement_meth)

    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(9)
    flags = (HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP) if allow else 0
    events = (rng.normal(85.0, 12.0, 400)).astype(np.float32)
    want, rows = [], []
    for i, nk in enumerate([6, 11, 25, 32, 60, 140]):
        seq = synthetic.random_seq(rng, nk + model.k - 1)
        m_seq = methylate(seq) if i % 2 else seq
        rc = i % 3 == 0
        ranks = window_kmer_ranks(m_seq, reverse_complement_meth(m_seq), rc,
                                  model)
        ne = int(rng.integers(nk // 2 + 1, 2 * nk))
        e1 = int(rng.integers(0, 400 - ne))
        e1, e2, st = (e1, e1 + ne - 1, 1) if i % 2 else (e1 + ne - 1, e1, -1)
        sc = Scalings(shift=float(rng.uniform(-2, 2)),
                      scale=float(rng.uniform(0.9, 1.1)),
                      var=float(rng.uniform(1.0, 1.5)))
        epb = float(rng.uniform(1.3, 2.5))
        want.append(profile_hmm_score(
            m_seq, reverse_complement_meth(m_seq), events, sc, model, e1,
            e2, st, rc, epb, hmm_flags=flags))
        rows.append((ranks, nk, e1, st, ne, sc, epb))
    kw = 160
    lp_stay, lp_step = hmm.transition_params(
        np.array([r[6] for r in rows], np.float32))
    x = dict(
        ranks=np.stack([np.pad(r[0], (0, kw - r[1])) for r in rows]).astype(
            np.int32),
        n_km=np.array([r[1] for r in rows], np.int32), ev_pool=events,
        ev_start=np.array([r[2] for r in rows], np.int64),
        stride=np.array([r[3] for r in rows], np.int32),
        n_ev=np.array([r[4] for r in rows], np.int32),
        scale=np.array([r[5].scale for r in rows], np.float32),
        shift=np.array([r[5].shift for r in rows], np.float32),
        var=np.array([r[5].var for r in rows], np.float32),
        lp_stay=lp_stay, lp_step=lp_step, level_mean=model.level_mean,
        level_stdv=model.level_stdv, level_log_stdv=model.level_log_stdv)
    _close(_port(x, allow, allow), np.array(want))


def test_meta_plain_matches_jax_meta_interpret():
    """One synthetic meta batch (64 windows of <= 32 k-mers at SEG=32, one
    Pallas program; a CpG-rich random reference, forward and reverse
    reads, both meth values, window-edge CpGs; soft clips on, where the
    JAX scorer is exact): the port's fused plain version against the JAX
    build_inputs + Pallas scorer."""
    from f5c_tpu.ops.hmm_meta import hmm_forward_meta

    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(21)
    x = synthetic.hmm_meta_windows(rng, rng.integers(1, 33, 64), model,
                                   ordered=False)
    t = _tensors(x)
    got = hmm_meta.hmm_forward_meta_plain(*(t[k] for k in META_ARGS))
    want = hmm_forward_meta(*(x[k] for k in META_ARGS[:-1]), SEG=32,
                            k=x["k"], use_i16=True, interpret=True)
    _close(got.numpy(), np.asarray(want).reshape(-1))


def test_window_order_and_class_split():
    """order_windows is a permutation with the narrow class (<= 16
    k-mers, empty windows included) first, each class by event count,
    longest first; launch_shape counts its warps; scores of the launch
    order, put back through the order, equal the caller-order scores."""
    rng = np.random.default_rng(22)
    n_km = rng.integers(-4, 80, 300)
    n_ev = rng.integers(1, 200, 300)
    order, n_narrow = hmm_cuda.order_windows(n_km, n_ev)
    np.testing.assert_array_equal(np.sort(order), np.arange(300))
    assert n_narrow == int((n_km <= hmm_cuda.NARROW).sum())
    km, ev = n_km[order], n_ev[order]
    assert (km[:n_narrow] <= hmm_cuda.NARROW).all()
    assert (km[n_narrow:] > hmm_cuda.NARROW).all()
    for cls in (ev[:n_narrow], ev[n_narrow:]):
        assert (np.diff(cls) <= 0).all()
    shape = hmm_cuda.launch_shape(km, ev, n_narrow)
    assert shape["warps"] == (n_narrow + 1) // 2 + 300 - n_narrow
    assert shape["windows"] == 300 and shape["narrow"] == n_narrow

    model = builtin_model("dna_r9_cpg")
    x = synthetic.hmm_meta_windows(rng, [3, 40, 0, 16, 17, 1, 33, 9],
                                   model, ordered=False)
    order, n_narrow = hmm_cuda.order_windows(x["n_km"], x["n_ev"])
    t = _tensors(x)
    want = hmm_cuda.hmm_forward_meta(*(t[k] for k in META_ARGS)).numpy()
    ordered = dict(t, meta=t["meta"][torch.from_numpy(order)])
    got = np.empty_like(want)
    got[order] = hmm_cuda.hmm_forward_meta(
        *(ordered[k] for k in META_ARGS), n_narrow=n_narrow).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(want[2]) and np.isfinite(np.delete(want, 2)).all()
