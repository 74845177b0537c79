"""The port's plain ABEA (f5c_tpu_torch/ops/abea.py) against the JAX
package, bit for bit: start event, walk length and the first n walk
directions (bytes past n are unspecified).

- the production Pallas ring kernel, abea_align_device_ring in interpret
  mode, at the __graft_entry__.entry() shape (one call);
- the XLA path abea.abea_fill + abea_backtrace_packed;
- the NumPy oracle abea_ref.align (align.c semantics).

The XLA and oracle cases use mixed read lengths: n_kmers below and above
128, reads short enough that their whole band straddles the trim column,
and one read whose events do not follow its sequence (it fails QC).
"""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model
from f5c_tpu.ops.abea_ref import Scalings
from f5c_tpu_torch import synthetic
from f5c_tpu_torch.ops import abea_cuda
from f5c_tpu_torch.ops.abea import band_offsets

N_KMERS = [20, 45, 100, 127, 128, 129, 250, 400]
UNRELATED = 6


def _dirs(flat, off, n):
    """First n 2-bit walk directions of one read."""
    b = np.asarray(flat[off:off + (n + 3) // 4], np.uint8)
    d = np.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], 1)
    return d.reshape(-1)[:n]


def _run_port(x: dict):
    t = {k: (torch.from_numpy(np.array(v))
             if isinstance(v, np.ndarray) else v) for k, v in x.items()}
    flat, start_e, n = abea_cuda.abea_align(
        *(t[k] for k in ("ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off",
                         "rk_len", "level_mean", "level_stdv",
                         "level_log_stdv", "params", "band_off",
                         "byte_off", "n_bands", "n_bytes")))
    return flat.numpy(), start_e.numpy(), n.numpy()


@pytest.fixture(scope="module")
def mixed():
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(3)
    seqs, events = synthetic.abea_reads(rng, N_KMERS, model,
                                        unrelated=(UNRELATED,))
    B = len(seqs)
    scale = rng.uniform(0.97, 1.03, B).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    x = synthetic.abea_inputs(seqs, events, model, scale, shift)
    return model, seqs, events, scale, shift, x, _run_port(x)


def test_plain_matches_ring_kernel_interpret():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    flat_j, start_j, n_j = (np.asarray(a) for a in fn(*args))
    (ev, ev_off, ev_len, rk, rk_off, rk_len, lm, ls, ll, scale, shift,
     lp_stay, lp_step, lp_skip, lp_trim, off) = (np.asarray(a) for a in args)
    byte_off = off.astype(np.int64)
    band_off = band_offsets(ev_len, rk_len)
    flat, start_e, n = _run_port(dict(
        ev_pool=ev, ev_off=ev_off.astype(np.int64), ev_len=ev_len,
        rk_pool=rk, rk_off=rk_off.astype(np.int64), rk_len=rk_len,
        level_mean=lm, level_stdv=ls, level_log_stdv=ll,
        params=np.stack([scale, shift, lp_stay, lp_step, lp_skip, lp_trim],
                        axis=1),
        band_off=band_off, byte_off=byte_off, n_bands=int(band_off[-1]),
        n_bytes=int(byte_off[-1])))
    np.testing.assert_array_equal(start_e, start_j)
    np.testing.assert_array_equal(n, n_j)
    assert n.min() > 0
    for i in range(ev_len.shape[0]):
        np.testing.assert_array_equal(
            _dirs(flat, byte_off[i], n[i]), _dirs(flat_j, off[i], n_j[i]))


def test_plain_matches_xla_fill_and_walk(mixed):
    from f5c_tpu.ops import abea

    model, seqs, events, scale, shift, x, (flat, start_e, n) = mixed
    ranks = [model.kmer_ranks(s) for s in seqs]
    scalings = [Scalings(shift=float(b), scale=float(a))
                for a, b in zip(scale, shift)]
    batch = abea.make_batch(events, ranks, model, scalings=scalings)
    E = batch.event_means.shape[1] - 2 * abea.PAD
    K = batch.kmer_mean.shape[1] - 2 * abea.PAD
    fill = abea.abea_fill(batch, n_bands=E + K + 2)
    packed, start_x, n_x, *_ = abea.abea_backtrace_packed(
        fill, batch, max_pairs=-(-(E + K) // 4) * 4)
    packed, start_x, n_x = (np.asarray(a) for a in (packed, start_x, n_x))
    np.testing.assert_array_equal(n, n_x)
    assert (n > 0).all()
    np.testing.assert_array_equal(start_e, start_x)
    for i in range(len(seqs)):
        np.testing.assert_array_equal(_dirs(flat, x["byte_off"][i], n[i]),
                                      _dirs(packed[i], 0, n_x[i]))


def test_plain_matches_numpy_oracle(mixed):
    from f5c_tpu.ops.abea import decode_packed_dirs
    from f5c_tpu.ops.abea_ref import align

    model, seqs, events, scale, shift, x, (flat, start_e, n) = mixed
    n_failed = 0
    for i, (seq, ev) in enumerate(zip(seqs, events)):
        ref = align(seq, ev, model, Scalings(shift=float(shift[i]),
                                             scale=float(scale[i])))
        assert n[i] == ref.n_aligned, i
        n_failed += ref.failed
        if ref.failed:
            continue
        pairs = decode_packed_dirs(flat[x["byte_off"][i]:], int(n[i]),
                                   int(start_e[i]), int(x["rk_len"][i]))
        np.testing.assert_array_equal(pairs, ref.pairs, err_msg=str(i))
        assert start_e[i] == ref.pairs[-1, 1]
    assert n_failed == 1
