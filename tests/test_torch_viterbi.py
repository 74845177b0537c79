"""The plain version of the chunk Viterbi (K8,
f5c_tpu_torch/ops/hmm.py:viterbi_rounds_plain, the CPU path of
ops/viterbi_cuda.py) against the JAX package's ``hmm_viterbi_rounds``
(XLA on the CPU), the port's host DP ``native.viterbi_chunk`` and the
NumPy oracle ``hmm_ref.profile_hmm_viterbi``: the same decoded path
(event, k-mer, state) on seeded synthetic chunks -- forward and reverse
strands, both event strides, and rounds that mix chunk sizes (the
patterns of tests/test_viterbi.py).  Against the port's host DP the
movements are the same bytes.
"""

import numpy as np
import pytest
import torch

from f5c_tpu.models import builtin_model as jax_model
from f5c_tpu.ops.abea_ref import Scalings
from f5c_tpu.ops.hmm import hmm_viterbi_rounds
from f5c_tpu.ops.hmm_ref import profile_hmm_viterbi, window_kmer_ranks
from f5c_tpu.pipeline.methylation import reverse_complement
from f5c_tpu_torch import native
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import hmm, viterbi_cuda

EPB = 1.8


def _chunk(rng, model, n_ref, rc, stride):
    """One chunk as tests/test_viterbi.py:_make_case builds it: a random
    window, events that roughly follow its k-mers, embedded in a larger
    event pool at e_start (read forward or backward)."""
    seq = "".join(rng.choice(list("ACGT"), n_ref))
    rc_seq = reverse_complement(seq)
    ranks = window_kmer_ranks(seq, rc_seq, rc, model).astype(np.int32)
    n_k = ranks.shape[0]
    n_ev = int(rng.integers(n_k // 2, 2 * n_k))
    which = np.sort(rng.integers(0, n_k, n_ev))
    means = (model.level_mean[ranks[which]]
             + rng.normal(0, 1.0, n_ev)).astype(np.float32)
    pool = rng.uniform(60, 120, n_ev + 200).astype(np.float32)
    if stride == 1:
        e_start = 100
        pool[e_start:e_start + n_ev] = means
    else:
        pool[100:100 + n_ev] = means[::-1]
        e_start = 100 + n_ev - 1
    sc = Scalings(shift=float(rng.uniform(-1, 1)),
                  scale=float(rng.uniform(0.95, 1.05)),
                  var=float(rng.uniform(0.9, 1.3)))
    return dict(seq=seq, rc_seq=rc_seq, ranks=ranks, pool=pool,
                e_start=e_start, n_ev=n_ev, stride=stride, rc=rc, sc=sc)


def _round(chunks, rank_stride):
    """The round's pools and specs: each chunk's ranks in one rank pool
    (walked backwards when ``rank_stride`` is -1), its events in one
    event pool."""
    rk_parts, ev_parts = [], []
    spec_i32 = np.zeros((len(chunks), 6), np.int32)
    spec_f32 = np.zeros((len(chunks), 6), np.float32)
    spec_jax = np.zeros((len(chunks), 5), np.float32)
    rk_off = ev_off = 0
    for i, c in enumerate(chunks):
        n_k = c["ranks"].shape[0]
        if rank_stride == 1:
            rk_parts.append(c["ranks"])
            r0 = rk_off
        else:
            rk_parts.append(c["ranks"][::-1])
            r0 = rk_off + n_k - 1
        ev_parts.append(c["pool"])
        spec_i32[i] = (r0, rank_stride, n_k, ev_off + c["e_start"],
                       c["stride"], c["n_ev"])
        sc = c["sc"]
        spec_f32[i] = (sc.scale, sc.shift, sc.var,
                       *hmm.viterbi_read_params(EPB, sc.var))
        p_stay = 1 - 1 / EPB
        spec_jax[i] = (sc.scale, sc.shift, sc.var, np.log(p_stay),
                       np.log(1 - p_stay - 0.0025 - 0.001))
        c["rank_start"] = r0 - rk_off
        c["rank_stride"] = rank_stride
        rk_off += n_k
        ev_off += c["pool"].shape[0]
    return (np.concatenate(rk_parts).astype(np.int32),
            np.concatenate(ev_parts), spec_i32, spec_f32, spec_jax)


def _decoded(movs, n_steps, spec_i32):
    out = []
    for i in range(spec_i32.shape[0]):
        mv = hmm.unpack_movements(movs[i], int(n_steps[i]))
        out.append(hmm.decode_viterbi_movements(
            mv, int(n_steps[i]), int(spec_i32[i, 3]), int(spec_i32[i, 4]),
            int(spec_i32[i, 5]), int(spec_i32[i, 2])))
    return out


def _check_round(chunks, rank_stride):
    model = builtin_model("dna_r9_nucleotide")
    rank_pool, ev_pool, spec_i32, spec_f32, spec_jax = _round(chunks,
                                                              rank_stride)
    max_path = hmm.viterbi_max_path(spec_i32[:, 2], spec_i32[:, 5])
    tables = [torch.from_numpy(np.asarray(t, np.float32)) for t in (
        model.level_mean, model.level_stdv, model.level_log_stdv)]
    movs, n_steps = viterbi_cuda.viterbi_rounds(
        torch.from_numpy(spec_i32), torch.from_numpy(spec_f32),
        hmm.viterbi_consts(), torch.from_numpy(rank_pool),
        torch.from_numpy(ev_pool), *tables, max_path)
    movs, n_steps = movs.numpy(), n_steps.numpy()
    assert movs.shape == (len(chunks), max_path // 2)
    ours = _decoded(movs, n_steps, spec_i32)

    import jax.numpy as jnp

    pad_k = int(spec_i32[:, 2].max())
    pad_e = int(spec_i32[:, 5].max())
    j_movs, j_steps = hmm_viterbi_rounds(
        jnp.asarray(spec_i32), jnp.asarray(spec_jax),
        jnp.asarray(rank_pool), jnp.asarray(ev_pool),
        jnp.asarray(model.level_mean), jnp.asarray(model.level_stdv),
        jnp.asarray(model.level_log_stdv), pad_events=pad_e, pad_k=pad_k,
        max_path=pad_e + pad_k + (pad_e + pad_k) % 2)
    theirs = _decoded(np.asarray(j_movs), np.asarray(j_steps), spec_i32)
    jm = jax_model("dna_r9_nucleotide")
    for i, c in enumerate(chunks):
        # the port's host DP: the same movements, byte for byte
        mv = native.viterbi_chunk(
            c["ranks"] if rank_stride == 1 else c["ranks"][::-1].copy(),
            c["rank_start"], rank_stride, c["ranks"].shape[0], c["pool"],
            c["e_start"], c["stride"], c["n_ev"], c["sc"].scale,
            c["sc"].shift, c["sc"].var, EPB, model.level_mean,
            model.level_stdv, model.level_log_stdv)
        assert n_steps[i] == mv.shape[0]
        np.testing.assert_array_equal(
            hmm.unpack_movements(movs[i], int(n_steps[i])), mv)
        # the JAX kernel and the NumPy oracle: the same decoded path
        e_off = int(spec_i32[i, 3]) - c["e_start"]
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
        oracle = profile_hmm_viterbi(
            c["seq"], c["rc_seq"], c["pool"], c["sc"], jm, c["e_start"],
            c["e_start"] + c["stride"] * (c["n_ev"] - 1), c["stride"],
            c["rc"], EPB)
        ev, km, ps = ours[i]
        assert len(oracle) == ev.shape[0]
        np.testing.assert_array_equal(ev - e_off, [o[0] for o in oracle])
        np.testing.assert_array_equal(km, [o[1] for o in oracle])
        np.testing.assert_array_equal(
            ps, [{"K": 0, "B": 1, "M": 2}[o[2]] for o in oracle])


@pytest.mark.parametrize("rc,stride", [(False, 1), (True, -1), (False, -1),
                                       (True, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_plain_matches_references(rc, stride, seed):
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(seed)
    chunks = [_chunk(rng, model, 105, rc, stride) for _ in range(3)]
    _check_round(chunks, rank_stride=1 if seed == 0 else -1)


def test_viterbi_round_of_mixed_chunks():
    """One round whose chunks differ in k-mers (12 to ~100) and events,
    on both strands and strides: the round's padding must not reach any
    chunk's path."""
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(7)
    chunks = [_chunk(rng, model, n, rc, st)
              for n, rc, st in ((105, False, 1), (17, True, -1),
                                (60, False, -1), (12, True, 1),
                                (101, True, -1), (40, False, 1))]
    _check_round(chunks, rank_stride=1)


@pytest.mark.parametrize("case", ["edges", "edges_tiled", "far"])
def test_viterbi_plain_edge_chunks(case):
    """The plain version (the wrapper's CPU path) on the kernel's edge
    chunks (synthetic.viterbi_edge_shapes: 1 to 400 k-mers, 1 to 4,000
    events, both strides of each kind) and on chunks whose events, gm or
    gs lie outside the register kernel's fast division
    (synthetic.viterbi_far_round): native.viterbi_chunk's movements, byte
    for byte."""
    from f5c_tpu_torch import synthetic

    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(23)
    if case == "far":
        x = synthetic.viterbi_far_round(rng, model, 40)
    else:
        shapes = synthetic.viterbi_edge_shapes(
            viterbi_cuda.GROUP, viterbi_cuda.REG_CAP, case == "edges_tiled")
        x = synthetic.viterbi_round(rng, model, 0, shapes=shapes)
        assert [c["n_kmers"] for c in x["chunks"]] == [s[0] for s in shapes]
    tables = [torch.from_numpy(np.asarray(t, np.float32)) for t in (
        model.level_mean, model.level_stdv, model.level_log_stdv)]
    mp = hmm.viterbi_max_path(x["spec_i32"][:, 2], x["spec_i32"][:, 5])
    movs, ns = viterbi_cuda.viterbi_rounds(
        torch.from_numpy(x["spec_i32"]), torch.from_numpy(x["spec_f32"]),
        hmm.viterbi_consts(), torch.from_numpy(x["rank_pool"]),
        torch.from_numpy(x["ev_pool"]), *tables, mp)
    for i, c in enumerate(x["chunks"]):
        mv = native.viterbi_chunk(
            c["ranks"], c["rank_start"], c["rank_stride"], c["n_kmers"],
            c["ev_pool"], c["e_start"], c["stride"], c["n_events"],
            c["scale"], c["shift"], c["var"], c["events_per_base"],
            model.level_mean, model.level_stdv, model.level_log_stdv)
        np.testing.assert_array_equal(
            hmm.unpack_movements(movs[i].numpy(), int(ns[i])), mv)


def _check_plan(nk, ne):
    """The invariants of a launch plan: the slots a permutation of the
    chunks, most events first; one chunk a block, its table of at most
    TABLE_SMEM_MAX bytes in shared memory after the block's state (the
    tiled path's, above REG_CAP k-mers) where it fits in MAX_SMEM; every
    other table in the scratch, packed in slot order."""
    plan, scratch, smem = viterbi_cuda.table_plan(nk, ne)
    order, off = plan
    assert sorted(order) == list(range(nk.shape[0]))
    assert list(ne[order]) == sorted(ne, reverse=True)
    k_max = int(nk.max())
    base = (viterbi_cuda.state_bytes(k_max)
            if k_max > viterbi_cuda.REG_CAP else 0)
    cells = ne[order] * (nk[order] + 1)
    glob, used = 0, 0
    for s in range(nk.shape[0]):
        if (cells[s] <= viterbi_cuda.TABLE_SMEM_MAX
                and base + cells[s] <= viterbi_cuda.MAX_SMEM):
            assert off[s] == -1 - base
            used = max(used, cells[s])
        else:
            assert off[s] == glob
            glob += cells[s]
    assert scratch == glob
    assert smem == base + used <= viterbi_cuda.MAX_SMEM
    return plan, scratch, smem


def test_viterbi_table_plan():
    """The launch plan: the round's chunks ordered by event count, one a
    block; a block keeps its chunk's movement table in shared memory up
    to TABLE_SMEM_MAX (after its state on the tiled path, above REG_CAP
    k-mers) and the others go to the global scratch, packed."""
    nk = np.array([95, 95, 95, 20], np.int64)
    ne = np.array([170, 4000, 100, 9000], np.int64)
    plan, scratch, smem = _check_plan(nk, ne)
    assert list(plan[0]) == [3, 1, 0, 2]
    assert list(plan[1]) == [0, 9000 * 21, -1, -1]
    assert scratch == 9000 * 21 + 4000 * 96
    assert smem == 170 * 96
    # full rounds of eventalign-sized chunks, some tables in the scratch
    rng = np.random.default_rng(7)
    for hi_ev in (400, 3000):
        nk = rng.integers(1, 97, 300)
        ne = rng.integers(1, hi_ev, 300)
        _check_plan(nk, ne)
    # the tiled path: its state first
    nk = np.array([400, 129, 3], np.int64)
    ne = np.array([50, 4000, 2], np.int64)
    plan, scratch, smem = _check_plan(nk, ne)
    base = viterbi_cuda.state_bytes(400)
    assert list(plan[0]) == [1, 0, 2]
    assert list(plan[1]) == [0, -1 - base, -1 - base]
    assert scratch == 4000 * 130 and smem == base + 50 * 401
    plan, scratch, smem = viterbi_cuda.table_plan(np.zeros(0, np.int64),
                                                  np.zeros(0, np.int64))
    assert plan.shape == (2, 0) and scratch == smem == 0
