"""The port's integer device ops against the native host library and the
JAX package, bit for bit:

- ranks_from_packed (K11's plain version) == native.kmer_ranks on every
  position a read's ABEA fill consumes, and the rank probe's CPU path
  (abea_cuda.abea_ranks: ranks at every read's k-mers, 0 elsewhere) on
  the probe's cases (reads at every offset mod 4, Ns, a read of one
  k-mer) at k = 5, 6 and 9;
- hmm_meta.build_inputs (K6) == native.hmm_window_ranks (ranks, n_km) and
  == the JAX hmm_meta.build_inputs (every per-window array), on forward
  and reverse strands, methylated windows and the window-edge cases the
  global rank planes correct (the cases of tests/test_hmm_meta_ranks.py).
"""

import numpy as np
import pytest
import torch

from f5c_tpu import native
from f5c_tpu_torch.ops import hmm_meta
from f5c_tpu_torch.ops.seq_ranks import (pack_codes, pack_seqs,
                                         ranks_from_packed, seq_codes)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable")

K = 6


@pytest.mark.parametrize("k", [5, 6, 9])
def test_ranks_from_packed_match_native(k):
    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGT"), int(n)))
            for n in rng.integers(k, 300, 12)]
    seqs.append("ACGTNACGTTGCANNACGT")   # N ranks as A, as natively
    packed, off = pack_seqs(seqs)
    ranks = ranks_from_packed(torch.from_numpy(packed), k).numpy()
    for s, o in zip(seqs, off):
        want = native.kmer_ranks(s, k)
        np.testing.assert_array_equal(ranks[o:o + want.shape[0]], want)


@pytest.mark.parametrize("k", [5, 6, 9])
def test_rank_probe_plain_matches_native(k):
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.ops import abea_cuda

    seqs = synthetic.abea_rank_cases(np.random.default_rng(k), k)
    packed, off = pack_seqs(seqs)
    rk_len = np.array([len(s) - k + 1 for s in seqs], np.int32)
    assert set(off % 4) == {0, 1, 2, 3} and rk_len.min() == 1
    got = abea_cuda.abea_ranks(torch.from_numpy(packed),
                               torch.from_numpy(off),
                               torch.from_numpy(rk_len), k).numpy()
    want = np.zeros(4 * packed.shape[0], np.int32)
    for s, o in zip(seqs, off):
        ranks = native.kmer_ranks(s, k)
        want[o:o + ranks.shape[0]] = ranks
    np.testing.assert_array_equal(got, want)
    assert got.max() > 4 ** (k - 1)


def test_rank_probe_refuses_partial_words():
    """The kernels read the packed sequences by 32-bit words: a buffer of
    another length is refused on every device (pack_seqs pads)."""
    from f5c_tpu_torch.ops import abea_cuda

    packed, off = pack_seqs(["ACGTACGTA", "TTGCA"])
    assert packed.shape[0] % 4 == 0
    rk_len = torch.tensor([4, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="whole 4-byte-aligned"):
        abea_cuda.abea_ranks(torch.from_numpy(packed[:-1]),
                             torch.from_numpy(off), rk_len, 6)


def _run_case(refs, items, read_rc):
    """items: (read, sub_start, sub_end, meth)."""
    from f5c_tpu.ops import hmm_meta as jax_meta

    SEG = 32
    n = len(items)
    ref_off = np.zeros(len(refs), np.int64)
    np.cumsum([len(r) for r in refs][:-1], out=ref_off[1:])
    ref_concat = b"".join(refs)
    it_read = np.array([i[0] for i in items], np.int32)
    it_ss = np.array([i[1] for i in items], np.int64)
    it_se = np.array([i[2] for i in items], np.int64)
    it_meth = np.array([i[3] for i in items], np.uint8)
    rc = np.asarray(read_rc, np.uint8)
    n_alloc = 128 // SEG * 8
    ranks_n, n_km_n = native.hmm_window_ranks(
        n, n_alloc, SEG, K, ref_concat, ref_off, it_read, it_ss, it_se,
        it_meth, rc, 15625)

    rng = np.random.default_rng(n)
    read_tab = np.zeros((8, 8), np.float32)
    read_tab[:, :5] = rng.uniform(0.5, 1.5, (8, 5))
    read_tab[:len(rc), 5] = rc
    gstart = (ref_off[it_read] + it_ss).astype(np.int32)
    wlen = (it_se - it_ss + 1).astype(np.int32)
    n_ev_s = rng.integers(1, 50, n) * np.where(rng.random(n) < 0.5, -1, 1)
    meta = np.zeros((n_alloc, 16), np.uint8)
    meta[:n] = hmm_meta.pack_meta(gstart, rng.integers(0, 1000, n), n_ev_s,
                                  wlen, it_meth, it_read)
    packed = pack_codes(seq_codes(ref_concat + b"\0" * 8))
    got = hmm_meta.build_inputs(torch.from_numpy(meta),
                                torch.from_numpy(packed),
                                torch.from_numpy(read_tab), k=K, kw=SEG)
    got = [g.numpy() for g in got]
    for i in range(n):
        nk = n_km_n[i]
        assert got[1][i] == nk, i
        np.testing.assert_array_equal(got[0][i, :nk], ranks_n[i, :nk])

    want = jax_meta.build_inputs(meta, packed, read_tab, SEG=SEG, k=K,
                                 use_i16=True)
    want = [np.asarray(w).reshape(n_alloc, -1) for w in want]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w.reshape(-1))


def test_window_edges_fwd_and_rc():
    #        0123456789012345678
    ref0 = b"AACGTACGTTTCGGATTCG"   # CpGs at 2,6,11,17
    ref1 = b"GGTACGTACCGTAAACGTA"   # starts with G (rc-edge bait)
    items = [(0, 8, 17, 1), (0, 8, 17, 0), (0, 8, 18, 1), (1, 10, 18, 1),
             (1, 10, 18, 0), (1, 2, 12, 1), (0, 6, 17, 1)]
    _run_case([ref0, ref1], items, read_rc=[0, 1])


@pytest.mark.parametrize("read_rc", [[0, 0], [1, 1]])
def test_cross_read_boundary_c_then_g(read_rc):
    # ref0 ends in C, ref1 begins with G: the concat plane fabricates a
    # CpG across the read boundary; window-local semantics must win
    ref0 = b"ATTACGTACATTACCTAGC"
    ref1 = b"GATTACAGGATCCGATTAC"
    items = [(0, 7, 18, 1), (0, 7, 18, 0), (1, 0, 11, 1), (1, 0, 11, 0)]
    _run_case([ref0, ref1], items, read_rc=read_rc)


def test_random_windows():
    rng = np.random.default_rng(7)
    refs = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                       int(rng.integers(60, 120))).tobytes()
            for _ in range(3)]
    items = []
    for _ in range(24):
        rd = int(rng.integers(0, 3))
        L = len(refs[rd])
        ss = int(rng.integers(0, L - K - 2))
        se = int(rng.integers(ss + K - 1, min(ss + 37, L - 1)))
        items.append((rd, ss, se, int(rng.integers(0, 2))))
    _run_case(refs, items, read_rc=[0, 1, 1])


@pytest.mark.parametrize("case", range(8))
def test_rank_probe_cases_match_jax(case):
    """The rank probe's cases (synthetic.rank_cases: the cases above, and
    windows at both ends of the concat, with and without the zero
    sentinel, where the rank planes wrap): the probe's CPU path (the
    port's build_inputs) == the JAX build_inputs, bit for bit."""
    from f5c_tpu.ops import hmm_meta as jax_meta

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.ops import hmm_cuda

    SEG = 32
    cases = synthetic.rank_cases(np.random.default_rng(15), K)
    assert len(cases) == 8
    c = cases[case]
    n = c["meta"].shape[0]
    meta = np.zeros((-(-n // 4) * 4, 16), np.uint8)   # whole SEG=32 rows
    meta[:n] = c["meta"]
    got = hmm_cuda.hmm_window_ranks(
        torch.from_numpy(meta), torch.from_numpy(c["packed_ref"]),
        torch.from_numpy(c["read_tab"]), K, SEG).numpy()
    want = jax_meta.build_inputs(meta, c["packed_ref"], c["read_tab"],
                                 SEG=SEG, k=K, use_i16=False)[0]
    np.testing.assert_array_equal(got, np.asarray(want).reshape(-1, SEG))
    assert c["kw"] <= SEG and (got[:n, 0] > 0).any()
