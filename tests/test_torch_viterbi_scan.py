"""The chunk Viterbi kernels' partitioned KMER_SKIP running max
(csrc/viterbi.cu: the register kernel's lane-to-lane hand-off, the tiled
kernel's skip_scan; their plain model
f5c_tpu_torch/ops/hmm.py:skip_chain_partitioned) against the torch.cummax
form that viterbi_rounds_plain runs (skip_chain), bit for bit: the running
max, the codes (PREV_K / PREV_B / PREV_M) and K = ig + running max, for
every partition of lanes and items the kernels are built with
(viterbi_cuda.partitions: the register kernel's one tile of 32q columns,
on rows of 1 to 32q columns; the tiled kernel's tiles of 128 columns,
which carry the running max, on rows of 1 to 300), with many exact ties,
runs of -inf, all--inf rows, and zeros of both signs.
"""

import numpy as np
import pytest
import torch

from f5c_tpu_torch.ops import hmm, viterbi_cuda

NEG = -np.inf


def _rows(rng, n_rows: int, k: int):
    """(c1, c2) f32 [n_rows, k]: values from a few levels (so that d and
    c tie often, c1 == c2 included), runs of -inf, rows all -inf, and
    +0 / -0."""
    levels = np.array([-7.5, -3.0, -1.0, -0.0, 0.0, 2.0, 4.25, NEG],
                      np.float32)
    c1 = levels[rng.integers(0, levels.size, (n_rows, k))]
    c2 = levels[rng.integers(0, levels.size, (n_rows, k))]
    same = rng.random((n_rows, k)) < 0.2
    c2[same] = c1[same]
    for r in range(n_rows):
        if r % 4 == 1:                       # a run of -inf
            a = int(rng.integers(0, k))
            b = int(rng.integers(a, k + 1))
            c1[r, a:b] = c2[r, a:b] = NEG
        elif r % 4 == 2:                     # every column -inf
            c1[r] = c2[r] = NEG
    return torch.from_numpy(c1), torch.from_numpy(c2)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("group,items,lanes", viterbi_cuda.partitions())
def test_partitioned_skip_scan_equals_cummax(group, items, lanes):
    rng = np.random.default_rng(100 * group + items + (lanes == "carry"))
    lp_kk = torch.tensor(float(hmm.viterbi_consts()[4]))
    widest = group * items if lanes == "carry" else 300
    for k in range(1, widest + 1):
        c1, c2 = _rows(rng, 8, k)
        cols = torch.arange(k, dtype=torch.float32)
        for ig in (torch.zeros(k), cols * lp_kk):
            want_incl, want_kc = hmm.skip_chain(c1, c2, ig)
            got_incl, got_kc = hmm.skip_chain_partitioned(
                c1, c2, ig, group, items, lanes)
            assert torch.equal(got_kc, want_kc), (k, group, items)
            # equal values; only +0 and -0 may trade places
            assert torch.equal(got_incl, want_incl), (k, group, items)
            if ig[-1] != 0:
                # K = ig + incl, the kernel's output, bit for bit
                assert _same_bits(ig + got_incl, ig + want_incl)


def test_partitions_cover_the_kernels():
    """Every launch's partition is among those tested: the register
    kernel's at each chunk width, one tile wide enough for the chunk; the
    tiled kernel's above REG_CAP k-mers."""
    parts = set(viterbi_cuda.partitions())
    g = viterbi_cuda.GROUP
    for k_max in range(1, 400):
        items = viterbi_cuda.items_of(k_max)
        if k_max <= viterbi_cuda.REG_CAP:
            assert (g, items, "carry") in parts
            assert g * items >= k_max          # one tile on this path
        else:
            assert (32, items, "shuffle") in parts
    with pytest.raises(ValueError):
        c = torch.zeros(1, 33)
        hmm.skip_chain_partitioned(c, c, torch.zeros(33), 32, 1, "carry")
