"""The tile invariants the CUDA ABEA kernels rely on, checked on the plain
versions' own results.

The fill kernels (csrc/abea_band.cuh) stage a read's k-mers and events
for a tile of FILL_TILE bands from band b-1's lower-left corner; the walk
kernels (csrc/abea_walk.cuh) stage the trace rows of a tile of WALK_TILE
bands below the walk's top.  On seeded synthetic reads -- one ~20 kb read,
a chain of ~450 tiles, and short ones whose bands straddle the trim column
(k = -1) -- every cell the plain fill computes over any tile [b, b+T) lies
inside ``fill_tile_reach``, and every band the plain walk visits from a
tile's top lies inside ``walk_tile_reach`` of its tile; the kernels' shared
memory layout is the size the wrappers give them.
"""

import os
import re

import numpy as np
import pytest
import torch

from f5c_tpu_torch import synthetic
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import abea

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "f5c_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def plain():
    """The plain fill and walk of a 20,000-k-mer read and three short
    ones (one with events that do not follow it)."""
    rng = np.random.default_rng(91)
    model = builtin_model("dna_r9_nucleotide")
    seqs, events = synthetic.abea_reads(rng, [20_000, 40, 300, 1200], model,
                                        unrelated=(3,))
    x = synthetic.abea_inputs(seqs, events, model)
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in x.items()}
    trace, llk, start_e = abea.abea_fill_plain(*(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        "level_mean", "level_stdv", "level_log_stdv", "params",
        "band_off")))
    flat, n = abea.abea_walk_plain(trace, llk, t["band_off"], start_e,
                                   t["rk_len"], t["byte_off"])
    return dict(x=x, trace=abea.unpack_trace(trace).numpy(),
                llk=llk.numpy().astype(np.int64),
                start_e=start_e.numpy(), flat=flat.numpy(), n=n.numpy())


def _reads(p):
    x = p["x"]
    for i in range(x["ev_len"].shape[0]):
        b0, b1 = x["band_off"][i], x["band_off"][i + 1]
        yield i, int(x["ev_len"][i]), int(x["rk_len"][i]), b0, b1


@pytest.mark.parametrize("tile", [abea.FILL_TILE, 7])
def test_fill_tile_reach(plain, tile):
    """For every band b >= 2 taken as a tile's first band (a window of
    the windowed fill may start anywhere), the cells the plain fill
    computed in bands [b, b+tile) read k-mers and events in the reach of
    band b-1's corner."""
    checked = trimmed = 0
    for i, ne, nk, b0, b1 in _reads(plain):
        llk = plain["llk"][b0:b1]
        nb = b1 - b0
        bands = np.arange(nb)
        ll_e = bands - 2 - llk
        trace = plain["trace"][b0:b1]
        offs = np.arange(abea.PAD)
        k = llk[:, None] + offs
        e = ll_e[:, None] - offs
        computed = ((k >= 0) & (k < nk) & (e >= 0) & (e < ne)
                    & (offs < abea.BW))
        # the fill's cells are those and only those with a direction or
        # the trim column's stay; none outside the band
        assert not trace[~computed & (k != -1)].any()
        trimmed += int(((llk < 0) & (llk > -abea.BW)).sum())
        big = np.iinfo(np.int64).max
        kmin = np.where(computed, k, big).min(axis=1)
        kmax = np.where(computed, k, -1).max(axis=1)
        emin = np.where(computed, e, big).min(axis=1)
        emax = np.where(computed, e, -1).max(axis=1)

        def window(a, fill, reduce):
            """reduce(a[b : b+tile]) for every band b (past the end: fill)"""
            padded = np.concatenate([a, np.full(tile - 1, fill, a.dtype)])
            return reduce(np.lib.stride_tricks.sliding_window_view(
                padded, tile), axis=1)

        b = np.arange(2, nb)
        k_lo, k_hi, e_lo, e_hi = abea.fill_tile_reach(llk[b - 1],
                                                      ll_e[b - 1], tile)
        w_kmin = window(kmin, big, np.min)[b]
        has = w_kmin != big
        assert (w_kmin[has] >= k_lo[has]).all()
        assert (window(kmax, -1, np.max)[b][has] < k_hi[has]).all()
        assert (window(emin, big, np.min)[b][has] >= e_lo[has]).all()
        assert (window(emax, -1, np.max)[b][has] < e_hi[has]).all()
        checked += int(has.sum())
    assert checked > 50_000 and trimmed > 0
    span = abea.fill_tile_reach(0, 0, 2 * tile)
    assert abea.fill_ring_slots(tile) >= max(span[1] - span[0],
                                             span[3] - span[2])


def _walk_bands(p, i, nk, b0):
    """Bands the walk of read i visits, in order, decoded from its packed
    directions (0 step, 1 stay, 2 skip)."""
    x = p["x"]
    n = int(p["n"][i])
    dirs = p["flat"][x["byte_off"][i]:x["byte_off"][i + 1]]
    d = (dirs[:, None] >> (2 * np.arange(4))) & 3
    d = d.reshape(-1)[:n].astype(np.int64)
    dk = (d != 1).astype(np.int64)
    de = (d != 2).astype(np.int64)
    k = nk - 1 - np.concatenate([[0], np.cumsum(dk)[:-1]])
    e = int(p["start_e"][i]) - np.concatenate([[0], np.cumsum(de)[:-1]])
    return e + k + 2


@pytest.mark.parametrize("tile", [abea.WALK_TILE, 5])
def test_walk_tile_reach(plain, tile):
    """From any band the walk visits, taken as a tile's top (a window's
    walk starts anywhere), the walk stays in that tile, then enters the
    tile below it at that tile's top or one band below, and so on."""
    walked = 0
    for i, ne, nk, b0, b1 in _reads(plain):
        if plain["start_e"][i] < 0 or plain["n"][i] == 0:
            continue
        bands = _walk_bands(plain, i, nk, b0)
        assert bands[0] < b1 - b0
        steps = bands[:-1] - bands[1:]
        assert set(np.unique(steps)) <= {1, 2}
        for top_i in range(0, bands.shape[0], bands.shape[0] // 16 + 1):
            top = int(bands[top_i])
            rest = bands[top_i:]
            t = (top - rest) // tile
            dt = np.diff(t)
            assert ((dt == 0) | (dt == 1)).all()
            # each tile below the first is entered at its top or one
            # band below: the walk never skips a tile
            entry = rest[1:][dt == 1]
            _, hi = abea.walk_tile_reach(top - t[1:][dt == 1] * tile, tile)
            assert ((entry >= hi - 1) & (entry <= hi)).all()
        walked += bands.shape[0]
    assert walked > 30_000


def _constants(name):
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", text)}


def test_kernel_smem_matches_wrappers():
    """The kernels refuse a launch whose dynamic shared memory is not
    their layout's; the wrappers size it from the reach functions."""
    band = _constants("abea_band.cuh")
    walk = _constants("abea_walk.cuh")
    assert int(band["FILL_TILE"]) == abea.FILL_TILE
    assert int(band["RING"]) == abea.fill_ring_slots()
    assert int(walk["WALK_TILE"]) == abea.WALK_TILE
    assert band["FILL_SMEM"] == "RING * (16 + 4) + PAD * 12"
    assert band["TRACE_ROW"] == "PAD / 4"
    assert abea.TRACE_ROW_BYTES == abea.PAD // 4 == 32
    assert walk["WALK_SMEM"] == "2 * WALK_TILE * (TRACE_ROW + 4)"
    assert abea.fill_smem_bytes() == abea.fill_ring_slots() * 20 + 128 * 12
    assert abea.walk_smem_bytes() == 2 * abea.WALK_TILE * (32 + 4)
    assert abea.walk_smem_bytes() <= 48 * 1024
    assert abea.fill_smem_bytes() <= 48 * 1024
