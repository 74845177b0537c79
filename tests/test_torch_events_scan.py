"""The plain model of K9's prefix sums and assembly (the kernels of
csrc/events.cu: a grid over every tile of every read, the tile totals,
their scan and the rescan from each tile's carry, the check at every
sample, the sequential redo; one thread an event, its read found by a
binary search), f5c_tpu_torch/ops/events_device.py:prefix_sums_tiled,
owner and detect_events_model, against the sample-order sums
``prefix_sums``, the host detector ``native.detect_events`` and the JAX
package's ``detect_events_batch`` (eager), bit for bit: on the golden
signals, all of synthetic.event_signals (DNA and RNA), lengths around the
tile, the tiny-value signal (its sums are redone) and a signal whose sums
round only where a tile's carry joins (the redo starts at that tile's
first sample).  The tile table and the event-to-read search are held to
np.repeat, and the probe wrapper's CPU path to the model.
"""

import functools

import numpy as np
import pytest
import torch

from f5c_tpu.ops.events_device import detect_events_batch as jax_batch
from f5c_tpu_torch import datasets, native, synthetic
from f5c_tpu_torch.io.slow5 import Slow5File
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import _build, events_cuda
from f5c_tpu_torch.ops import events_device as ed

T = ed.SUM_TILE
LENGTHS = [0, 1, T - 1, T, T + 1, 3 * T + 5, 40 * T + 3]


@functools.lru_cache(maxsize=1)
def _signals() -> dict:
    """{name: (pA signal, rna)}: the golden reads, event_signals, random
    pA-like signals of LENGTHS and the carry-join signal."""
    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    out = {f"golden{i}": (f.get(r).to_pa(), False)
           for i, r in enumerate(f.read_ids())}
    sig = synthetic.event_signals(np.random.default_rng(2031),
                                  builtin_model("dna_r9_nucleotide"),
                                  builtin_model("rna_r9_nucleotide"))
    names = ["dna40", "dna700", "dna3000", "dna12000", "tiny", "dense",
             "dna1", "dna5", "dna11"]
    out.update({n: (p, False) for n, p in zip(names, sig["dna"])})
    out["rna"] = (sig["rna"][0], True)
    rng = np.random.default_rng(2040)
    for n in LENGTHS:
        out[f"len{n}"] = (rng.normal(90.0, 15.0, n).astype(np.float32),
                          False)
    out["carry_join"] = (synthetic.carry_join_signal(T), False)
    return out


NAMES = ([f"golden{i}" for i in range(6)]
         + ["dna40", "dna700", "dna3000", "dna12000", "tiny", "dense",
            "dna1", "dna5", "dna11", "rna"]
         + [f"len{n}" for n in LENGTHS] + ["carry_join"])
# the inputs whose tiled sums round somewhere, and so are redone: the tiny
# values, the carry join, and the densest signal, whose squares (0.27^2
# beside 195^2, summed to ~2^28) need more than f64's 53 bits
ROUNDING = {"tiny", "carry_join", "dense"}


def test_names_cover_every_signal():
    assert sorted(NAMES) == sorted(_signals())


@pytest.mark.parametrize("name", NAMES)
def test_model_sums_are_sample_order(name):
    """The model's sums are prefix_sums' bit for bit; they are redone
    exactly where the tiled order rounded (on none of the golden reads or
    the simulated ones)."""
    x, _ = _signals()[name]
    s, q, fixed = ed.prefix_sums_tiled(x)
    want_s, want_q = ed.prefix_sums(torch.from_numpy(x))
    assert s.tobytes() == want_s.numpy().tobytes()
    assert q.tobytes() == want_q.numpy().tobytes()
    assert fixed == (name in ROUNDING)
    scan_s, scan_q = ed.scan_order_sums(x)
    assert (ed.first_failure(x, scan_s, scan_q) < x.shape[0]) == fixed


def test_tiny_values_are_redone():
    """The tiny-value signal of event_signals: its tiled sums round within
    a tile, the check finds it, and the model redoes them (fixed = 1)."""
    x, _ = _signals()["tiny"]
    s, q = ed.scan_order_sums(x)
    i = ed.first_failure(x, s, q)
    assert 0 < i < x.shape[0]
    assert ed.prefix_sums_tiled(x)[2] == 1


def test_carry_join_redo_starts_at_the_tile():
    """The carry-join signal: every sum within the first two tiles is the
    sample order's (the check passes there, joins included), but the third
    tile's carry is not the second tile's last sum, so the first failure
    is the third tile's first sample, where the redo starts."""
    x, _ = _signals()["carry_join"]
    s, q = ed.scan_order_sums(x)
    want_s, want_q = (t.numpy() for t in ed.prefix_sums(torch.from_numpy(x)))
    assert ed.first_failure(x, s, q) == 2 * T
    assert np.array_equal(s[:2 * T + 1], want_s[:2 * T + 1])
    assert np.array_equal(q, want_q)
    assert s[2 * T + 1] != want_s[2 * T + 1]
    s2, q2 = s.copy(), q.copy()
    ed.redo_from(x, s2, q2, 2 * T)
    assert s2.tobytes() == want_s.tobytes()
    assert q2.tobytes() == want_q.tobytes()


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and a[0].dtype == np.int64
            and all(x.dtype == np.float32 and x.tobytes() == y.tobytes()
                    for x, y in zip(a[1:], b[1:])))


def _model_events(pas, rna):
    """Per read (start, length, mean, stdv) numpy arrays of
    detect_events_model on one ragged batch, and its fixed."""
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    ev_off, *outs, fixed = ed.detect_events_model(
        torch.from_numpy(np.concatenate(pas)), torch.from_numpy(off), rna)
    eo = ev_off.numpy()
    outs = [o.numpy() for o in outs]
    return [tuple(o[a:b] for o in outs)
            for a, b in zip(eo[:-1], eo[1:])], fixed.numpy()


@pytest.mark.parametrize("group", ["golden", "lengths", "rna",
                                   "native_only", "long"])
def test_model_events_match_native_and_jax(group):
    """Events from the model's sums, the peak scan and the model of the
    assembly: native.detect_events' bit for bit, and the JAX package's
    detect_events_batch (eager) as tests/test_torch_events.py::_check runs
    it, but on the tiny values and the carry join, where the JAX op's
    two-float sums round (its events differ there), the densest signal
    (held to native there as well), the empty read (the JAX op writes a
    mean of 0 where the host divides 0 by 0) and the long reads, which
    would cost the eager JAX scan most of this file's time."""
    sig = _signals()
    names = {"golden": [f"golden{i}" for i in range(6)],
             "lengths": ["dna40", "dna700", "dna1", "dna5", "dna11",
                         "len1", f"len{T - 1}", f"len{T}", f"len{T + 1}"],
             "rna": ["rna"],
             "native_only": ["tiny", "carry_join", "dense", "len0"],
             "long": ["dna3000", "dna12000", f"len{3 * T + 5}",
                      f"len{40 * T + 3}"]}[group]
    pas = [sig[n][0] for n in names]
    rna = sig[names[0]][1]
    ours, fixed = _model_events(pas, rna)
    assert fixed.tolist() == [int(n in ROUNDING) for n in names]
    for name, p, o in zip(names, pas, ours):
        nat = native.detect_events(p, rna=rna)
        assert _same(o, (nat.start, nat.length, nat.mean, nat.stdv)), name
    if group in ("golden", "lengths", "rna"):
        theirs = jax_batch(pas, rna=rna, eager=True)
        for name, o, t in zip(names, ours, theirs):
            assert _same(o, t), name
    plain = events_cuda.detect_events_batch(pas, rna, torch.device("cpu"))
    assert all(_same(o, p) for o, p in zip(ours, plain))


@pytest.mark.parametrize("n,tiles", [
    (2_699_736, 660), (11_554, 3), (0, 0), (1, 1), (T - 1, 1), (T, 1),
    (T + 1, 2), (1 << 25, 8192)])
def test_tile_table(n, tiles):
    """The sums' grid: the 2.70 M-sample ultra read is 660 tiles of 4,096
    (more blocks than an H100's 132 SMs), a golden read 3, a launch at
    SAMPLE_BUDGET 8,192."""
    assert ed.tile_table([n]).tolist() == [0, tiles]
    assert ed.tile_table([n, 5, 0, n]).tolist() == [
        0, tiles, tiles + 1, tiles + 1, 2 * tiles + 1]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_owner_finds_each_tile_and_event(seed):
    """owner (the kernels' binary search) maps every tile of a launch to
    its read, and every event (reads of 0 samples have 1 event, so the
    event offsets are strictly increasing) to its read: np.repeat's
    map, with reads of 0 tiles passed over."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3 * T, 50)
    lens[rng.integers(0, 50, 10)] = 0
    lens[0] = lens[-1] = 0
    tiles = ed.tile_table(lens)
    counts = np.diff(tiles)
    g = np.arange(tiles[-1])
    assert np.array_equal(ed.owner(tiles, g),
                          np.repeat(np.arange(50), counts))
    ev = rng.integers(1, 40, 50)
    ev_off = np.concatenate([[0], np.cumsum(ev)])
    j = np.arange(ev_off[-1])
    assert np.array_equal(ed.owner(ev_off, j), np.repeat(np.arange(50), ev))
    assert np.array_equal(ed.owner(tiles, g),
                          np.searchsorted(tiles, g, side="right") - 1)


def test_probe_cpu_path_is_the_model():
    """events_cuda.sums_tracks on CPU tensors is sums_tracks_model: per
    read, prefix_sums at its slot of S and Q (n + 1 at sig_off[b] + b), the
    tracks of tracks_plain, and fixed where the sums round."""
    sig = _signals()
    names = ["golden0", "tiny", "len0", "dna5", "carry_join", "golden3"]
    pas = [sig[n][0] for n in names]
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    pa, so = torch.from_numpy(np.concatenate(pas)), torch.from_numpy(off)
    s, q, t1, t2, fixed = events_cuda.sums_tracks(pa, so, False)
    assert fixed.tolist() == [0, 1, 0, 0, 1, 0]
    for b, p in enumerate(pas):
        want_s, want_q = ed.prefix_sums(torch.from_numpy(p))
        at = slice(off[b] + b, off[b + 1] + b + 1)
        assert torch.equal(s[at], want_s) and torch.equal(q[at], want_q)
    want_t1, want_t2 = ed.tracks_plain(pa, so, False)
    assert torch.equal(t1, want_t1) and torch.equal(t2, want_t2)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    """CPU tensors take the plain versions: neither wrapper builds or
    loads the kernels' library."""
    def refuse():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", refuse)
    x, _ = _signals()["golden1"]
    pa, so = torch.from_numpy(x), torch.tensor([0, x.shape[0]])
    events_cuda.detect_events(pa, so, False)
    events_cuda.sums_tracks(pa, so, False)
    with pytest.raises(ValueError, match="CUDA"):
        events_cuda.stages(pa, so, False)
