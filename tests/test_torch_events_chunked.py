"""The plain model of K9's chunk-parallel peak scan
(f5c_tpu_torch/ops/events_device.py:peak_scan_chunked, the schedule of
csrc/events.cu's events_peaks_kernel) against the sequential scan
``peak_scan``: the same peaks in the same order for chunk lengths 1, 2, 3
(on reads of at most 2,000 samples), 5, 32, 1000, the whole read and the
kernel's own, on the golden signals' tracks, on synthetic.event_signals
(DNA of a few lengths, tiny values, the densest pattern, RNA) and on the
adversarial synthetic.peak_tracks; the worst case takes one round a chunk.
Events built from the model's bounds are native.detect_events' bit for
bit, and the probe wrapper's CPU path is the model's.
"""

import functools

import numpy as np
import pytest
import torch

from f5c_tpu_torch import datasets, native, synthetic
from f5c_tpu_torch.io.slow5 import Slow5File
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import events_cuda
from f5c_tpu_torch.ops import events_device as ed

SMALL = 2000      # the most samples a case run at chunk lengths 1, 2, 3


@functools.lru_cache(maxsize=1)
def _signals() -> dict:
    """{name: (pA signal, rna)}: the golden reads and event_signals."""
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
    return out


def _tracks_of(pa: np.ndarray, rna: bool):
    x = torch.from_numpy(pa)
    n = x.shape[0]
    s, q = ed.prefix_sums(x)
    w1, w2 = ed.detector_params(rna)[:2]
    return (ed.tstat_track(s, q, n, w1).tolist(),
            ed.tstat_track(s, q, n, w2).tolist(), n, s, q)


@functools.lru_cache(maxsize=1)
def _cases() -> dict:
    """{name: (t1, t2, n, rna)}, the signals' tracks and peak_tracks."""
    out = {name: (*_tracks_of(pa, rna)[:3], rna)
           for name, (pa, rna) in _signals().items()}
    for c in synthetic.peak_tracks(np.random.default_rng(2034)):
        out[c["name"]] = (c["t1"].tolist(), c["t2"].tolist(),
                          c["t1"].shape[0], c["rna"])
    return out


CASE_NAMES = (
    [f"golden{i}" for i in range(6)]
    + ["dna40", "dna700", "dna3000", "dna12000", "tiny", "dense", "dna1",
       "dna5", "dna11", "rna"]
    + ["zeros", "ramp", "saw32", "saw32_first", "noise", "plateau",
       "plateau_rna", "short0", "short1", "short2", "short5", "short11"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_chunked_scan_matches_sequential(name):
    t1, t2, n, rna = _cases()[name]
    want = ed.peak_scan(t1, t2, n, rna)
    own = ed.peak_chunk(n, ed.peak_threads(n))
    chunks = [5, 32, 1000, max(n, 1), own] + ([1, 2, 3] if n <= SMALL
                                               else [])
    for chunk in chunks:
        got, rounds = ed.peak_scan_chunked(t1, t2, n, rna, chunk)
        assert got == want, (name, chunk)
        n_chunks = -(-(n - 1) // chunk) if n > 1 else 0
        assert 1 <= rounds <= max(n_chunks, 1), (name, chunk)


def test_case_list_covers_every_case():
    assert sorted(CASE_NAMES) == sorted(_cases())


@pytest.mark.parametrize("name", ["plateau", "plateau_rna"])
def test_worst_case_takes_a_round_a_chunk(name):
    """A rise of t1 over threshold 1, then a stretch within the peak
    height below it: the short detector tracks and never emits, so no
    chunk run from another state falls back into step and the fixed point
    takes exactly one round a chunk, and still gives the peaks."""
    t1, t2, n, rna = _cases()[name]
    want = ed.peak_scan(t1, t2, n, rna)
    for chunk in (1, 5, 32, 300):
        got, rounds = ed.peak_scan_chunked(t1, t2, n, rna, chunk)
        assert got == want
        assert rounds == -(-(n - 1) // chunk) > 2


def test_real_signals_converge_in_two_rounds():
    """On the golden reads at the kernel's own chunk length the detectors
    fall back into step within every chunk: two rounds."""
    for i in range(6):
        t1, t2, n, rna = _cases()[f"golden{i}"]
        chunk = ed.peak_chunk(n, ed.peak_threads(n))
        assert ed.peak_scan_chunked(t1, t2, n, rna, chunk)[1] == 2


@pytest.mark.parametrize("group", ["golden", "synthetic_dna", "rna"])
def test_events_from_chunked_bounds_match_native(group):
    """Events between the model's bounds (0, its peaks, n) at the kernel's
    own chunk length for the group's launch: native.detect_events' bit for
    bit."""
    sigs = {k: v for k, v in _signals().items()
            if (group == "golden") == k.startswith("golden")
            and (group == "rna") == v[1]}
    threads = ed.peak_threads(max(p.shape[0] for p, _ in sigs.values()))
    for name, (pa, rna) in sigs.items():
        t1, t2, n, s, q = _tracks_of(pa, rna)
        peaks, _ = ed.peak_scan_chunked(t1, t2, n, rna,
                                        ed.peak_chunk(n, threads))
        bounds = torch.tensor([0] + peaks + [n], dtype=torch.int64)
        got = [t.numpy() for t in ed.events_from_bounds(s, q, bounds)]
        nat = native.detect_events(pa, rna=rna)
        assert np.array_equal(got[0], nat.start), name
        for g, w in zip(got[1:], (nat.length, nat.mean, nat.stdv)):
            assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("chunk", [0, 32, 1000])
def test_probe_cpu_path_is_the_model(chunk):
    """events_cuda.peaks_from_tracks on CPU tensors (the probe's batches
    of synthetic.peak_probe_batches): the model at the kernel's chunk
    length (0: as detect_events launches it), read by read in the ragged
    layout; peak_scan's peaks."""
    for x in synthetic.peak_probe_batches(np.random.default_rng(2034)):
        peaks, rounds = events_cuda.peaks_from_tracks(
            x["t1"], x["t2"], x["sig_off"], x["rna"], chunk)
        so = x["sig_off"].tolist()
        threads = ed.peak_threads(max(b - a for a, b in zip(so, so[1:])))
        for i, (p, r) in enumerate(zip(peaks, rounds)):
            n = so[i + 1] - so[i]
            t1c = x["t1"][so[i]:so[i + 1]].tolist()
            t2c = x["t2"][so[i]:so[i + 1]].tolist()
            assert p == ed.peak_scan(t1c, t2c, n, x["rna"])
            assert (p, r) == ed.peak_scan_chunked(
                t1c, t2c, n, x["rna"], chunk or ed.peak_chunk(n, threads))


def test_probe_refuses_too_many_chunks():
    t = torch.zeros(40_000)
    with pytest.raises(ValueError, match="chunks"):
        events_cuda.peaks_from_tracks(t, t, torch.tensor([0, 40_000]),
                                      False, 32)


@pytest.mark.parametrize("n,threads,chunk", [
    (11_554, 256, 46), (2_699_736, 1024, 2637), (40, 32, 39), (1, 32, 1),
    (0, 32, 1), (100, 32, 33)])
def test_kernel_partition(n, threads, chunk):
    """The kernel's block and chunk length: golden reads of ~11.5 k
    samples get 256 threads and chunks of ~45 samples, the 2.70 M-sample
    ultra read 1,024 and ~2.6 k."""
    assert ed.peak_threads(n) == threads
    assert ed.peak_chunk(n, threads) == chunk
