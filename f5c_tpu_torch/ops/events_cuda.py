"""Event detection (K9): a CUDA tensor goes to the hand-written kernels of
``csrc/events.cu``, a CPU tensor to the plain PyTorch version
``ops/events_device.py:detect_events_plain``.  Counterpart of
``f5c_tpu/ops/events_device.py`` (``detect_events_device``,
``detect_events_batch``).

The wrapper checks device, dtype, shape and contiguity, reads the read
offsets back once to build the kernels' tile table
(``events_device.tile_table``) and size the peak scan's blocks, allocates
the scratch (28 bytes a sample, 16 a tile; the host wrapper bounds a
call's samples by ``SAMPLE_BUDGET``) and the outputs, launches on torch's
current stream of the tensors' device (under ``_build.device_guard``) and
counts the call in ``launches``.  The prefix sums and tracks run as a grid
over every tile of every read (``events_device.prefix_sums_tiled`` is
their plain model), the peak scan one block a read, its chunks of
samples side by side to an exact fixed point (``peak_scan_chunked``; the
block's threads follow the launch's longest read, ``peak_threads``), the
assembly one thread an event.  The wrapper reads the event counts, the
reads whose sums were redone and the scan's rounds back once, to size the
compact output; every read, however many events it has, is detected on
the card.  There is no fallback: a CUDA tensor launches the kernels or
raises.  Probes: ``sums_tracks`` runs the sums and tracks alone,
``peaks_from_tracks`` the peak scan alone (the tests and chip_smoke.py
hold them to ``events_device.sums_tracks_model`` and ``peak_scan``), and
``stages`` gives one launch's three stages to time apart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import HostCopy, h2d
from . import _build
from .events_device import (MAX_THREADS, detect_events_plain, peak_chunk,
                            peak_scan_chunked, peak_threads,
                            sums_tracks_model, tile_table)

launches = {"events": 0}
# the most samples that detect_events_batch gives one call: the scratch
# is 28 bytes a sample, so under 1 GB of device memory a call
SAMPLE_BUDGET = 1 << 25
# reads whose prefix sums were redone in sample order (the tiled order
# rounded somewhere), summed over the calls
fixed_reads = {"events": 0}
# the peak scan's rounds to its fixed point: the most in a read, and the
# sum over reads and the reads, summed over the calls
rounds = {"max": 0, "sum": 0, "reads": 0}


def _padded(n: int) -> int:
    """A track slab's floats: the kernel reads it in aligned groups of 8."""
    return -(-max(n, 1) // 8) * 8


class _Launch:
    """One call of the kernels on a ragged batch: its scratch and outputs
    on the card, and one method a stage (sums and tracks, peak scan,
    assembly), each a launch on the current stream inside a span of
    ``_build.launch_spans``."""

    def __init__(self, pa_pool, sig_off, rna: bool):
        dev = self.dev = pa_pool.device
        off = sig_off.cpu().numpy()
        lens = off[1:] - off[:-1]
        self.B, self.S_n = lens.shape[0], pa_pool.shape[0]
        max_len = int(lens.max()) if self.B else 0
        if max_len >= 1 << 31:
            raise ValueError(f"detect_events: a read of {max_len} samples; "
                             "positions are int32")
        tiles = tile_table(lens)
        self.n_tiles = int(tiles[-1])
        self.pa, self.off, self.rna = pa_pool, sig_off, int(rna)
        self.threads = peak_threads(max_len)
        f64, f32, i32 = torch.float64, torch.float32, torch.int32
        self.tile_off = h2d(tiles, dev)
        self.tot = torch.empty(2 * max(self.n_tiles, 1), dtype=f64,
                               device=dev)
        self.s, self.q = (torch.empty(self.S_n + self.B, dtype=f64,
                                      device=dev) for _ in range(2))
        self.t1, self.t2 = (torch.empty(_padded(self.S_n), dtype=f32,
                                        device=dev) for _ in range(2))
        self.bnd = torch.empty(self.S_n + 2 * self.B, dtype=i32, device=dev)
        self.n_ev, self.fixed, self.rnd = (
            torch.empty(self.B, dtype=i32, device=dev) for _ in range(3))
        self.lib = _build.library()

    def _call(self, name: str, *args) -> None:
        with _build.device_guard(self.dev):
            span = _build.span_start(self.dev)
            err = getattr(self.lib, name)(
                *args, _build.stream_handle(self.dev))
            _build.span_stop(span, self.dev)
        _build.check_error(self.lib, name, err)

    def sums(self) -> None:
        self._call("f5c_events_sums", *(t.data_ptr() for t in (
            self.pa, self.off, self.tile_off, self.tot, self.s, self.q,
            self.t1, self.t2, self.fixed)), self.B, self.n_tiles, self.rna)

    def peaks(self) -> None:
        self._call("f5c_events_peaks", *(t.data_ptr() for t in (
            self.t1, self.t2, self.off, self.bnd, self.n_ev, self.rnd)),
            self.B, self.rna, 0, self.threads)

    def counts(self) -> np.ndarray:
        """Waits for the card: [n_events, fixed, rounds] a read (i64), and
        the event offsets and outputs allocated for the assembly."""
        counts = torch.stack([self.n_ev, self.fixed, self.rnd]).cpu() \
            .numpy().astype(np.int64)
        ev_off = np.zeros(self.B + 1, np.int64)
        np.cumsum(counts[0], out=ev_off[1:])
        self.E = int(ev_off[-1])
        self.ev_off = torch.from_numpy(ev_off).to(self.dev)
        self.start = torch.empty(self.E, dtype=torch.int64, device=self.dev)
        self.out = [torch.empty(self.E, dtype=torch.float32, device=self.dev)
                    for _ in range(3)]
        return counts

    def assemble(self) -> None:
        self._call("f5c_events_assemble", *(t.data_ptr() for t in (
            self.s, self.q, self.off, self.bnd, self.ev_off, self.start,
            *self.out)), self.B, self.E)


def _device_of(pa_pool, sig_off, name: str) -> torch.device:
    """Checks a wrapper's arguments; returns their device."""
    dev = pa_pool.device
    _build.check_tensor("pa_pool", pa_pool, torch.float32, 1, dev)
    _build.check_tensor("sig_off", sig_off, torch.int64, 1, dev)
    if sig_off.shape[0] < 1:
        raise ValueError(f"{name}: sig_off needs B + 1 entries")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def detect_events(pa_pool, sig_off, rna: bool = False):
    """Events of a ragged batch of pA signals (layout: ops/events_device.py):
    ``pa_pool`` f32 [S], ``sig_off`` i64 [B+1].  Returns (ev_off i64
    [B+1], start i64 [E], length f32 [E], mean f32 [E], stdv f32 [E]), on
    the input's device.  The offsets, read back, give the tile table and
    the longest read, which sizes the peak scan's blocks; the events
    depend on neither."""
    if _device_of(pa_pool, sig_off, "detect_events").type == "cpu":
        return detect_events_plain(pa_pool, sig_off, rna)
    L = _Launch(pa_pool, sig_off, rna)
    L.sums()
    L.peaks()
    counts = L.counts()
    fixed_reads["events"] += int(counts[1].sum())
    _count_rounds(counts[2])
    L.assemble()
    launches["events"] += 1
    return (L.ev_off, L.start, *L.out)


def sums_tracks(pa_pool, sig_off, rna: bool = False):
    """The prefix sums and tracks alone (the probe), in the kernels'
    layout: (S f64 [S + B], Q, T1 f32 [S], T2, fixed i32 [B]); a CPU
    tensor goes to their plain model ``sums_tracks_model``.  Not counted in
    ``launches``: it is no part of the main path."""
    if _device_of(pa_pool, sig_off, "sums_tracks").type == "cpu":
        return sums_tracks_model(pa_pool, sig_off, rna)
    L = _Launch(pa_pool, sig_off, rna)
    L.sums()
    return L.s, L.q, L.t1[:L.S_n], L.t2[:L.S_n], L.fixed


def stages(pa_pool, sig_off, rna: bool = False) -> _Launch:
    """One launch on CUDA tensors, run once through (not counted in
    ``launches``), whose ``sums``, ``peaks`` and ``assemble`` then launch
    each stage alone on the same scratch, for timing; ``n_tiles`` is the
    sums' grid."""
    if _device_of(pa_pool, sig_off, "stages").type != "cuda":
        raise ValueError("stages: CUDA tensors only")
    L = _Launch(pa_pool, sig_off, rna)
    L.sums()
    L.peaks()
    L.counts()
    L.assemble()
    return L


def _count_rounds(r: np.ndarray) -> None:
    if r.shape[0]:
        rounds["max"] = max(rounds["max"], int(r.max()))
        rounds["sum"] += int(r.sum())
        rounds["reads"] += int(r.shape[0])


def peaks_from_tracks(t1, t2, sig_off, rna: bool = False, chunk: int = 0):
    """The peak scan alone (the probe): ``t1``, ``t2`` f32 [S] t-stat
    tracks and ``sig_off`` i64 [B+1] in the layout of detect_events.
    ``chunk`` > 0 pins the chunk length (at most MAX_THREADS chunks a
    read); 0 takes the kernel's own, as detect_events launches it.
    Returns (each read's peaks in emission order as a list of ints, the
    rounds a read, i64 numpy).  A CPU tensor goes to the plain model
    ``peak_scan_chunked``, chunk for chunk.  Not counted in ``launches``:
    it is no part of the main path."""
    dev = t1.device
    _build.check_tensor("t1", t1, torch.float32, 1, dev)
    _build.check_tensor("t2", t2, torch.float32, 1, dev)
    _build.check_tensor("sig_off", sig_off, torch.int64, 1, dev)
    if t2.shape != t1.shape or sig_off.shape[0] < 1:
        raise ValueError("peaks_from_tracks: tracks of one length and B + 1 "
                         "offsets")
    off = sig_off.cpu().numpy()
    lens = off[1:] - off[:-1]
    B = lens.shape[0]
    max_len = int(lens.max()) if B else 0
    if chunk > 0:
        most = max(-(-(int(n) - 1) // chunk) for n in lens) if B else 0
        if most > MAX_THREADS:
            raise ValueError(f"peaks_from_tracks: {most} chunks of {chunk} "
                             f"in a read, over {MAX_THREADS}")
        threads = max(32, -(-most // 32) * 32)
    else:
        threads = peak_threads(max_len)
    if dev.type == "cpu":
        a, b = t1.tolist(), t2.tolist()
        peaks, rnd = [], []
        for o, n in zip(off[:-1], lens):
            o, n = int(o), int(n)
            p, r = peak_scan_chunked(a[o:o + n], b[o:o + n], n, rna,
                                     chunk or peak_chunk(n, threads))
            peaks.append(p)
            rnd.append(r)
        return peaks, np.array(rnd, np.int64)
    if dev.type != "cuda":
        raise ValueError(f"peaks_from_tracks: unsupported device {dev}")
    S_n = t1.shape[0]
    pad = [torch.zeros(_padded(S_n), dtype=torch.float32, device=dev)
           for _ in range(2)]
    pad[0][:S_n] = t1
    pad[1][:S_n] = t2
    bnd = torch.empty(S_n + 2 * B, dtype=torch.int32, device=dev)
    n_ev, rnd = (torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(2))
    lib = _build.library()
    with _build.device_guard(dev):
        span = _build.span_start(dev)
        err = lib.f5c_events_peaks(
            pad[0].data_ptr(), pad[1].data_ptr(), sig_off.data_ptr(),
            bnd.data_ptr(), n_ev.data_ptr(), rnd.data_ptr(), B, int(rna),
            chunk, threads, _build.stream_handle(dev))
        _build.span_stop(span, dev)
    _build.check_error(lib, "f5c_events_peaks", err)
    bnd_h, ne = bnd.cpu().numpy(), n_ev.cpu().numpy()
    peaks = [bnd_h[o + 2 * i + 1:o + 2 * i + ne[i]].tolist()
             for i, o in enumerate(off[:-1])]
    return peaks, rnd.cpu().numpy().astype(np.int64)


def detect_events_batch(pas: list, rna: bool, device: torch.device):
    """Host wrapper: the events of each pA signal in ``pas`` (f32 numpy),
    detected on ``device``; returns per-read (start i64, length f32, mean
    f32, stdv f32) numpy arrays, the dtypes of ``native.detect_events``.
    Consecutive reads go to one call of ``detect_events`` until they pass
    ``SAMPLE_BUDGET`` samples (a longer read goes alone).  The signals go
    up through pinned memory and the events come back the same way."""
    groups, size = [[]], 0
    for p in pas:
        if groups[-1] and size + p.shape[0] > SAMPLE_BUDGET:
            groups.append([])
            size = 0
        groups[-1].append(p)
        size += p.shape[0]
    return [t for g in groups for t in _detect_group(g, rna, device)]


def _detect_group(pas: list, rna: bool, device: torch.device):
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    slab = (np.concatenate(pas).astype(np.float32, copy=False) if pas
            else np.zeros(0, np.float32))
    eo, start, length, mean, stdv = HostCopy(list(detect_events(
        h2d(slab, device), h2d(off, device), rna))).wait()
    return [(start[a:b].copy(), length[a:b].copy(), mean[a:b].copy(),
             stdv[a:b].copy()) for a, b in zip(eo[:-1], eo[1:])]
