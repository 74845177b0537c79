#!/usr/bin/env python3
"""Time the event detector's kernels (csrc/events.cu, K9) built from one or
more source directories, on the same launches on one card, in turns.

    python3 scripts/events_kernel_time.py [DIR ...]

Each DIR holds an ``events.cu`` (default: the package's own
``f5c_tpu_torch/csrc``); each is built with nvcc and the flags of
``ops/_build.py`` into a library of its own under
``build/events_kernel_time/``.  A source without the probe entry
``f5c_events_peaks`` is taken as the one-lane peak scan of cc1f8b6, whose
``f5c_events_detect`` takes no rounds and no block size.  To time that one
against the package's:

    mkdir -p ab/one_lane
    git show cc1f8b6:f5c_tpu_torch/csrc/events.cu > ab/one_lane/events.cu
    python3 scripts/events_kernel_time.py ab/one_lane f5c_tpu_torch/csrc

The launches, made from a seed:

- ``golden_x85``: the 6 golden signals x 85 = 510 reads in waves of 128
  (4 launches, as the scale run's call-methylation makes them);
- ``ultra_read``: one synthetic read of ~2.7 M samples (k-mers dwelling
  6-12 samples around the model's levels, as ``synthetic.event_signals``);
- ``adversarial``: ``synthetic.peak_tracks`` through the probe (variants
  with the probe only).

Every variant is first held bit for bit to the plain version
(``detect_events_plain``; the probe to ``peak_scan``), then timed in
turns A B ... B A: ``detect_ms``, the sums and peak kernels of one pass
over a launch set (CUDA events, mean of REPS passes), and ``peaks_ms``,
the peak kernel's device time a pass under torch.profiler, with the
rounds (the most in a read, the mean).  Then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20
_vp, _int = ctypes.c_void_p, ctypes.c_int


def build(src_dir: str, tag: str) -> tuple[ctypes.CDLL, bool]:
    """(the library, whether it has the probe and the new signature)."""
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "events_kernel_time", tag)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libevents.so")
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", so, os.path.join(src_dir, "events.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{res.stderr}")
    for ln in (res.stdout + res.stderr).splitlines():
        if "Used" in ln or "spill" in ln:
            print(f"[events_kernel_time] ptxas {tag}: {ln.strip()}")
    lib = ctypes.CDLL(so)
    new = hasattr(lib, "f5c_events_peaks")
    lib.f5c_events_detect.argtypes = (
        [_vp] * 10 + [_int] * 3 + [_vp] if new else [_vp] * 9 + [_int] * 2
        + [_vp])
    lib.f5c_events_assemble.argtypes = [_vp] * 9 + [_int] + [_vp]
    if new:
        lib.f5c_events_peaks.argtypes = [_vp] * 6 + [_int] * 4 + [_vp]
    for fn in ("f5c_events_detect", "f5c_events_assemble"):
        getattr(lib, fn).restype = _int
    return lib, new


class Launch:
    """The scratch of one call of ops/events_cuda.detect_events."""

    def __init__(self, torch, pa, off, rna):
        from f5c_tpu_torch.ops import events_cuda

        self.pa = torch.from_numpy(pa).cuda()
        self.off = torch.from_numpy(off).cuda()
        self.rna = rna
        S, B = pa.shape[0], off.shape[0] - 1
        self.B = B
        self.max_len = int((off[1:] - off[:-1]).max())
        e = torch.empty
        self.s = e(S + B, dtype=torch.float64, device="cuda")
        self.q = e(S + B, dtype=torch.float64, device="cuda")
        self.t1 = e(events_cuda._padded(S), dtype=torch.float32, device="cuda")
        self.t2 = e(events_cuda._padded(S), dtype=torch.float32, device="cuda")
        self.bnd = e(S + 2 * B, dtype=torch.int32, device="cuda")
        self.n_ev, self.fixed, self.rounds = (
            e(B, dtype=torch.int32, device="cuda") for _ in range(3))

    def detect(self, torch, lib, new):
        from f5c_tpu_torch.ops import events_device

        ptrs = [t.data_ptr() for t in (self.pa, self.off, self.s, self.q,
                                       self.t1, self.t2, self.bnd, self.n_ev,
                                       self.fixed)]
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            err = lib.f5c_events_detect(
                *ptrs, self.rounds.data_ptr(), self.B, int(self.rna),
                events_device.peak_threads(self.max_len), stream)
        else:
            err = lib.f5c_events_detect(*ptrs, self.B, int(self.rna), stream)
        if err:
            raise RuntimeError(f"f5c_events_detect: CUDA error {err}")

    def events(self, torch, lib, new):
        """The whole call, as the wrapper makes it: (ev_off, start, length,
        mean, stdv) and the rounds (None for the one-lane kernel)."""
        self.detect(torch, lib, new)
        ne = self.n_ev.cpu().numpy().astype("int64")
        ev_off = torch.zeros(self.B + 1, dtype=torch.int64)
        ev_off[1:] = torch.from_numpy(ne).cumsum(0)
        E = int(ev_off[-1])
        ev_off = ev_off.cuda()
        start = torch.empty(E, dtype=torch.int64, device="cuda")
        outs = [torch.empty(E, dtype=torch.float32, device="cuda")
                for _ in range(3)]
        err = lib.f5c_events_assemble(
            self.s.data_ptr(), self.q.data_ptr(), self.off.data_ptr(),
            self.bnd.data_ptr(), ev_off.data_ptr(), start.data_ptr(),
            *(o.data_ptr() for o in outs), self.B,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"f5c_events_assemble: CUDA error {err}")
        rounds = self.rounds.cpu().numpy() if new else None
        return (ev_off, start, *outs), rounds


def golden_x85(np):
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.io.slow5 import Slow5File

    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    sig = [f.get(r).to_pa() for r in f.read_ids()] * 85
    return [sig[i:i + 128] for i in range(0, len(sig), 128)]


def ultra_read(np, rng):
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model

    model = builtin_model("dna_r9_nucleotide")
    seq = synthetic.random_seq(rng, 300_000)
    ranks = model.kmer_ranks(seq)
    dwell = rng.integers(6, 13, ranks.shape[0])
    mean = np.repeat(model.level_mean[ranks].astype(np.float64), dwell)
    return [[rng.normal(mean, 1.2).astype(np.float32)]]


def slab(np, pas):
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    return np.concatenate(pas).astype(np.float32), off


def peaks_device_ms(torch, fn) -> float:
    """The device time of the kernels named events_peaks_kernel during one
    call of ``fn``, from torch.profiler (0.0: the trace showed none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.end - ev.time_range.start for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and re.search(r"events_peaks_kernel", ev.name))
    return us / 1e3


def hold_probe(torch, np, lib, rng) -> dict:
    """The probe on synthetic.peak_tracks at the kernel's own chunk length
    and at 32 and 1000, held to peak_scan and to the plain model's
    rounds."""
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.ops import _build, events_cuda, events_device

    rounds = {}
    saved = _build._lib
    _build._lib = lib   # the probe wrapper launches this variant's kernel
    try:
        for x in synthetic.peak_probe_batches(rng):
            args, rna, so = (x["t1"], x["t2"], x["sig_off"]), x["rna"], \
                x["sig_off"].tolist()
            for chunk in (0, 32, 1000):
                got, r = events_cuda.peaks_from_tracks(
                    *(a.cuda() for a in args), rna, chunk)
                want, r_cpu = events_cuda.peaks_from_tracks(*args, rna, chunk)
                for i, name in enumerate(x["names"]):
                    lo, hi = so[i], so[i + 1]
                    if got[i] != want[i] or got[i] != events_device.peak_scan(
                            x["t1"][lo:hi].tolist(), x["t2"][lo:hi].tolist(),
                            hi - lo, rna):
                        raise AssertionError(f"probe differs on {name}")
                    rounds[f"{name}@{chunk}"] = int(r[i])
                if not np.array_equal(r, r_cpu):
                    raise AssertionError(f"probe rounds {r} != model's {r_cpu}")
    finally:
        _build._lib = saved
    return rounds


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    from f5c_tpu_torch.ops import events_device

    if not torch.cuda.is_available():
        print("events_kernel_time: no CUDA device", file=sys.stderr)
        return 1
    dirs = argv or [os.path.join(ROOT, "f5c_tpu_torch", "csrc")]
    libs = [(d, *build(d, f"v{i}")) for i, d in enumerate(dirs)]
    rng = np.random.default_rng(2032)
    sets = {"golden_x85": golden_x85(np), "ultra_read": ultra_read(np, rng)}
    for name, waves in sets.items():
        launches = [Launch(torch, *slab(np, w), False) for w in waves]
        wants = [events_device.detect_events_plain(
            torch.from_numpy(L.pa.cpu().numpy()),
            torch.from_numpy(L.off.cpu().numpy()), False) for L in launches]
        rounds = {}
        for d, lib, new in libs:
            rs = []
            for L, want in zip(launches, wants):
                got, r = L.events(torch, lib, new)
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                    raise AssertionError(f"{d}: {name} differs from plain")
                if r is not None:
                    rs.append(r)
            if rs:
                r = np.concatenate(rs)
                rounds[d] = f"max={int(r.max())},mean={r.mean():.3f}"
        times = {d: ([], []) for d, _, _ in libs}
        for d, lib, new in libs + libs[::-1]:
            def one_pass():
                for L in launches:
                    L.detect(torch, lib, new)
            one_pass()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                one_pass()
            stop.record()
            stop.synchronize()
            times[d][0].append(start.elapsed_time(stop) / REPS)
            times[d][1].append(peaks_device_ms(torch, one_pass))
        for d, (ms, pk) in times.items():
            print(f"[events_kernel_time] launch={name} source={d} "
                  f"launches={len(launches)} "
                  f"samples={sum(int(L.off[-1]) for L in launches)} "
                  f"longest={max(L.max_len for L in launches)} "
                  f"detect_ms={','.join(f'{m:.4f}' for m in ms)} "
                  f"peaks_ms={','.join(f'{m:.4f}' for m in pk)} "
                  f"rounds={rounds.get(d, 'n/a')}", flush=True)
    for d, lib, new in libs:
        if new:
            r = hold_probe(torch, np, lib, np.random.default_rng(2033))
            print(f"[events_kernel_time] launch=adversarial source={d} "
                  f"held=peak_scan rounds={r}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
