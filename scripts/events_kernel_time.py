#!/usr/bin/env python3
"""Time the event detector's kernels (csrc/events.cu, K9) built from one or
more source directories, on the same launches on one card, in turns.

    python3 scripts/events_kernel_time.py [DIR ...]

Each DIR holds an ``events.cu`` (default: the package's own
``f5c_tpu_torch/csrc``); each is built with nvcc and the flags of
``ops/_build.py`` into a library of its own under
``build/events_kernel_time/``.  Three generations of the source are read
by their entry points:

- ``tiles`` (``f5c_events_sums``): the sums and tracks as a grid over
  every tile of the launch, the assembly a thread an event;
- ``block`` (``f5c_events_detect`` and the probe ``f5c_events_peaks``,
  f97def0..a39aeee): the sums and tracks one block a read, the peak scan
  chunk-parallel;
- ``one_lane`` (neither, cc1f8b6): the peak scan one lane a read.

To time a39aeee's kernels against the package's:

    mkdir -p ab/block
    git show a39aeee:f5c_tpu_torch/csrc/events.cu > ab/block/events.cu
    python3 scripts/events_kernel_time.py ab/block f5c_tpu_torch/csrc

The launches, made from a seed:

- ``golden_x85``: the 6 golden signals x 85 = 510 reads in waves of 128
  (4 launches, as the scale run's call-methylation makes them);
- ``ultra_read``: one simulated read of 2.7 M samples
  (``synthetic.simulated_pa``: k-mers dwelling 6-12 samples around the
  model's levels);
- ``ultra_x4``: four simulated reads of 2.70, 1.80, 1.35 and 0.90 M
  samples (6.75 M, the ultra x4 set's size and longest read);
- ``adversarial``: ``synthetic.peak_tracks`` through the probe (variants
  with the probe only).

Every variant is first held bit for bit to the plain version
(``detect_events_plain``; the probe to ``peak_scan``), then timed in
turns A B ... B A, a pass being every launch of the set (the detection
and the assembly): ``k9_ms``, one pass between CUDA events (mean of REPS
passes), and ``sums_ms``, ``peaks_ms``, ``assemble_ms``, the device time
of each stage's kernels a pass under torch.profiler (mean of PROF_REPS
passes; the sums are every ``events_*`` kernel but the peak scan and the
assembly), with the rounds (the most in a read, the mean) and the reads
whose sums were redone.  Beside them, once a set, torch.cumsum of its
f64 samples and squares as one 2-row call (``cumsum_ms``) and as two flat
1-D calls (``cumsum_flat_ms``).  Then the card's name and power limit.
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
PROF_REPS = 5
ULTRA_X4 = (2_700_000, 1_800_000, 1_350_000, 900_000)
_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(src_dir: str, tag: str) -> tuple[ctypes.CDLL, str]:
    """(the library, its generation: "tiles", "block" or "one_lane")."""
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
    if hasattr(lib, "f5c_events_sums"):
        gen = "tiles"
        lib.f5c_events_sums.argtypes = [_vp] * 9 + [_int] * 3 + [_vp]
        lib.f5c_events_assemble.argtypes = [_vp] * 9 + [_int, _i64, _vp]
        fns = ("f5c_events_sums", "f5c_events_peaks", "f5c_events_assemble")
    elif hasattr(lib, "f5c_events_peaks"):
        gen = "block"
        lib.f5c_events_detect.argtypes = [_vp] * 10 + [_int] * 3 + [_vp]
        lib.f5c_events_assemble.argtypes = [_vp] * 9 + [_int, _vp]
        fns = ("f5c_events_detect", "f5c_events_peaks", "f5c_events_assemble")
    else:
        gen = "one_lane"
        lib.f5c_events_detect.argtypes = [_vp] * 9 + [_int] * 2 + [_vp]
        lib.f5c_events_assemble.argtypes = [_vp] * 9 + [_int, _vp]
        fns = ("f5c_events_detect", "f5c_events_assemble")
    if gen != "one_lane":
        lib.f5c_events_peaks.argtypes = [_vp] * 6 + [_int] * 4 + [_vp]
    for fn in fns:
        getattr(lib, fn).restype = _int
    return lib, gen


def _check(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


class Launch:
    """The scratch of one call of ops/events_cuda.detect_events, for every
    generation; after ``events`` also its outputs, so that a timed pass
    launches without waiting."""

    def __init__(self, torch, pa, off, rna):
        from f5c_tpu_torch.ops import events_cuda, events_device

        self.pa = torch.from_numpy(pa).cuda()
        self.off = torch.from_numpy(off).cuda()
        self.rna = rna
        S, B = pa.shape[0], off.shape[0] - 1
        self.B = B
        self.max_len = int((off[1:] - off[:-1]).max())
        tiles = events_device.tile_table(off[1:] - off[:-1])
        self.n_tiles = int(tiles[-1])
        self.tile_off = torch.from_numpy(tiles).cuda()
        e = torch.empty
        self.tot = e(2 * max(self.n_tiles, 1), dtype=torch.float64,
                     device="cuda")
        self.s = e(S + B, dtype=torch.float64, device="cuda")
        self.q = e(S + B, dtype=torch.float64, device="cuda")
        self.t1 = e(events_cuda._padded(S), dtype=torch.float32, device="cuda")
        self.t2 = e(events_cuda._padded(S), dtype=torch.float32, device="cuda")
        self.bnd = e(S + 2 * B, dtype=torch.int32, device="cuda")
        self.n_ev, self.fixed, self.rounds = (
            e(B, dtype=torch.int32, device="cuda") for _ in range(3))

    def detect(self, torch, lib, gen):
        from f5c_tpu_torch.ops import events_device

        stream = torch.cuda.current_stream().cuda_stream
        threads = events_device.peak_threads(self.max_len)
        p = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
        if gen == "tiles":
            _check("f5c_events_sums", lib.f5c_events_sums(
                *p(self.pa, self.off, self.tile_off, self.tot, self.s, self.q,
                   self.t1, self.t2, self.fixed), self.B, self.n_tiles,
                int(self.rna), stream))
            _check("f5c_events_peaks", lib.f5c_events_peaks(
                *p(self.t1, self.t2, self.off, self.bnd, self.n_ev,
                   self.rounds), self.B, int(self.rna), 0, threads, stream))
            return
        ptrs = p(self.pa, self.off, self.s, self.q, self.t1, self.t2,
                 self.bnd, self.n_ev, self.fixed)
        if gen == "block":
            err = lib.f5c_events_detect(*ptrs, self.rounds.data_ptr(),
                                        self.B, int(self.rna), threads,
                                        stream)
        else:
            err = lib.f5c_events_detect(*ptrs, self.B, int(self.rna), stream)
        _check("f5c_events_detect", err)

    def assemble(self, torch, lib, gen):
        args = [t.data_ptr() for t in (self.s, self.q, self.off, self.bnd,
                                       self.ev_off, self.start, *self.outs)]
        stream = torch.cuda.current_stream().cuda_stream
        if gen == "tiles":
            err = lib.f5c_events_assemble(*args, self.B, self.E, stream)
        else:
            err = lib.f5c_events_assemble(*args, self.B, stream)
        _check("f5c_events_assemble", err)

    def events(self, torch, lib, gen):
        """The whole call, as the wrapper makes it: (ev_off, start, length,
        mean, stdv), the rounds (None for the one-lane kernel) and the
        reads redone."""
        self.detect(torch, lib, gen)
        ne = self.n_ev.cpu().numpy().astype("int64")
        ev_off = torch.zeros(self.B + 1, dtype=torch.int64)
        ev_off[1:] = torch.from_numpy(ne).cumsum(0)
        self.E = int(ev_off[-1])
        self.ev_off = ev_off.cuda()
        self.start = torch.empty(self.E, dtype=torch.int64, device="cuda")
        self.outs = [torch.empty(self.E, dtype=torch.float32, device="cuda")
                     for _ in range(3)]
        self.assemble(torch, lib, gen)
        rounds = self.rounds.cpu().numpy() if gen != "one_lane" else None
        return ((self.ev_off, self.start, *self.outs), rounds,
                int(self.fixed.sum()))


def golden_x85(np):
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.io.slow5 import Slow5File

    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    sig = [f.get(r).to_pa() for r in f.read_ids()] * 85
    return [sig[i:i + 128] for i in range(0, len(sig), 128)]


def simulated(np, rng, lengths):
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model

    model = builtin_model("dna_r9_nucleotide")
    return [[synthetic.simulated_pa(rng, model, n) for n in lengths]]


def slab(np, pas):
    off = np.zeros(len(pas) + 1, np.int64)
    np.cumsum([p.shape[0] for p in pas], out=off[1:])
    return np.concatenate(pas).astype(np.float32), off


def stage_ms(torch, fn, reps: int) -> dict:
    """The device time of each K9 stage's kernels a call of ``fn``, from
    torch.profiler over ``reps`` calls: {"sums", "peaks", "assemble"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {"sums": 0.0, "peaks": 0.0, "assemble": 0.0}
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or not re.search(r"events_\w+_kernel", ev.name)):
            continue
        kind = ("peaks" if "events_peaks_kernel" in ev.name else
                "assemble" if "events_assemble_kernel" in ev.name else "sums")
        us[kind] += ev.time_range.end - ev.time_range.start
    return {k: v / 1e3 / reps for k, v in us.items()}


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cumsum_yardsticks(torch, launches) -> dict:
    """torch.cumsum of each launch's f64 samples and their squares, summed
    over the set: one 2-row call, and two flat 1-D calls."""
    xs = [L.pa.double() for L in launches]
    rows = [torch.stack([x, x * x]) for x in xs]
    sqs = [x * x for x in xs]
    return dict(
        cumsum_ms=cuda_ms(torch, lambda: [torch.cumsum(r, dim=1)
                                          for r in rows], REPS),
        cumsum_flat_ms=cuda_ms(torch, lambda: [
            (torch.cumsum(x, 0), torch.cumsum(s, 0))
            for x, s in zip(xs, sqs)], REPS))


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
    sets = {"golden_x85": golden_x85(np),
            "ultra_read": simulated(np, rng, (2_700_000,)),
            "ultra_x4": simulated(np, rng, ULTRA_X4)}
    for name, waves in sets.items():
        launches = [Launch(torch, *slab(np, w), False) for w in waves]
        wants = [events_device.detect_events_plain(
            torch.from_numpy(L.pa.cpu().numpy()),
            torch.from_numpy(L.off.cpu().numpy()), False) for L in launches]
        facts = {}
        for d, lib, gen in libs:
            rs, fixed = [], 0
            for L, want in zip(launches, wants):
                got, r, f = L.events(torch, lib, gen)
                if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                    raise AssertionError(f"{d}: {name} differs from plain")
                fixed += f
                if r is not None:
                    rs.append(r)
            r = np.concatenate(rs) if rs else None
            facts[d] = (f"rounds=max={int(r.max())},mean={r.mean():.3f}"
                        if r is not None else "rounds=n/a") + \
                f" fixed_reads={fixed}"
        times = {d: {"k9_ms": [], "sums_ms": [], "peaks_ms": [],
                     "assemble_ms": []} for d, _, _ in libs}
        for d, lib, gen in libs + libs[::-1]:
            def one_pass():
                for L in launches:
                    L.detect(torch, lib, gen)
                    L.assemble(torch, lib, gen)
            times[d]["k9_ms"].append(cuda_ms(torch, one_pass, REPS))
            for k, v in stage_ms(torch, one_pass, PROF_REPS).items():
                times[d][f"{k}_ms"].append(v)
        for d, cols in times.items():
            print(f"[events_kernel_time] launch={name} source={d} "
                  f"launches={len(launches)} "
                  f"samples={sum(int(L.off[-1]) for L in launches)} "
                  f"longest={max(L.max_len for L in launches)} "
                  f"tiles={sum(L.n_tiles for L in launches)} "
                  + " ".join(f"{k}={','.join(f'{m:.4f}' for m in v)}"
                             for k, v in cols.items())
                  + f" {facts[d]}", flush=True)
        yard = cumsum_yardsticks(torch, launches)
        print(f"[events_kernel_time] launch={name} "
              + " ".join(f"{k}={v:.4f}" for k, v in yard.items()),
              flush=True)
        del launches
        torch.cuda.empty_cache()
    for d, lib, gen in libs:
        if gen != "one_lane":
            r = hold_probe(torch, np, lib, np.random.default_rng(2033))
            print(f"[events_kernel_time] launch=adversarial source={d} "
                  f"held=peak_scan rounds={r}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
