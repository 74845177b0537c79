"""The traced run: torch.profiler over the window, and a sampler of what
the program's main thread is doing.

``device_spans`` and the union in ``busy`` are frozen from
``chip_smoke.py`` ``device_busy`` (commit 5f95a86): the card's kernel,
copy and set spans, with their names cleaned of templates and
arguments.  The sampler reads the main thread's innermost frame inside
the program every few milliseconds; the card's idle gaps are then
attributed to what the host was running meanwhile.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

PROGRAM = os.sep + "f5c_tpu_torch" + os.sep


def clean_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name.removeprefix("void "), maxsplit=1)[0]
    return name.strip() or name


def device_spans(prof):
    """[(start s, end s, name)] of the card's activity, in seconds from
    the profiler's start."""
    import torch

    out = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out.append((ev.time_range.start / 1e6, ev.time_range.end / 1e6,
                    clean_name(ev.name)))
    return out


def merged(spans):
    """The union of (start, end) spans, as sorted disjoint spans."""
    out = []
    for t0, t1, *_ in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy(spans) -> float:
    return sum(t1 - t0 for t0, t1 in merged(spans))


def by_kernel(spans) -> dict:
    """{kernel: [seconds, launches]}."""
    per: dict = {}
    for t0, t1, name in spans:
        d = per.setdefault(name, [0.0, 0])
        d[0] += t1 - t0
        d[1] += 1
    return per


class Sampler:
    """Samples the main thread's innermost frame in the program every
    ``period`` seconds, as (perf_counter seconds, "module.function")."""

    def __init__(self, period: float = 0.002):
        self.period = period
        self.samples = []
        self._stop = threading.Event()
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _label(self, frame) -> str:
        while frame is not None:
            path = frame.f_code.co_filename
            if PROGRAM in path:
                mod = os.path.splitext(os.path.basename(path))[0]
                return f"{mod}.{frame.f_code.co_name}"
            frame = frame.f_back
        return "outside the program"

    def _run(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self._main)
            self.samples.append((time.perf_counter(), self._label(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def idle_gaps(spans, t0: float, t1: float, samples, prof_t0: float) -> dict:
    """{label: seconds}: the card's idle time inside [t0, t1] (profiler
    seconds), each gap split over the host labels sampled in it
    (``prof_t0``: perf_counter at the profiler's start)."""
    out: dict = {}
    times = [(s - prof_t0, lab) for s, lab in samples]
    edges = [[t0, t0]] + merged(spans) + [[t1, t1]]
    j = 0
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        while j < len(times) and times[j][0] < a:
            j += 1
        inside = []
        while j < len(times) and times[j][0] < b:
            inside.append(times[j][1])
            j += 1
        if not inside:
            out["not sampled"] = out.get("not sampled", 0.0) + (b - a)
            continue
        for lab in inside:
            out[lab] = out.get(lab, 0.0) + (b - a) / len(inside)
    return out
