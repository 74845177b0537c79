"""The pipeline's span recorder: every timer of ``Pipeline`` is a span.

A span has a name, a thread, a start and an end.  It always adds its
seconds to its accumulator -- ``Pipeline.stage_time`` for the six stages
(``load``, ``events``, ``align``, ``scaling``, ``hmm``, ``output``),
``Pipeline.stage_detail`` for every other name -- and, while recording
is on (``start`` ... ``stop``), it also keeps its interval.  Counters
(bytes, bands, chunks) add to ``stage_detail``.  With recording off a
span costs what a pair of clock reads and one addition cost.

The clock.  A span is stamped with ``time.perf_counter_ns()``
(CLOCK_MONOTONIC: no clock step moves a duration).  ``start`` takes one
anchor, a reading of ``time.time_ns()`` (CLOCK_REALTIME, the Unix-epoch
nanoseconds that torch.profiler's events and its ``trace_start_ns()``
carry) between two monotonic readings, so that a kept interval converts
to the profiler's time base: ``intervals(trace_start_ns)`` gives seconds
from the trace's start, ``chrome_events`` microseconds from an exported
trace's ``baseTimeNanoseconds``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time


class Spans:
    """The recorder of one ``Pipeline``: accumulators, the recording
    switch and the kept intervals ``(name, native thread id, start ns,
    end ns)`` on the monotonic clock."""

    def __init__(self, stage_time: dict, stage_detail: dict):
        self.stage_time = stage_time
        self.stage_detail = stage_detail
        self.recording = False
        self.log: list = []
        self.threads: dict = {}        # native thread id -> thread name
        self.anchor = (0, 0)           # (realtime ns, monotonic ns)
        self._lock = threading.Lock()  # the host pool's tasks share keys

    now = staticmethod(time.perf_counter_ns)

    def add(self, name: str, t0: int, t1: int | None = None,
            sub: str | None = None) -> int:
        """The span ``name`` from ``t0`` to ``t1`` (now by default), and
        with ``sub`` a span of that name with the same bounds; returns
        ``t1``."""
        if t1 is None:
            t1 = time.perf_counter_ns()
        dt = (t1 - t0) * 1e-9
        acc = self.stage_time if name in self.stage_time else \
            self.stage_detail
        acc[name] += dt
        if sub is not None:
            self.stage_detail[sub] += dt
        if self.recording:
            self._keep(name, t0, t1)
            if sub is not None:
                self._keep(sub, t0, t1)
        return t1

    def task(self, name: str, fn):
        """``fn`` as a task of the host pool: each call a span ``name``
        on the thread that runs it (two clock reads a call), its seconds
        summed over the threads."""

        def timed(*args):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args)
            finally:
                t1 = time.perf_counter_ns()
                with self._lock:
                    self.stage_detail[name] += (t1 - t0) * 1e-9
                if self.recording:
                    self._keep(name, t0, t1)

        return timed

    def count(self, name: str, n) -> None:
        self.stage_detail[name] += n

    def _keep(self, name: str, t0: int, t1: int) -> None:
        tid = threading.get_native_id()
        if tid not in self.threads:
            self.threads[tid] = threading.current_thread().name
        self.log.append((name, tid, t0, t1))

    # ---- recording ----------------------------------------------------
    def start(self) -> None:
        """Keep every span's interval from now on (the intervals kept
        before are dropped), anchored to the realtime clock now."""
        m0 = time.perf_counter_ns()
        rt = time.time_ns()
        m1 = time.perf_counter_ns()
        self.anchor = (rt, (m0 + m1) // 2)
        self.log = []
        self.threads = {}
        self.recording = True

    def stop(self) -> None:
        self.recording = False

    def realtime_ns(self, t: int) -> int:
        """A monotonic stamp of this process on the realtime clock."""
        return self.anchor[0] + t - self.anchor[1]

    def intervals(self, base_ns: int = 0) -> list:
        """[(name, native thread id, start s, end s)] of the kept spans,
        in seconds from ``base_ns`` (Unix-epoch nanoseconds: a
        torch.profiler trace's ``trace_start_ns()``)."""
        off = self.anchor[0] - self.anchor[1] - base_ns
        return [(n, tid, (t0 + off) * 1e-9, (t1 + off) * 1e-9)
                for n, tid, t0, t1 in self.log]

    def chrome_events(self, base_ns: int, pid: int) -> list:
        """The kept spans as Chrome trace events: complete events in
        microseconds from ``base_ns``, and each thread's name."""
        off = self.anchor[0] - self.anchor[1] - base_ns
        out = [{"ph": "X", "cat": "f5c_span", "name": n, "pid": pid,
                "tid": tid, "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3}
               for n, tid, t0, t1 in self.log]
        out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": name}}
                for tid, name in self.threads.items()]
        return out


def trace_start_ns(prof) -> int:
    """The Unix-epoch nanoseconds from which a stopped torch.profiler
    ``profile``'s events count (their ``time_range`` in microseconds)."""
    return prof.profiler.kineto_results.trace_start_ns()


def add_to_chrome_trace(path: str, spans: Spans) -> None:
    """Write ``spans``' kept intervals into the Chrome trace at ``path``
    (torch.profiler's ``export_chrome_trace``), on its time base: its
    events' ``ts`` count microseconds from ``baseTimeNanoseconds`` (from
    the epoch where it has none).  The events go in at the head of
    ``traceEvents`` as text: a host trace runs to hundreds of MB, which
    a JSON round trip would take tens of seconds to rewrite."""
    with open(path) as f:
        text = f.read()
    at = text.index('"traceEvents"')
    base = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', text[:at]) or \
        re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', text[-4096:])
    ours = ",".join(json.dumps(e) for e in spans.chrome_events(
        int(base.group(1)) if base else 0, os.getpid()))
    at = text.index("[", at) + 1
    if ours and not re.compile(r"\s*\]").match(text, at):
        ours += ","
    with open(path, "w") as f:
        f.write(text[:at])
        f.write(ours)
        f.write(text[at:])
