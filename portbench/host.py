"""What the host did during a window, beside what the program did: this
process's CPU time (all its threads) over the window, and, after it, how
fast one core runs a fixed loop of Python (``probe``).  Printed on a line
of its own before a run's result, to tell a slow host from a slow
program (the same work taking more CPU time, a slower probe); no metric
reads it.  The machine-wide counters of ``/proc`` read a constant 100 %
busy and no steal on the card's machines, so they are not read."""

from __future__ import annotations

import os
import time


class Window:
    """Readings at the window's start; ``summary()`` at its end."""

    def __init__(self):
        self.t0 = time.perf_counter()
        t = os.times()
        self.cpu0 = t.user + t.system

    def summary(self) -> dict:
        wall = time.perf_counter() - self.t0
        t = os.times()
        cpu = t.user + t.system - self.cpu0
        return {"wall_s": wall, "process_cpu_s": cpu,
                "process_cores_used": cpu / wall, "cores": os.cpu_count()}


def probe(n: int = 2_000_000) -> float:
    """Nanoseconds an iteration of a fixed loop of Python takes on one
    core now (the best of three)."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(n):
            x += i & 7
        best = min(best, time.perf_counter() - t)
    return 1e9 * best / n
