"""The program's spans over a traced window, read on the profiler's clock.

The program's recorder (``f5c_tpu_torch.pipeline.spans.Spans``) keeps
each span as (name, native thread id, start, end); converted by the
trace's ``trace_start_ns()`` (``Spans.intervals``) they count seconds on
the clock of the card's spans (``ctx.spans``).  ``readings`` gives five
per-layer readings of a window from them and from the window's counter
deltas (``Pipeline.stage_detail`` at its end less at its start):

- ``bam_s_per_mb``: the main thread's ``load`` spans, a megabase;
- ``batch_span_p95_s``: the 95th percentile of the ``batch`` spans that
  end in the window;
- ``events_worker_s_per_mb``: ``pool.events_s``, the host pool's event
  tasks summed over its threads, a megabase;
- ``writer_s_per_mb``: the writer thread's ``writer.render`` and
  ``writer.write``, a megabase;
- ``idle_outside_spans_pct``: the share of the window in which the card
  is idle and the main thread in no span but ``batch``.

``gaps`` says what lies in the longest of those idle stretches.
``scripts/span_window.py`` switches the recorder on over a benchmark
window and prints both.
"""

from __future__ import annotations

import bisect
import collections
import sys

import numpy as np


def union(spans):
    """Sorted disjoint [start, end] of (start, end, ...) spans."""
    out = []
    for a, b, *_ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(spans, w0, w1):
    return [(max(a, w0), min(b, w1)) for a, b in spans
            if b > w0 and a < w1]


def uncovered(covered, w0, w1):
    """The gaps of [w0, w1] outside the disjoint sorted ``covered``."""
    gaps, t = [], w0
    for a, b in covered:
        if a > t:
            gaps.append((t, min(a, w1)))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return [(a, b) for a, b in gaps if b > a]


def _main_spans(spans, main, w0, w1):
    return [s for s in spans if s[1] == main and s[2] < w1 and s[3] > w0]


def idle_outside(spans, card, main, w0, w1):
    """The stretches of [w0, w1] in which no card span and no main-thread
    span other than ``batch`` runs."""
    host = union((a, b) for n, _t, a, b in _main_spans(spans, main, w0, w1)
                 if n != "batch")
    both = union(clipped(host, w0, w1)
                 + clipped([(a, b) for a, b, *_ in card], w0, w1))
    return uncovered(both, w0, w1)


def readings(spans, counters, card, w0, w1, bases, main) -> dict:
    """The five readings of the window [w0, w1] (trace seconds).

    ``spans``: [(name, native thread id, start s, end s)] on the trace's
    clock; ``counters``: the window's ``stage_detail`` deltas; ``card``:
    the card's spans, (start s, end s, ...); ``bases``: the read bases
    the window completed; ``main``: the main thread's native id."""
    mb = bases / 1e6
    if not mb:
        return dict.fromkeys(("bam_s_per_mb", "batch_span_p95_s",
                              "events_worker_s_per_mb", "writer_s_per_mb",
                              "idle_outside_spans_pct"))
    mains = _main_spans(spans, main, w0, w1)
    load = sum(min(b, w1) - max(a, w0) for n, _t, a, b in mains
               if n == "load")
    batches = [b - a for n, _t, a, b in mains if n == "batch" and b <= w1]
    idle = sum(b - a for a, b in idle_outside(spans, card, main, w0, w1))
    return {
        "bam_s_per_mb": load / mb,
        "batch_span_p95_s": (float(np.percentile(batches, 95))
                             if batches else None),
        "events_worker_s_per_mb": counters.get("pool.events_s", 0.0) / mb,
        "writer_s_per_mb": (counters.get("writer.render", 0.0)
                            + counters.get("writer.write", 0.0)) / mb,
        "idle_outside_spans_pct": 100.0 * idle / (w1 - w0),
    }


def seconds_by_name(spans, main, w0, w1) -> dict:
    """The main thread's seconds in the window, by span name."""
    out = collections.defaultdict(float)
    for n, _t, a, b in _main_spans(spans, main, w0, w1):
        out[n] += min(b, w1) - max(a, w0)
    return dict(sorted(out.items()))


def gaps(spans, card, samples, main, w0, w1, top=12) -> dict:
    """What lies around the card's idle stretches outside the main
    thread's spans: the ``top`` longest, each with the main-thread spans
    that end before and start after it and the sampler's labels inside
    (``samples``: [(trace s, label)]), and every stretch's seconds by the
    sampler's label."""
    stretches = idle_outside(spans, card, main, w0, w1)
    mains = [s for s in _main_spans(spans, main, w0, w1) if s[0] != "batch"]
    ends = sorted((b, n) for n, _t, a, b in mains)
    starts = sorted((a, n) for n, _t, a, b in mains)
    longest = []
    for a, b in sorted(stretches, key=lambda g: g[0] - g[1])[:top]:
        before = max((e for e in ends if e[0] <= a + 1e-9),
                     default=(None, None))[1]
        after = min((s for s in starts if s[0] >= b - 1e-9),
                    default=(None, None))[1]
        seen = collections.Counter(lab for t, lab in samples if a <= t < b)
        longest.append({"start_s": a - w0, "ms": (b - a) * 1e3,
                        "after_span": before, "before_span": after,
                        "sampled": seen.most_common(3)})
    samples = sorted(samples)
    times = [t for t, _ in samples]
    labels = collections.defaultdict(float)
    for a, b in stretches:
        seen = [lab for _, lab in samples[bisect.bisect_left(times, a):
                                          bisect.bisect_left(times, b)]]
        for lab in seen:
            labels[lab] += (b - a) / len(seen)
        if not seen:
            labels["not sampled"] += b - a
    return {"longest_gaps": longest,
            "idle_outside_by_sampler_s": sorted(
                labels.items(), key=lambda kv: -kv[1])[:10]}


def kept_size(log) -> int:
    """The bytes a recorder's kept spans hold."""
    return sys.getsizeof(log) + sum(
        sys.getsizeof(s) + sum(sys.getsizeof(x) for x in s[1:])
        for s in log)
