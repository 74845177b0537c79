#!/usr/bin/env python3
"""The pipeline's spans over a benchmark cell's traced window, on one card.

    python3 scripts/span_window.py --workload meth-r9-typical \\
        --seed 3000000011 --seconds 51 --record 1 [--out FILE.jsonl]

One ``--trace 1`` run of the cell exactly as ``python3 -m portbench.run``
makes it (``portbench.run.run_cell``: the same pool, warm pass, profiler,
sampler and window), with the pipeline's span recorder switched on at
the window's start and off at its end (``--record 1``; ``--record 0``
leaves it off, the run as the benchmark makes it).  Prints, and appends
to ``--out`` as one JSON line:

- ``throughput_kb_s`` and the accepted per-layer metrics of the run, with
  the sampler's idle gaps (``breakdown``);
- with ``--record 1``, the five readings of ``portbench.program_spans``
  (``bam_s_per_mb``, ``batch_span_p95_s``, ``events_worker_s_per_mb``,
  ``writer_s_per_mb``, ``idle_outside_spans_pct``) on the profiler's
  clock (each span converted by the trace's ``trace_start_ns()``); the
  longest idle stretches outside the spans, with the spans on each side
  and the sampler's labels inside; where the window starts on the
  profiler's clock (the sampler's breakdown takes it as 0); and the
  recording's size (spans, spans a second, bytes).

Run recording on and off in separate processes, in turns, to read the
recording's cost on throughput.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def span_readings(ctx, rec, prof, detail0, detail1, main) -> dict:
    """The recorder's spans over the window, converted to the trace's
    seconds by its ``trace_start_ns()``, read by ``portbench.program_spans``;
    ``main``: the main thread's native id."""
    from f5c_tpu_torch.pipeline.spans import trace_start_ns
    from portbench import program_spans as ps

    t_trace = trace_start_ns(prof)

    def on_trace(t):     # perf_counter seconds -> the trace's seconds
        return (rec.realtime_ns(int(t * 1e9)) - t_trace) * 1e-9

    w0 = on_trace(ctx.prof_t0)
    w1 = w0 + ctx.window_s
    spans = rec.intervals(t_trace)
    counters = {k: detail1.get(k, 0.0) - detail0.get(k, 0.0)
                for k in detail1}
    samples = [(on_trace(t), lab) for t, lab in ctx.samples]
    return {
        **ps.readings(spans, counters, ctx.spans, w0, w1, ctx.bases, main),
        "window_start_on_trace_s": w0,
        "main_span_s": ps.seconds_by_name(spans, main, w0, w1),
        "counters": {k: v for k, v in sorted(counters.items()) if v},
        **ps.gaps(spans, ctx.spans, samples, main, w0, w1),
        "spans_kept": len(rec.log),
        "spans_a_second": len(rec.log) / ctx.window_s,
        "bytes_kept": ps.kept_size(rec.log),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="span_window")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import threading

    import torch

    from portbench import driver, registry, run
    from portbench import trace as tr

    bench = registry.benchmark(ROOT)
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    held = {}
    patched = driver.pipeline, torch.profiler.profile, tr.Sampler
    make_pipeline, profile, sampler = patched

    def pipeline(*a, **k):
        held["pipe"] = make_pipeline(*a, **k)
        return held["pipe"]

    class Profile(profile):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            held["prof"] = self

    class Sampler(sampler):
        """The benchmark's sampler, entered at the window's start and
        left at its end: the recording's bounds."""

        def __enter__(self):
            pipe = held["pipe"]
            held["detail0"] = dict(pipe.stage_detail)
            if args.record:
                pipe.spans.start()
            return super().__enter__()

        def __exit__(self, *exc):
            pipe = held["pipe"]
            pipe.spans.stop()
            held["detail1"] = dict(pipe.stage_detail)
            return super().__exit__(*exc)

    driver.pipeline, torch.profiler.profile, tr.Sampler = \
        pipeline, Profile, Sampler
    try:
        ctx = run.run_cell(bench, cell, config, args.seed, args.seconds,
                           True, args.device)
    finally:
        driver.pipeline, torch.profiler.profile, tr.Sampler = patched
    out = {"workload": args.workload, "seed": args.seed,
           "record": args.record, "correct": ctx.correct,
           "throughput_kb_s": ctx.bases / ctx.window_s / 1e3,
           "window_s": ctx.window_s, "passes": ctx.passes,
           "per_layer": {k: v["value"] for k, v in
                         run.metrics(bench, ctx, "per_layer").items()},
           "breakdown": run.breakdown(ctx), "host": ctx.host}
    if args.device.startswith("cuda"):
        out["card"] = run.card_info()
    if args.record:
        out["spans"] = span_readings(
            ctx, held["pipe"].spans, held["prof"], held["detail0"],
            held["detail1"], threading.main_thread().native_id)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if ctx.correct else 1


if __name__ == "__main__":
    sys.exit(main())
