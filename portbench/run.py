"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: generate the cell's pool from the seed into a directory under
TMPDIR, index it with the program's ``index`` step, build one
``Pipeline`` and pass over the pool once (every shape of the window, and
the program's kernel build on a checkout's first run).  Window: pass over
the pool again and again until ``--seconds`` have gone, each pass one
call of the subcommand, its output into an in-process sink.  Then the
reference judges a seeded sample of the reads the window completed, and
the last line of standard output is the result: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from
a torch.profiler trace of the window.

Exits 2 without a card (or fewer than the cell asks for), 3 when JAX or
the JAX package was loaded.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "f5c_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info() -> dict:
    import torch

    info = {"name": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
        info["power_limit"] = out.stdout.strip().split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def run_cell(bench: dict, cell: dict, config: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             setup_t0: float | None = None, passes: int | None = None,
             control: bool = False) -> SimpleNamespace:
    """Set-up, window and check of one run; returns the run's context
    (what the metric readers read) with ``correct`` and ``numbers``.
    ``passes``: a window of that many whole passes, whatever the time;
    ``control``: also judge the control (the reference in bfloat16) in
    the program's place, as ``control_numbers``."""
    import torch

    from . import check, driver, host, registry, work
    from . import trace as tr

    on_card = device.startswith("cuda")
    dev = torch.device(device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_setup0 = time.perf_counter() if setup_t0 is None else setup_t0
    age0 = process_age() if setup_t0 is None else 0.0
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    try:
        marks = [("start", time.perf_counter())]
        pool = registry.generator(cell["generator"]).generate(
            cell, config, seed, os.path.join(tmp.name, "pool"))
        marks.append(("pool", time.perf_counter()))
        driver.index(pool)
        marks.append(("index", time.perf_counter()))
        pipe = driver.pipeline(pool, config, dev)
        marks.append(("pipeline", time.perf_counter()))
        sampled = check.sample(pool, cell, seed)
        keys = {check.key_of(r, config) for r in sampled}
        kf = driver.key_field(config)
        driver.one_pass(pipe, config, driver.Sink(kf, set()), driver.Clock())
        sync()
        marks.append(("warm pass", time.perf_counter()))

        clock = driver.Clock(stash=trace)
        st0, cn0 = dict(pipe.stage_time), dict(pipe.counters)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = sampler = None
        if trace:
            # the card's activity alone on a card: the metrics read no
            # host op of the profiler (the sampler stands for the host)
            acts = [torch.profiler.ProfilerActivity.CUDA if on_card
                    else torch.profiler.ProfilerActivity.CPU]
            prof = torch.profiler.profile(activities=acts)
            sampler = tr.Sampler()
            prof.__enter__()
            sampler.__enter__()
            marks.append(("profiler", time.perf_counter()))
        hw = host.Window()
        t_start = time.perf_counter()
        setup_s = age0 + (t_start - t_setup0)
        clock.stop_at = None if passes else t_start + seconds
        n_passes, passes = passes, []
        while True:
            sink = driver.Sink(kf, keys)
            driver.one_pass(pipe, config, sink, clock)
            passes.append((sink, not clock.stopped))
            if n_passes is not None:
                if len(passes) == n_passes:
                    break
            elif clock.stopped or time.perf_counter() >= clock.stop_at:
                break
        sync()
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        host_window = hw.summary()
        host_window["python_ns_per_iter"] = host.probe()
        if trace:
            sampler.__exit__(None, None, None)

        # the program's rows of the sampled reads the window completed,
        # and of the reads it failed
        program, differing = {}, 0
        first = next((s for s, whole in passes if whole), None)
        for s, whole in passes:
            bad = whole and first is not None and s.sha.digest() != \
                first.sha.digest()
            for key, text in s.rows.items():
                if key in program and program[key] != text:
                    bad = True
                program.setdefault(key, text)
            differing += bool(bad)
        due = [r for r in sampled if r.qname in clock.done_reads]
        failed = check.failed_sample(
            pool, clock.failed_reads, clock.done_reads,
            any(whole for _, whole in passes), seed)
        due = sorted({r.read_idx: r for r in due + failed}.values(),
                     key=lambda r: r.read_idx)
        for r in due:
            program.setdefault(check.key_of(r, config), "")

        # the reference runs on the CPU, in worker processes, while this
        # one stops the profiler, reads its trace and frees the program
        t_ref = time.perf_counter()
        pending = check.Pending(pool, config, due, cell=cell, seed=seed)
        try:
            if trace:
                prof.__exit__(None, None, None)
            ctx = SimpleNamespace(
                cell=cell, config=config, seed=seed, trace=trace,
                setup_s=setup_s, window_s=t_end - t_start,
                bases=sum(b[1] for b in clock.batches),
                attempted=sum(b[2] for b in clock.batches),
                batch_walls=[b[0] for b in clock.batches],
                passes=len(passes),
                stage={k: v - st0.get(k, 0.0)
                       for k, v in pipe.stage_time.items()},
                failed=sum(pipe.counters[k] - cn0.get(k, 0) for k in (
                    "bad_signal", "failed_calibration", "failed_alignment",
                    "qc_fail")),
                peak_bytes=peak, spans=None, samples=None, host=host_window,
                setup_parts={b[0]: b[1] - a[1]
                             for a, b in zip(marks[:-1], marks[1:])},
                failed_reads=[(r.qname, r.read_idx, len(r.seq))
                              for r in failed],
                threads={"host_pool": getattr(getattr(
                    pipe, "_post_pool", None), "_max_workers", 1),
                    "torch": torch.get_num_threads()})
            if trace:
                ctx.spans = tr.device_spans(prof) if on_card else []
                ctx.samples = sampler.samples
                ctx.prof_t0 = t_start
                ctx.fill_bound_s = work.fill_bound(
                    clock.stash, pipe.model.k,
                    pipe.model.level_mean.shape[0], pipe.WAVE,
                    pipe._takes_window_path)
                if config["subcommand"] == "call-methylation":
                    ctx.hmm_bound_s = hmm_work(pool, pipe, clock.stash)
                del prof
            ctx.trace_read_s = time.perf_counter() - t_ref
            del pipe, clock
            if on_card:
                torch.cuda.empty_cache()
            answers = dict(zip((check.key_of(r, config) for r in due),
                               pending.result()))
        finally:
            pending.close()
        ctx.reference_s = time.perf_counter() - t_ref
        ctx.correct, ctx.numbers = check.judge(program, answers, config,
                                               cell, differing)
        if control:
            keys_due = [check.key_of(r, config) for r in due]
            bf = check.reference(pool, config, due, control=True,
                                 cell=cell, seed=seed)
            rows = {key: check.rows_of(a, config)
                    for key, a in zip(keys_due, bf)}
            ctx.control_correct, ctx.control_numbers = check.judge(
                rows, answers, config, cell, 0)
        return ctx
    finally:
        tmp.cleanup()


def hmm_work(pool, pipe, batches):
    """Bound seconds of the window's HMM launches."""
    from . import work
    from .reference.pipeline import ref_span

    k = pipe.cpg_model.k
    cache = {}

    def windows_of(r):
        if r.qname not in cache:
            name, genome = pool.contigs[r.tid]
            ref = genome[r.pos:ref_span(r.cigar, r.pos)]
            pairs = work.ref_aligned_events(r.cigar, r.pos, r.is_reverse,
                                            len(r.seq), r.b2e_start, k)
            cache[r.qname] = work.cpg_windows(ref, r.pos, pairs, k)
        return cache[r.qname]

    return work.hmm_bound(batches, pipe.WAVE,
                          pipe.cpg_model.level_mean.shape[0], windows_of)


def breakdown(ctx) -> dict:
    from . import trace as tr

    ops = sorted(tr.by_kernel(ctx.spans).items(), key=lambda kv: -kv[1][0])
    gaps = tr.idle_gaps(ctx.spans, 0.0, ctx.window_s, ctx.samples,
                        ctx.prof_t0)
    return {"device_ops": [[n, v[0]] for n, v in ops[:10]],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:10]}


def metrics(bench: dict, ctx, kind: str) -> dict:
    from . import registry

    out = {}
    for m in registry.metrics_of(bench, ctx.cell["name"], kind):
        value = registry.metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(bench: dict, ctx, chips: int, device_kind: str,
           platform: str = "gpu") -> dict:
    from . import trace as tr

    kind = "per_layer" if ctx.trace else "end_to_end"
    dev = {"platform": platform, "kind": device_kind, "count": chips,
           "memory_peak_bytes": ctx.peak_bytes or 0}
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics(bench, ctx, kind),
           "device": dev}
    if ctx.trace:
        dev["busy_s"] = tr.busy(ctx.spans)
        dev["window_s"] = ctx.window_s
        out["breakdown"] = breakdown(ctx)
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in ctx.numbers.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card['name']}, power.limit {card['power_limit']}; "
          f"host cpus: {os.cpu_count()}")
    ctx = run_cell(bench, cell, config, args.seed, args.seconds,
                   bool(args.trace), "cuda:0")
    print(f"program threads: host pool {ctx.threads['host_pool']}, torch "
          f"{ctx.threads['torch']}; set-up {ctx.setup_s:.1f} s, window "
          f"{ctx.window_s:.3f} s, "
          f"{ctx.passes} passes, {len(ctx.batch_walls)} batches, reference "
          f"{ctx.reference_s:.1f} s (the trace read in it: "
          f"{ctx.trace_read_s:.1f} s)")
    print("set-up by part (s): " + json.dumps(ctx.setup_parts))
    print("host over the window: " + json.dumps(ctx.host))
    if ctx.failed_reads:
        print("failed reads judged (name, BAM index, bases): "
              + ", ".join(f"{q} {i} {n}" for q, i, n in ctx.failed_reads))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the run is void",
              file=sys.stderr)
        return 3
    res = result(bench, ctx, cell["chips"], card["name"])
    print(f"portbench: result at {process_age():.1f} s of the process",
          file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
