"""The pipeline's span recorder (``f5c_tpu_torch/pipeline/spans.py``).

On the golden set through the plain versions on the CPU: every
``stage_time`` key is the sum of its main-thread spans to the
nanosecond, in call-methylation and eventalign; the detail spans and
the host pool's and writer thread's counters are the sums of theirs;
with recording off the accumulators fill and no interval is kept;
``align.bands`` is the reads' band count.  On the clock: a span around
CPU-profiled torch ops holds their profiler events once converted by
``trace_start_ns()``, and ``--profile-dir`` writes the spans into the
trace beside the ops, on its time base.  On the card (``needs_cuda``):
a span around a synchronised ``abea_fill_kernel`` launch holds the
kernel's device span within 50 us at each end.  No JAX here.
"""

import argparse
import collections
import glob
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from f5c_tpu_torch import cli, datasets, synthetic
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import abea_cuda
from f5c_tpu_torch.ops.abea import band_offsets
from f5c_tpu_torch.pipeline.eventalign import run_eventalign
from f5c_tpu_torch.pipeline.runner import Options, Pipeline
from f5c_tpu_torch.pipeline.spans import Spans, trace_start_ns
from f5c_tpu_torch.pipeline.writer import AsyncWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
STAGES = ("load", "events", "align", "scaling", "hmm", "output")
# the stages' sub-spans, each on the main thread
DETAIL = ("events.load_host", "align.dispatch", "align.walk_sync",
          "hmm.collect_host", "hmm.dispatch_enqueue", "hmm.score_sync",
          "output.drain", "batch")
POOL = ("pool.events_s", "pool.scaling_s", "pool.hmm_s")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return datasets.copy_dataset(datasets.dataset(GOLDEN),
                                 str(tmp_path_factory.mktemp("spans")))


def _pipe(d, **kw):
    return Pipeline(d["bam"], d["genome"], d["reads"],
                    Options(min_mapq=0, slow5_path=d["slow5"], **kw),
                    device=torch.device("cpu"))


def _run(pipe, subcommand):
    out = io.StringIO()
    if subcommand == "call-methylation":
        pipe.call_methylation(out=out)
    else:
        run_eventalign(pipe, argparse.Namespace(), out=out)
    assert pipe.counters["processed"] == 6
    return out.getvalue()


@pytest.fixture(scope="module")
def recorded(golden):
    """{subcommand: (pipeline, the reads of each ABEA launch)} of a run
    with recording on."""
    runs = {}
    for sub in ("call-methylation", "eventalign"):
        pipe = _pipe(golden)
        launched = []
        real = pipe._launch_abea

        def launch(todo, dev, windowed=False, real=real, launched=launched):
            launched.append((list(todo), windowed))
            return real(todo, dev, windowed)

        pipe._launch_abea = launch
        pipe.spans.start()
        _run(pipe, sub)
        pipe.spans.stop()
        runs[sub] = pipe, launched
    return runs


def _ns_by_name(log, tid=None) -> dict:
    acc = collections.defaultdict(int)
    for name, t, t0, t1 in log:
        if tid is None or t == tid:
            acc[name] += t1 - t0
    return acc


@pytest.mark.parametrize("sub", ["call-methylation", "eventalign"])
def test_stage_time_is_the_sum_of_its_spans(recorded, sub):
    pipe, _ = recorded[sub]
    main = threading.main_thread().native_id
    ns = _ns_by_name(pipe.spans.log, main)
    assert set(pipe.stage_time) == set(STAGES)
    for key in STAGES:
        assert pipe.stage_time[key] > 0, key
        assert abs(pipe.stage_time[key] - ns[key] * 1e-9) < 1e-9, key
    # the stages partition the main thread's time: no two overlap
    stage = sorted((t0, t1) for n, t, t0, t1 in pipe.spans.log
                   if t == main and n in STAGES)
    assert all(a[1] <= b[0] for a, b in zip(stage, stage[1:]))
    # a load span a resumption of the BAM loop: one a batch and the last
    loads = [s for s in pipe.spans.log if s[0] == "load"]
    batches = [s for s in pipe.spans.log if s[0] == "batch"]
    assert len(loads) == len(batches) + 1 == pipe._n_batches + 1


@pytest.mark.parametrize("sub", ["call-methylation", "eventalign"])
def test_detail_spans_and_thread_counters(recorded, sub):
    pipe, _ = recorded[sub]
    main = threading.main_thread().native_id
    log = pipe.spans.log
    ns = _ns_by_name(log, main)
    detail = [k for k in DETAIL if sub == "call-methylation"
              or not k.startswith("hmm.")]
    for key in detail:
        assert abs(pipe.stage_detail[key] - ns[key] * 1e-9) < 1e-9, key
    # the host pool's tasks, summed over their threads
    ns_all = _ns_by_name(log)
    pool = POOL if sub == "call-methylation" else POOL[:2]
    for key in pool:
        assert pipe.stage_detail[key] > 0, key
        assert abs(pipe.stage_detail[key] - ns_all[key] * 1e-9) < 1e-9
    # the writer thread: a render and a write span a chunk
    writer = [(n, t) for n, t, *_ in log if n.startswith("writer.")]
    assert {t for _, t in writer} and main not in {t for _, t in writer}
    assert sum(n == "writer.write" for n, _ in writer) == \
        pipe.stage_detail["writer.chunks"] > 0
    for key in ("writer.render", "writer.write"):
        assert abs(pipe.stage_detail[key] - ns_all[key] * 1e-9) < 1e-9
    # counters: the ABEA's bytes each way (and the HMM's)
    for key in ("align.h2d_bytes", "align.d2h_bytes") + (
            ("hmm.h2d_bytes", "hmm.d2h_bytes")
            if sub == "call-methylation" else ()):
        assert pipe.stage_detail[key] > 0, key
    assert "align.band_cells" not in pipe.stage_detail


def test_recording_off_keeps_no_interval(golden, recorded):
    pipe = _pipe(golden)
    _run(pipe, "call-methylation")
    assert not pipe.spans.recording and pipe.spans.log == []
    on, _ = recorded["call-methylation"]
    for key in STAGES:
        assert pipe.stage_time[key] > 0, key
    assert set(pipe.stage_detail) == set(on.stage_detail)
    for key in ("align.bands", "align.h2d_bytes", "hmm.n_windows",
                "writer.chunks", "align.n_dispatch", "hmm.n_dispatch"):
        assert pipe.stage_detail[key] == on.stage_detail[key], key


def _bands(todo, k) -> int:
    ev_len = np.array([r.n_events for r in todo], np.int32)
    rk_len = np.array([len(r.seq) - k + 1 for r in todo], np.int32)
    return int(band_offsets(ev_len, rk_len)[-1])


@pytest.mark.parametrize("sub", ["call-methylation", "eventalign"])
def test_align_bands_equal_band_offsets(recorded, sub):
    pipe, launched = recorded[sub]
    k = pipe.model.k
    assert launched and not any(w for _, w in launched)
    want = sum(_bands(todo, k) for todo, _ in launched)
    assert pipe.stage_detail["align.bands"] == want
    assert pipe.stage_detail["align.n_dispatch"] == len(launched) == sum(
        n == "align.dispatch" for n, *_ in pipe.spans.log)
    # each read: events + k-mers + 2 bands (18,338 over the golden six)
    assert want == sum(r.n_events + len(r.seq) - k + 3
                       for todo, _ in launched for r in todo)


def test_windowed_bands_and_window_spans(golden):
    """The golden reads forced through the windowed ABEA: their bands
    count as ``align.bands_windowed``, a window dispatch a span (a
    budget under each read's own launch, 2,679 x 39.25 B and up, and
    over six reads' window launch, 6 x 300 x 39.25 B)."""
    pipe = _pipe(golden)
    pipe.TRACE_BYTES_BUDGET = 100_000
    pipe.WIN_BANDS = 300
    pipe.spans.start()
    _run(pipe, "call-methylation")
    d = pipe.stage_detail
    assert d["align.ultra_reads"] == 6 and "align.bands" not in d
    assert d["align.bands_windowed"] == 18_338
    windows = [s for s in pipe.spans.log if s[0] == "align.window"]
    assert len(windows) == pipe._n_batches   # a dispatch a batch here
    assert abs(d["align.window"] - sum(t1 - t0 for *_, t0, t1 in windows)
               * 1e-9) < 1e-9


def test_span_contains_cpu_profiled_ops():
    """Spans converted by the trace's start hold the torch ops run inside
    them, and not those of the span before."""
    from torch.profiler import ProfilerActivity, profile

    sp = Spans({}, collections.defaultdict(float))
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp.start()
        t0 = sp.now()
        y = torch.tanh(x)
        sp.add("first", t0)
        time.sleep(0.02)
        t0 = sp.now()
        for _ in range(3):
            y = y @ x
        sp.add("second", t0)
        sp.stop()
    spans = {n: (a, b) for n, _, a, b in sp.intervals(trace_start_ns(prof))}
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    tanh = [e for e in prof.events() if e.name == "aten::tanh"]
    assert len(mm) == 3 and len(tanh) == 1

    def inside(ev, name) -> bool:
        a, b = spans[name]
        return a <= ev.time_range.start / 1e6 <= ev.time_range.end / 1e6 <= b

    assert all(inside(e, "second") and not inside(e, "first") for e in mm)
    assert inside(tanh[0], "first") and not inside(tanh[0], "second")
    # within a few milliseconds: the conversion is no guess
    assert mm[0].time_range.start / 1e6 - spans["second"][0] < 5e-3


def test_profile_dir_trace_holds_spans_and_ops(golden, tmp_path):
    """``--profile-dir`` on the CPU: the exported trace holds the host's
    operators and the pipeline's spans, and the plain ABEA fill's
    operators lie inside the main thread's ``align.dispatch`` span."""
    prof = str(tmp_path / "prof")
    out = str(tmp_path / "meth.tsv")
    assert cli.main(["call-methylation", "--device", "cpu", "--min-mapq",
                     "0", "-b", golden["bam"], "-g", golden["genome"], "-r",
                     golden["reads"], "--slow5", golden["slow5"], "-o", out,
                     "-K", "1", "--debug-break", "1",
                     "--profile-dir", prof]) == 0
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "f5c_span"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    names = {e["name"] for e in spans}
    assert {"load", "events", "align", "align.dispatch", "scaling", "hmm",
            "output", "batch"} <= names
    assert {"name": "MainThread"} in [e["args"] for e in events
                                      if e["name"] == "thread_name"]
    (disp,) = [e for e in spans if e["name"] == "align.dispatch"]
    main = disp["tid"]
    inside = [e for e in ops if e.get("tid") == main
              and disp["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= disp["ts"] + disp["dur"]]
    assert len(inside) > 100
    assert not [e for e in ops if e.get("tid") == main
                and e["ts"] < disp["ts"] < e["ts"] + e["dur"]
                and e["name"].startswith("aten::")]


def test_pool_task_sums_under_contention():
    """Sixteen threads adding to one key through ``task``: the sum keeps
    every task (a lost update would break it)."""
    sp = Spans({}, collections.defaultdict(float))
    sp.start()
    busy = sp.task("pool.x_s", lambda n: sum(range(n)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [busy(50)
                                                    for _ in range(500)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(sp.log) == 16 * 500
    assert abs(sp.stage_detail["pool.x_s"]
               - sum(t1 - t0 for *_, t0, t1 in sp.log) * 1e-9) < 1e-9


def test_writer_times_its_chunks():
    sp = Spans({}, collections.defaultdict(float))
    sp.start()
    buf = io.StringIO()
    w = AsyncWriter(buf, sp)
    w.write("a\n")
    w.write_lazy(lambda: b"b\n")
    w.close()
    assert buf.getvalue() == "a\nb\n"
    d = sp.stage_detail
    assert d["writer.chunks"] == 2
    names = [n for n, *_ in sp.log]
    assert names == ["writer.write", "writer.render", "writer.write"]
    assert {t for _, t, *_ in sp.log} == {w._thread.native_id}


@pytest.mark.needs_cuda
def test_span_contains_fill_kernel_on_card():
    """A span around a synchronised K1 launch holds the kernel's device
    span within 50 us at each end: the recorder's clock is the device
    trace's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", torch.cuda.current_device())
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(7)
    seqs, events = synthetic.abea_reads(rng, [3000, 2500, 1800, 900],
                                        model)
    x = {k: (torch.as_tensor(np.ascontiguousarray(v), device=dev)
             if isinstance(v, np.ndarray) else v)
         for k, v in synthetic.abea_inputs(seqs, events, model).items()}
    args = [x[k] for k in ("ev_pool", "ev_off", "ev_len", "seq_packed",
                           "seq_off", "rk_len", "k", "level_mean",
                           "level_stdv", "level_log_stdv", "params",
                           "band_off")]
    abea_cuda.abea_fill(*args, x["n_bands"])      # build and warm
    torch.cuda.synchronize()
    sp = Spans({}, collections.defaultdict(float))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sp.start()
        for i in range(3):
            t0 = sp.now()
            abea_cuda.abea_fill(*args, x["n_bands"])
            torch.cuda.synchronize()
            sp.add(f"fill{i}", t0)
            time.sleep(0.005)
        sp.stop()
    spans = sorted(sp.intervals(trace_start_ns(prof)), key=lambda s: s[2])
    kernels = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "abea_fill" in e.name)
    assert len(kernels) == 3
    for (_, _, a, b), (k0, k1) in zip(spans, kernels):
        assert a - 50e-6 <= k0 and k1 <= b + 50e-6, (a, b, k0, k1)
