"""The readers of the program's spans, and the context an untraced run
hands them: ``bam_s_per_mb`` on hand-made contexts and on a whole small
run on the CPU, whose ``--trace 0`` context keeps the fields it had
before the program's span recorder; ``program_spans``' five readings on
hand-made spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from pbtest import ROOT, small, with_pending

from portbench import program_spans as ps
from portbench import registry, run

# the fields of an untraced run's context (run.run_cell)
UNTRACED = {"cell", "config", "seed", "trace", "setup_s", "window_s",
            "bases", "attempted", "batch_walls", "passes", "stage",
            "failed", "peak_bytes", "spans", "samples", "host",
            "setup_parts", "failed_reads", "threads", "trace_read_s",
            "reference_s", "correct", "numbers"}
STAGES = {"load", "events", "align", "scaling", "hmm", "output"}


def _ctx(load, bases):
    return SimpleNamespace(stage={"load": load, "events": 1.0},
                           bases=bases, trace=True)


@pytest.mark.parametrize("load,bases,want", [
    (0.5, 2_000_000, 0.25), (0.03, 6_000_000, 0.005),
    # a program that never adds to "load" (the parent of the recorder)
    (0.0, 2_000_000, None),
    # no batch completed
    (0.5, 0, None)])
def test_bam_s_per_mb_on_a_hand_made_context(load, bases, want):
    got = registry.metric("bam_s_per_mb").read(_ctx(load, bases))
    assert got == (None if want is None else pytest.approx(want))


def test_bam_s_per_mb_without_the_key():
    ctx = SimpleNamespace(stage={"events": 1.0}, bases=1e6, trace=True)
    assert registry.metric("bam_s_per_mb").read(ctx) is None


@pytest.mark.parametrize("pending", [False, True])
def test_bam_s_per_mb_is_reported_in_every_cell(pending):
    b = registry.benchmark(ROOT)
    b = with_pending(b) if pending else b
    for w in b["workloads"]:
        assert "bam_s_per_mb" in {m["name"] for m in registry.metrics_of(
            b, w["name"], "per_layer")}


@pytest.mark.parametrize("cell_name", ["meth-r9-typical", "m6anet-rna004"])
def test_untraced_context_and_the_load_span(cell_name, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    bench, cell, config = small(cell_name, reads=4,
                                median=1200 if "meth" in cell_name else 600,
                                batch_reads=2)
    ctx = run.run_cell(bench, cell, config, 2 ** 31 + 7, 0.0, False, "cpu",
                       passes=1)
    assert ctx.correct, ctx.numbers
    assert set(vars(ctx)) == UNTRACED
    assert set(ctx.stage) == STAGES and ctx.spans is None
    # the load spans of the window's pass: two batches and the rest
    value = registry.metric("bam_s_per_mb").read(ctx)
    assert value is not None and 0 < value
    assert ctx.stage["load"] < ctx.window_s


MAIN, POOL = 11, 12
# a 10 s window [100, 110] on the trace's clock: the main thread's spans
# (one batch of 4 s holding load, events and output; a second batch
# ending after the window), a pool task, and the card's spans
SPANS = [("batch", MAIN, 99.0, 103.0), ("load", MAIN, 99.0, 101.0),
         ("events", MAIN, 101.0, 102.0), ("output", MAIN, 102.5, 103.0),
         ("batch", MAIN, 103.0, 111.0), ("load", MAIN, 109.5, 110.5),
         ("pool.events_s", POOL, 101.0, 106.0)]
CARD = [(102.0, 102.25, "abea_fill"), (103.0, 108.0, "hmm"),
        (108.0, 109.0, "abea_walk")]


def test_union_and_uncovered():
    got = ps.union([(3, 4), (1, 2), (1.5, 2.5, "x"), (2.5, 3)])
    assert got == [[1, 4]]
    assert ps.uncovered([[1, 2], [3, 4]], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert ps.uncovered([[0, 5]], 1, 4) == []


def test_readings_on_hand_made_spans():
    counters = {"pool.events_s": 5.0, "writer.render": 0.2,
                "writer.write": 0.3}
    got = ps.readings(SPANS, counters, CARD, 100.0, 110.0, 2_000_000, MAIN)
    # load: [100, 101] and [109.5, 110] of the window
    assert got["bam_s_per_mb"] == pytest.approx(1.5 / 2)
    # the one batch that ends in the window
    assert got["batch_span_p95_s"] == pytest.approx(4.0)
    assert got["events_worker_s_per_mb"] == pytest.approx(2.5)
    assert got["writer_s_per_mb"] == pytest.approx(0.25)
    # idle and in no span but batch: [102.25, 102.5] and [109, 109.5]
    assert got["idle_outside_spans_pct"] == pytest.approx(7.5)
    assert ps.seconds_by_name(SPANS, MAIN, 100.0, 110.0) == pytest.approx(
        {"batch": 10.0, "events": 1.0, "load": 1.5, "output": 0.5})


def test_readings_of_an_empty_window():
    got = ps.readings([], {}, [], 0.0, 1.0, 0, MAIN)
    assert set(got) == {"bam_s_per_mb", "batch_span_p95_s",
                        "events_worker_s_per_mb", "writer_s_per_mb",
                        "idle_outside_spans_pct"}
    assert set(got.values()) == {None}


def test_gaps_name_the_spans_around_each_stretch():
    samples = [(102.3, "bgzf._read_block_at"), (102.4, "bgzf._read_block_at"),
               (109.2, "runner.batches")]
    got = ps.gaps(SPANS, CARD, samples, MAIN, 100.0, 110.0)
    first, second = got["longest_gaps"]
    assert first["ms"] == pytest.approx(500.0)
    assert (first["after_span"], first["before_span"]) == ("output", "load")
    assert second["ms"] == pytest.approx(250.0)
    assert (second["after_span"], second["before_span"]) == ("events",
                                                             "output")
    assert dict(got["idle_outside_by_sampler_s"]) == pytest.approx(
        {"bgzf._read_block_at": 0.25, "runner.batches": 0.5})
