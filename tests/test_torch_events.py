"""The plain version of the device event detector (K9,
f5c_tpu_torch/ops/events_device.py:detect_events_plain, the CPU path of
ops/events_cuda.py) against the port's host detector
``native.detect_events``, the JAX package's NumPy oracle
``events_ref.detect_events`` and its device op ``detect_events_device``
(eager, through ``detect_events_batch(eager=True)``), bit for bit: on the
6 golden signals, on synthetic DNA signals of a few lengths (one of tiny
values, whose prefix sums round), on a synthetic RNA signal, and on the
densest signal found, which is held to the NumPy oracle and the host
detector only.  Then call-methylation with ``--events-engine device
--device cpu`` against ``--events-engine host``: the same bytes.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from f5c_tpu.ops.events_device import detect_events_batch as jax_batch
from f5c_tpu.ops.events_ref import detect_events as ref_detect
from f5c_tpu_torch import datasets, native, synthetic
from f5c_tpu_torch.io.slow5 import Slow5File
from f5c_tpu_torch.models import builtin_model
from f5c_tpu_torch.ops import events_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")


def _golden_signals():
    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    return [f.get(r).to_pa() for r in f.read_ids()]


def _synthetic():
    rng = np.random.default_rng(2031)
    return synthetic.event_signals(rng, builtin_model("dna_r9_nucleotide"),
                                   builtin_model("rna_r9_nucleotide"))


def _same(a, b):
    return (a[0].dtype == np.int64 and np.array_equal(a[0], b[0])
            and all(x.dtype == np.float32 and x.tobytes() == y.tobytes()
                    for x, y in zip(a[1:], b[1:])))


def _check(pas, rna, jax_op=True):
    ours = events_cuda.detect_events_batch(pas, rna, torch.device("cpu"))
    theirs = jax_batch(pas, rna=rna, eager=True) if jax_op else None
    for i, p in enumerate(pas):
        nat = native.detect_events(p, rna=rna)
        ref = ref_detect(p, rna=rna)
        assert _same(ours[i], (nat.start, nat.length, nat.mean, nat.stdv))
        assert _same(ours[i], (ref.start.astype(np.int64), ref.length,
                               ref.mean, ref.stdv))
        if jax_op:
            assert _same(ours[i], theirs[i])
    return ours


def test_events_plain_golden():
    ours = _check(_golden_signals(), rna=False)
    assert sum(o[0].shape[0] for o in ours) == 11521


@pytest.mark.parametrize("which", ["lengths", "long_and_tiny", "rna"])
def test_events_plain_synthetic(which):
    """Reads of 40-3,000 k-mers (and of 1, 5 and 11 samples) against all
    three; a read of 12,000 k-mers and one of tiny values against the
    oracle and the host detector: the JAX op's two-float prefix sums are
    exact only where no partial sum rounds, and on the tiny values they
    round (its events differ there), while the long read would cost the
    eager JAX scan most of this file's time."""
    sig = _synthetic()
    if which == "lengths":
        _check(sig["dna"][:3] + sig["dna"][6:], rna=False)
    elif which == "long_and_tiny":
        _check(sig["dna"][3:5], rna=False, jax_op=False)
    else:
        _check(sig["rna"], rna=True)


def test_events_plain_dense():
    """The densest signal found: about one event every three samples (a
    random search over repeated motifs found none denser), held to the
    NumPy oracle and the host detector; the device layout sizes every
    read for n + 1 events, the host detector's bound, so no read can
    overflow."""
    p = _synthetic()["dna"][5]
    ours = _check([p], rna=False, jax_op=False)
    assert ours[0][0].shape[0] > 0.33 * p.shape[0]


def test_events_empty_and_tiny_reads():
    """Reads of 0, 1, 5 and 11 samples, shorter than the t-stat windows:
    one event spanning the read (none empty but the first), as the host
    detector has them."""
    pas = [np.zeros(0, np.float32)] + _synthetic()["dna"][6:]
    ours = events_cuda.detect_events_batch(pas, False, torch.device("cpu"))
    for p, o in zip(pas, ours):
        nat = native.detect_events(p)
        assert _same(o, (nat.start, nat.length, nat.mean, nat.stdv))
    assert [o[0].shape[0] for o in ours[:3]] == [1, 1, 1]


def test_events_batch_sample_budget(monkeypatch):
    """The host wrapper splits a batch into calls of at most
    ``SAMPLE_BUDGET`` samples (a longer read alone), with the same
    events as one call."""
    pas = _golden_signals()
    whole = events_cuda.detect_events_batch(pas, False, torch.device("cpu"))
    sizes = []
    detect = events_cuda.detect_events

    def spy(pool, off, rna=False):
        sizes.append(off.shape[0] - 1)
        return detect(pool, off, rna)

    monkeypatch.setattr(events_cuda, "detect_events", spy)
    monkeypatch.setattr(events_cuda, "SAMPLE_BUDGET",
                        2 * max(p.shape[0] for p in pas))
    split = events_cuda.detect_events_batch(pas, False, torch.device("cpu"))
    assert sum(sizes) == 6 and 1 < len(sizes) < 6
    assert all(_same(a, b) for a, b in zip(split, whole))


def test_events_engine_resolution(capsys):
    """``auto`` is ``host`` on every device (the device engine won no
    configuration measured on the card: PERF.md) and ``device`` is taken
    when asked for, silently; runs that print or dump raw signals load
    read by read with the host detector and warn there, once a run
    (``test_dump_runs_with_device_engine_warn``), as in the JAX
    package."""
    from f5c_tpu_torch.pipeline.runner import Options, Pipeline

    model = builtin_model("dna_r9_nucleotide")
    for dev in ("cpu", "cuda"):
        for eng, want in (("auto", "host"), ("host", "host"),
                          ("device", "device")):
            for raw in (False, True):
                pipe = Pipeline.bare(
                    Options(events_engine=eng, print_raw=raw), model,
                    device=torch.device(dev))
                assert pipe._events_engine() == want
                assert pipe.supports_waves() is not raw
    assert capsys.readouterr().err == ""


def _meth(golden_dir, tag, *extra):
    from f5c_tpu_torch.cli import main

    out = os.path.join(golden_dir, f"meth_{tag}.tsv")
    rc = main(["call-methylation", "--device", "cpu", "--min-mapq", "0",
               "-b", os.path.join(golden_dir, "reads.bam"),
               "-g", os.path.join(golden_dir, "genome.fa"),
               "-r", os.path.join(golden_dir, "reads.fasta"),
               "--slow5", os.path.join(golden_dir, "signals.blow5"),
               "-o", out, *extra])
    assert rc == 0
    with open(out, "rb") as f:
        return f.read()


def test_call_methylation_device_events_same_bytes(tmp_path, monkeypatch):
    golden = str(tmp_path)
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), golden)
    calls = []
    detect = events_cuda.detect_events

    def spy(*a, **kw):
        calls.append(a[1].shape[0] - 1)
        return detect(*a, **kw)

    monkeypatch.setattr(events_cuda, "detect_events", spy)
    host = _meth(golden, "host", "--events-engine", "host")
    assert calls == []
    auto = _meth(golden, "auto")
    assert calls == []          # auto is host
    dev = _meth(golden, "device", "--events-engine", "device")
    assert sum(calls) == 6
    assert host.count(b"\n") > 1
    assert dev == host == auto


@pytest.fixture(scope="module")
def host_dump_run(tmp_path_factory):
    """The golden set, and one call-methylation run on it with
    ``--events-engine host --print-raw --write-dump``: its output, the raw
    signals it printed and the dump it wrote, the references of the
    device-engine runs below."""
    golden = str(tmp_path_factory.mktemp("dump_runs"))
    datasets.copy_dataset(
        datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB), golden)
    dump = os.path.join(golden, "host.dump")
    raw = io.StringIO()
    with contextlib.redirect_stdout(raw):
        out = _meth(golden, "host", "--events-engine", "host", "--print-raw",
                    "--write-dump", dump)
    with open(dump, "rb") as f:
        return golden, out, raw.getvalue(), f.read(), dump


@pytest.mark.parametrize("flag", ["--print-raw", "--write-dump",
                                  "--read-dump"])
def test_dump_runs_with_device_engine_warn(host_dump_run, capfd, flag):
    """``--print-raw``, ``--write-dump`` and ``--read-dump`` with
    ``--events-engine device`` exit 0, print the warning once and write
    the bytes of ``--events-engine host``: the same output, raw signals
    printed and dump written, and the same output read from the host
    run's dump."""
    golden, host, host_raw, host_dump, dump = host_dump_run
    extra = {"--print-raw": ["--print-raw"],
             "--write-dump": ["--write-dump",
                              os.path.join(golden, f"device{id(capfd)}.dump")],
             "--read-dump": ["--read-dump", dump]}[flag]
    capfd.readouterr()
    dev = _meth(golden, "device", "--events-engine", "device", *extra)
    out, err = capfd.readouterr()
    assert dev == host and host.count(b"\n") > 1
    assert err.count("events-engine device is ignored") == 1
    if flag == "--print-raw":
        assert out == host_raw and out.count("\tLN:") == 6
    if flag == "--write-dump":
        with open(extra[1], "rb") as f:
            assert f.read() == host_dump
