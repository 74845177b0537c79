"""``correct`` as the harness decides it: whole runs through the program
on the CPU (the card look skipped), sound, with the control in the
program's place, and with the timed path broken underneath."""

from __future__ import annotations

import os

import numpy as np
import pytest
from pbtest import small

from portbench import run


def run_small(cell_name, tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    bench, cell, config = small(cell_name, reads=6,
                                median=1500 if "meth" in cell_name else 700)
    return run.run_cell(bench, cell, config, 2 ** 31 + 101, 0.0, False,
                        "cpu", passes=2, **kw)


@pytest.mark.parametrize("cell_name", ["meth-r9-typical", "m6anet-rna004"])
def test_sound_run_passes_and_the_control_fails(cell_name, tmp_path,
                                                monkeypatch):
    ctx = run_small(cell_name, tmp_path, monkeypatch, control=True)
    assert ctx.correct, ctx.numbers
    assert ctx.numbers["units_compared"][0] > 0
    assert ctx.passes == 2 and ctx.numbers["passes_differing"][0] == 0
    assert not ctx.control_correct, ctx.control_numbers
    # the reference's workers and multiprocessing's resource tracker
    # have ended and been waited for
    assert children() == []


def children() -> list:
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid():
            out.append(int(pid))
    return out


def _alter_scores(monkeypatch):
    """Every other HMM window's score off by five nats (outside f5c's
    tolerance for most calls) where the kernel's wrapper hands it on."""
    from f5c_tpu_torch.ops import hmm_cuda

    real = hmm_cuda.hmm_forward_meta

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[::2] += 5.0
        return out

    monkeypatch.setattr(hmm_cuda, "hmm_forward_meta", altered)


def _drop_half_meth(monkeypatch):
    """Half of each batch's reads scored and the rest left out."""
    from f5c_tpu_torch.pipeline.runner import Pipeline

    real = Pipeline.meth_batch

    def half(self, batch):
        sites = real(self, batch)
        return {id(r): sites.get(id(r), {}) for r in batch[::2]}

    monkeypatch.setattr(Pipeline, "meth_batch", half)


def _alter_m6anet(monkeypatch):
    """Every m6anet row's mean off by 0.05 pA where it is rendered."""
    from f5c_tpu_torch.pipeline import eventalign

    real = eventalign.emit_m6anet_tsv

    def altered(recs, read, *a, **k):
        sc = read.scaling
        means = read.event_means
        read.event_means = means + np.float32(0.05 * sc.scale)
        try:
            return real(recs, read, *a, **k)
        finally:
            read.event_means = means

    monkeypatch.setattr(eventalign, "emit_m6anet_tsv", altered)


def _drop_half_m6anet(monkeypatch):
    """Half of each batch's reads written and the rest left out."""
    from f5c_tpu_torch.pipeline import eventalign

    real = eventalign.emit_m6anet_tsv

    def half(recs, read, *a, **k):
        return real(recs, read, *a, **k) if read.read_idx % 2 else ""

    monkeypatch.setattr(eventalign, "emit_m6anet_tsv", half)


@pytest.mark.parametrize("cell_name,fault", [
    ("meth-r9-typical", _alter_scores),
    ("meth-r9-typical", _drop_half_meth),
    ("m6anet-rna004", _alter_m6anet),
    ("m6anet-rna004", _drop_half_m6anet),
], ids=["meth-answer-altered", "meth-half-left-out", "m6anet-answer-altered",
        "m6anet-half-left-out"])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, tmp_path,
                                            monkeypatch):
    fault(monkeypatch)
    ctx = run_small(cell_name, tmp_path, monkeypatch)
    assert not ctx.correct, ctx.numbers


def _fail_odd_reads(monkeypatch):
    """Every read at an odd BAM index failed for QC after its alignment,
    though f5c passes it."""
    from f5c_tpu_torch.pipeline import runner

    real = runner.Pipeline._finish_abea

    def failing(self, todo, *a, **k):
        out = real(self, todo, *a, **k)
        for r in todo:
            if r.read_idx % 2:
                r.status |= runner.FAILED_QUALITY_CHK
        return out

    monkeypatch.setattr(runner.Pipeline, "_finish_abea", failing)


@pytest.mark.parametrize("cell_name", ["meth-r9-typical", "m6anet-rna004"])
def test_a_read_the_program_failed_is_judged(cell_name, tmp_path,
                                             monkeypatch):
    """The reads the program failed join the check's sample, whatever the
    seeded sample (here one read) holds: f5c passes them, so the run is
    not correct."""
    _fail_odd_reads(monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    bench, cell, config = small(cell_name, reads=6,
                                median=1500 if "meth" in cell_name else 700)
    cell["check"].update(sample_reads=1)
    ctx = run.run_cell(bench, cell, config, 2 ** 31 + 103, 0.0, False,
                       "cpu", passes=2)
    assert ctx.failed == 6
    assert sorted(i for _, i, _ in ctx.failed_reads) == [1, 3, 5]
    assert not ctx.correct, ctx.numbers
