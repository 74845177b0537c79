#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f5c_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # phase 6's runs under torch.profiler

Phases (each prints one line; any failure raises and exits nonzero):

1. probe: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: the kernels of f5c_tpu_torch/csrc with nvcc for sm_90a;
3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card -- the ABEA kernels (unchunked and windowed) bit-identical,
   HMM forward within f5c_tpu_torch/ops/hmm.py's tolerance -- on the
   golden reads' own launches (also with every read forced through the
   windowed ABEA) and on synthetic batches (mixed read lengths, HMM
   windows wider than 128 k-mers, one read of ~5,000 bands in windows of
   1,000);
4. golden gates: ``f5c_tpu_torch.cli.main([...])`` on tests/data/golden,
   against the vendored truth under f5c's tolerance |x - t| <= 0.1|t| +
   0.02: call-methylation (6 reads, 0 deviant rows against meth.exp, every
   kernel of its path launched), the same with every read forced through
   the windowed ABEA, and eventalign --summary (0 deviant rows against
   eventalign.exp.gz and eventalign.summary.exp);
5. scale run: the golden set replicated to 510 reads (one batch of f5c's
   default -K 512) through call-methylation, twice warm; every copy's
   rows within tolerance of meth.exp; reads/s and stage times; then each
   kernel against its plain version on the launches of that run, timed
   with CUDA events at those shapes;
6. ultra run: 4 synthetic reads of 100-300 kb (datasets.ultra_dataset)
   through call-methylation and eventalign at the default settings, where
   every read takes the windowed ABEA, and again with the trace budget
   raised so that none does: per read the same walk bit for bit, the same
   output files; walls, peak device memory, windows per read; the window
   kernels held bit for bit to their plain versions, and timed, at two
   windows of the windowed run (the last one, from band ~786k, and a full
   one of 65,536 bands x 4 reads); the unchunked kernels timed.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it fails before printing results.

``--profile`` runs only phases 1-2 and phase 6's four configurations,
each warm three times and once under torch.profiler: walls, the card's
busy time and share of the wall, device ms and launches per kernel.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
COPIES = 85                 # 85 x 6 golden reads = 510 reads
FLOAT_COLS = (4, 5, 6)      # meth-out-version 1: llr, ll_meth, ll_unmeth
EA_FLOAT_COLS = (6, 7, 8, 10, 11, 12)    # tests/test_golden_e2e.py:104-125
SUMMARY_FLOAT_COLS = (9, 10, 11, 12, 13)
FORCE_BUDGET, FORCE_WIN = 1_000_000, 300  # every golden read windowed
SYNTH_WIN = 1000
KERNELS = {
    "abea_fill": ("f5c_tpu_torch/csrc/abea.cu", "f5c_tpu/ops/abea_ring.py:69"),
    "abea_walk": ("f5c_tpu_torch/csrc/abea.cu",
                  "f5c_tpu/ops/abea_ring.py:377"),
    "hmm_forward": ("f5c_tpu_torch/csrc/hmm.cu",
                    "f5c_tpu/ops/hmm_pallas.py:57"),
    "abea_fill_window": ("f5c_tpu_torch/csrc/abea_ultra.cu",
                         "f5c_tpu/ops/abea_ultra.py:49"),
    "abea_walk_window": ("f5c_tpu_torch/csrc/abea_ultra.cu",
                         "f5c_tpu/ops/abea_ultra.py:306"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class CapturedStderr:
    """Capture file descriptor 2 (the pipeline reports there) and echo it."""

    def __enter__(self):
        sys.stderr.flush()
        self._tmp = tempfile.TemporaryFile(mode="w+b")
        self._saved = os.dup(2)
        os.dup2(self._tmp.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stderr.flush()
        os.dup2(self._saved, 2)
        os.close(self._saved)
        self._tmp.seek(0)
        self.text = self._tmp.read().decode(errors="replace")
        self._tmp.close()
        sys.stderr.write(self.text)


class Spy:
    """Records the arguments of every call of the kernel wrappers while
    passing them through unchanged."""

    def __init__(self, modules):
        self.calls = {name: [] for name in KERNELS}
        self._orig = []
        for mod in modules:
            for name in KERNELS:
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self._orig.append((mod, name, fn))
                    setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return spy

    def close(self):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def run_cli(paths: dict, out: str, summary: str | None = None):
    """One call-methylation run through the CLI, or with ``summary`` one
    eventalign --summary run; returns (wall seconds, processed reads,
    stage-seconds line)."""
    from f5c_tpu_torch import cli

    argv = ["--device", "cuda", "--min-mapq", "0", "-b", paths["bam"], "-g",
            paths["genome"], "-r", paths["reads"], "--slow5", paths["slow5"],
            "-o", out]
    if summary is None:
        argv = ["call-methylation", "--meth-out-version", "1", *argv]
    else:
        argv = ["eventalign", "--summary", summary, *argv]
    with CapturedStderr() as cap:
        t0 = time.time()
        rc = cli.main(argv)
        wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    processed = int(cap.text.split("processed: ")[1].split(";")[0])
    stages = [ln for ln in cap.text.splitlines() if "stage seconds" in ln]
    return wall, processed, stages[-1].split("stage seconds: ")[1]


def deviant_rows(out_path: str, truth_path: str, copies: int = 0) -> int:
    """Rows of ``out_path`` outside f5c's tolerance of meth.exp; with
    ``copies``, read ``q``'s copies are each held to ``q``'s rows."""
    from f5c_tpu_torch.datasets import copy_name

    def rows(path):
        with open(path) as f:
            lines = f.read().rstrip("\n").split("\n")[1:]
        by_read = {}
        for ln in lines:
            c = ln.split("\t")
            by_read.setdefault(c[3], []).append(c)
        return by_read

    ours, truth = rows(out_path), rows(truth_path)
    want = ({copy_name(q, i): r for q, r in truth.items()
             for i in range(copies)} if copies else truth)
    if set(ours) != set(want):
        raise AssertionError(f"read sets differ: {len(ours)} vs {len(want)}")
    bad = 0
    for q, w_rows in want.items():
        o_rows = ours[q]
        if len(o_rows) != len(w_rows):
            raise AssertionError(f"{q}: {len(o_rows)} rows, want "
                                 f"{len(w_rows)}")
        for a, b in zip(o_rows, w_rows):
            for i, (x, y) in enumerate(zip(a, b)):
                if i == 3:
                    continue        # the read name (copy suffix)
                if i in FLOAT_COLS:
                    if abs(float(x) - float(y)) > 0.1 * abs(float(y)) + 0.02:
                        bad += 1
                        break
                elif x != y:
                    bad += 1
                    break
    return bad


def tolerant_bad(ours: str, truth: str, float_cols, norm_col=None) -> int:
    """Rows of ``ours`` outside f5c's tolerance of ``truth`` (the
    comparison of tests/test_golden_e2e.py); the row counts must agree.
    ``norm_col`` is compared by basename (a machine-specific path)."""
    a_rows = ours.rstrip("\n").split("\n")
    b_rows = truth.rstrip("\n").split("\n")
    if len(a_rows) != len(b_rows):
        raise AssertionError(f"row count {len(a_rows)} != {len(b_rows)}")
    bad = 0
    for la, lb in zip(a_rows[1:], b_rows[1:]):
        a, b = la.split("\t"), lb.split("\t")
        if norm_col is not None and len(a) > norm_col and len(b) > norm_col:
            a[norm_col] = os.path.basename(a[norm_col])
            b[norm_col] = os.path.basename(b[norm_col])
        ok = len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            if not ok:
                break
            if i in float_cols:     # (a nan compares as within)
                ok = not abs(float(x) - float(y)) > 0.1 * abs(float(y)) + 0.02
            else:
                ok = x == y
        bad += not ok
    return bad


def read_text(path: str) -> str:
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return f.read()


def compare_launches(spy_calls, torch):
    """Each recorded kernel call re-run through the kernel and the plain
    version on the card.  Returns {name: max_abs_err} (0 = bit-identical;
    ABEA must be, the HMM must be within tolerance)."""
    from f5c_tpu_torch.ops import (abea, abea_cuda, abea_ultra,
                                   abea_ultra_cuda, hmm, hmm_cuda)

    err = {}
    for args, kw in spy_calls["abea_fill"]:
        got = abea_cuda.abea_fill(*args, **kw)
        want = abea.abea_fill_plain(*args[:11])
        err["abea_fill"] = max(err.get("abea_fill", 0), _int_err(got, want))
    for args, kw in spy_calls["abea_walk"]:
        got = abea_cuda.abea_walk(*args, **kw)
        want = abea.abea_walk_plain(*args[:6])
        err["abea_walk"] = max(err.get("abea_walk", 0), _int_err(got, want))
    for args, kw in spy_calls["hmm_forward"]:
        got = hmm_cuda.hmm_forward(*args, **kw)
        want = hmm.hmm_forward_plain(*args, **kw)
        torch.testing.assert_close(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err["hmm_forward"] = max(err.get("hmm_forward", 0.0), e)
    for args, kw in spy_calls.get("abea_fill_window", ()):
        got = abea_ultra_cuda.abea_fill_window(*args, **kw)
        want = abea_ultra.fill_window_plain(*args, **kw)
        err["abea_fill_window"] = max(err.get("abea_fill_window", 0),
                                      _int_err(got, want))
    for args, kw in spy_calls.get("abea_walk_window", ()):
        got = abea_ultra_cuda.abea_walk_window(*args, **kw)
        want = abea_ultra.walk_window_plain(*args, **kw)
        err["abea_walk_window"] = max(err.get("abea_walk_window", 0),
                                      _int_err(got, want))
    for name in ("abea_fill", "abea_walk", "abea_fill_window",
                 "abea_walk_window"):
        if err.get(name, 0) != 0:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err[name]})")
    return err


def _int_err(got, want) -> int:
    """Largest difference of integer outputs; f32 outputs (the window
    state records, which hold ints as f32 bits) are compared as bits."""
    import torch

    e = 0
    for g, w in zip(got, want):
        if g is None or w is None:
            if (g is None) != (w is None):
                raise AssertionError("one output is missing")
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            e = max(e, int((g.long() - w.long()).abs().max()))
    return e


def synthetic_calls(torch, dev):
    """Kernel calls on synthetic inputs: mixed read lengths (one read whose
    events do not follow it) and HMM windows up to 300 k-mers wide."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model

    rng = np.random.default_rng(2026)
    nuc = builtin_model("dna_r9_nucleotide")
    cpg = builtin_model("dna_r9_cpg")
    n_kmers = [int(n) for n in rng.integers(20, 2000, 61)] + [127, 128, 129]
    seqs, events = synthetic.abea_reads(rng, n_kmers, nuc, unrelated=(5,))
    x = synthetic.abea_inputs(seqs, events, nuc)
    t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
         else v for k, v in x.items()}
    fill_args = tuple(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        "level_mean", "level_stdv", "level_log_stdv", "params",
        "band_off"))
    from f5c_tpu_torch.ops import abea

    trace, llk, start_e = abea.abea_fill_plain(*fill_args)
    walk_args = (trace, llk, t["band_off"], start_e, t["rk_len"],
                 t["byte_off"])
    w = synthetic.hmm_windows(
        rng, [int(n) for n in rng.integers(1, 300, 200)] + [129, 256, 300],
        cpg)
    hmm_args = tuple(torch.as_tensor(w[k], device=dev) for k in (
        "ranks", "n_km", "ev_pool", "ev_start", "stride", "n_ev", "scale",
        "shift", "var", "lp_stay", "lp_step", "level_mean", "level_stdv",
        "level_log_stdv"))
    return {"abea_fill": [(fill_args + (x["n_bands"],), {})],
            "abea_walk": [(walk_args + (x["n_bytes"],), {})],
            "hmm_forward": [(hmm_args, {"allow_pre": a, "allow_post": a})
                            for a in (True, False)]}


def synthetic_window_calls(torch, dev):
    """The windowed ABEA on synthetic reads (one of ~5,000 bands, in
    windows of SYNTH_WIN, and two shorter ones): the kernel path against
    the plain path and the unchunked kernels, bit for bit.  Returns the
    kernel calls it made, for compare_launches and timing."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import abea_cuda, abea_ultra, abea_ultra_cuda

    rng = np.random.default_rng(2027)
    nuc = builtin_model("dna_r9_nucleotide")
    seqs, events = synthetic.abea_reads(rng, [1850, 700, 129], nuc)
    x = synthetic.abea_inputs(seqs, events, nuc)
    t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
         else v for k, v in x.items()}
    args = tuple(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        "level_mean", "level_stdv", "level_log_stdv", "params",
        "band_off", "byte_off"))
    nb_max = int(np.diff(x["band_off"]).max())
    if abea_ultra.n_windows(nb_max, SYNTH_WIN) < 4:
        raise AssertionError("the synthetic read spans < 4 windows")
    spy = Spy([abea_ultra_cuda])
    try:
        got = abea_ultra_cuda.abea_align_windowed(
            *args, x["n_bytes"], nb_max, SYNTH_WIN)
    finally:
        spy.close()
    plain = abea_ultra.align_windowed(*args, x["n_bytes"], nb_max,
                                      SYNTH_WIN)
    unchunked = abea_cuda.abea_align(*args, x["n_bands"], x["n_bytes"])
    for name, want in (("plain", plain), ("unchunked", unchunked)):
        if _int_err(got, want) != 0:
            raise AssertionError(f"windowed ABEA differs from {name}")
    return spy.calls, dict(reads=len(seqs), bands=x["n_bands"],
                           longest=nb_max, win=SYNTH_WIN)


class WalkRecorder:
    """Records every read's ABEA result (walk length, start event, packed
    directions) as the pipeline hands it to the host decode."""

    def __init__(self, runner):
        import numpy as np

        self.got = {}
        self._cls = runner.Pipeline
        self._orig = orig = runner.Pipeline._postalign_qc_one
        got = self.got

        def record(pipe, r, rks, dirs_bytes, n, start_event, *rest):
            got[r.qname] = (
                int(n), int(start_event),
                np.asarray(dirs_bytes[:(n + 3) // 4]).tobytes(),
                r.n_events + len(r.seq) - pipe.model.k + 3)
            return orig(pipe, r, rks, dirs_bytes, n, start_event, *rest)

        self._cls._postalign_qc_one = record

    def close(self):
        self._cls._postalign_qc_one = self._orig


def time_unchunked_kernels(torch, calls) -> dict:
    """The unchunked ABEA kernels of an ultra run, timed at its shapes
    (ms)."""
    from f5c_tpu_torch.ops import abea_cuda

    fill, walk = calls["abea_fill"][0][0], calls["abea_walk"][0][0]
    return dict(
        fill_unchunked=time_ms(torch, lambda: abea_cuda.abea_fill(*fill), 1),
        walk_unchunked=time_ms(torch, lambda: abea_cuda.abea_walk(*walk), 1))


def hold_ultra_windows(torch, calls, win: int):
    """The window kernels of the windowed ultra run held to their plain
    versions on the same card tensors, bit for bit, at two windows of that
    run: the last one (it resumes from the forward fill's checkpoint near
    band 786k; only the longest read is left) and the last one in which
    every read runs all ``win`` bands.  The plain re-fill's end state must
    also equal the forward fill's checkpoint there, which holds the
    forward launch (no trace, the whole reads) to the plain version at
    those windows, and the walk's recorded input must be the plain
    re-fill's trace.  Returns ({name: max_abs_err}, {name: (ms, plain_ms)}
    at the full window, fields to print)."""
    import numpy as np

    from f5c_tpu_torch.ops import abea_ultra, abea_ultra_cuda

    fwd = calls["abea_fill_window"][0][0]
    if fwd[15] or fwd[12] != 2:
        raise AssertionError("the first window launch is not the forward")
    n_win = fwd[14]
    refill = {a[12]: a for a, _ in calls["abea_fill_window"][1:]}
    walks = {a[2]: a for a, _ in calls["abea_walk_window"]}
    nb = np.diff(fwd[10].cpu().numpy())
    full = (int(nb.min()) - 2) // win - 1
    if full < 0 or len(refill) != n_win or len(walks) != n_win:
        raise AssertionError("the ultra run's window launches are not "
                             "those of the main path")
    fwd_ms = time_ms(torch, lambda: abea_ultra_cuda.abea_fill_window(*fwd),
                     1)
    ckpt = abea_ultra_cuda.abea_fill_window(*fwd)[0]
    err = {"abea_fill_window": 0, "abea_walk_window": 0}
    timings, info = {}, dict(fill_window_forward=fwd_ms, n_windows=n_win)
    for tag, w in (("last", n_win - 1), ("full", full)):
        base = 2 + w * win
        fa, wa = refill[base], walks[base]
        want_f, plain_f = run_once(
            torch, lambda: abea_ultra.fill_window_plain(*fa))
        want_w, plain_w = run_once(
            torch, lambda: abea_ultra.walk_window_plain(*wa))
        err["abea_fill_window"] = max(
            err["abea_fill_window"],
            _int_err(abea_ultra_cuda.abea_fill_window(*fa), want_f),
            _int_err((ckpt[:, w:w + 1].contiguous(),), want_f[:1]),
            _int_err(wa[:2], want_f[1:]))
        err["abea_walk_window"] = max(
            err["abea_walk_window"],
            _int_err(abea_ultra_cuda.abea_walk_window(*wa), want_w))
        ms_f = time_ms(torch, lambda: abea_ultra_cuda.abea_fill_window(*fa),
                       3)
        ms_w = time_ms(torch, lambda: abea_ultra_cuda.abea_walk_window(*wa),
                       3)
        info[f"window_{tag}"] = dict(
            index=w, base=base, bands=int(np.clip(nb - base, 0, win).max()),
            reads=int((nb > base).sum()), fill_ms=round(ms_f, 3),
            fill_plain_ms=round(plain_f, 1), walk_ms=round(ms_w, 3),
            walk_plain_ms=round(plain_w, 1))
        if tag == "full":
            timings = {"abea_fill_window": (ms_f, plain_f),
                       "abea_walk_window": (ms_w, plain_w)}
    for name, e in err.items():
        if e != 0:
            raise AssertionError(f"{name}: kernel differs from plain at the "
                                 f"ultra run's windows (max abs err {e})")
    return err, timings, info


def ultra_phase(tmp, torch, card, runner, datasets, kernel_mods,
                reset_counts, read_counts):
    """Phase 6.  Returns the launch counts of the windowed
    call-methylation run, the main path of the window kernels, and the
    window kernels' errors and (ms, plain_ms) at that run's shapes."""
    import filecmp

    from f5c_tpu_torch.ops import abea_ultra

    data = datasets.ultra_dataset(os.path.join(tmp, "ultra"), seed=2026)
    win = runner.Pipeline.WIN_BANDS
    budget = runner.Pipeline.TRACE_BYTES_BUDGET
    runs, kernel_ms = {}, {}
    for mode in ("windowed", "unchunked"):
        if mode == "unchunked":
            runner.Pipeline.TRACE_BYTES_BUDGET = 1 << 50  # nothing windowed
        try:
            # warm-up with the kernel calls recorded: each ABEA kernel
            # held to its plain version and timed at these shapes, then
            # the calls dropped so that they hold no device memory during
            # the measured runs
            spy = Spy(kernel_mods)
            try:
                run_cli(data, os.path.join(tmp, f"ultra_{mode}_warm.tsv"))
            finally:
                spy.close()
            if mode == "windowed":
                err, timings, info = hold_ultra_windows(torch, spy.calls,
                                                        win)
                kernel_ms.update(info)
            else:
                kernel_ms.update(time_unchunked_kernels(torch, spy.calls))
            del spy
            for cmd in ("meth", "eventalign"):
                out = os.path.join(tmp, f"ultra_{mode}_{cmd}.tsv")
                summary = out + ".summary" if cmd == "eventalign" else None
                rec = WalkRecorder(runner)
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                try:
                    wall, processed, stages = run_cli(data, out, summary)
                finally:
                    rec.close()
                counts = read_counts()
                peak = torch.cuda.max_memory_allocated() - base
                runs[mode, cmd] = dict(out=out, summary=summary,
                                       walks=rec.got, counts=counts)
                say("ultra", mode=mode, entry=cmd, reads=processed,
                    wall_s=f"{wall:.3f}", peak_mb=f"{peak / 2**20:.1f}",
                    held_mb=f"{base / 2**20:.1f}",
                    stages=stages.replace(" ", ","), launches=counts,
                    card=card.replace(" ", "_"))
                windowed = mode == "windowed"
                if (processed != 4 or len(rec.got) != 4
                        or (counts["abea_fill_window"] > 0) != windowed
                        or (counts["abea_walk_window"] > 0) != windowed
                        or (counts["abea_fill"] > 0) == windowed
                        or (cmd == "meth" and counts["hmm_forward"] == 0)):
                    raise AssertionError(f"ultra {mode} {cmd} run failed")
        finally:
            runner.Pipeline.TRACE_BYTES_BUDGET = budget
    walks = runs["windowed", "meth"]["walks"]
    say("ultra_windows", win=win, per_read={
        q: abea_ultra.n_windows(w[3], win) for q, w in sorted(walks.items())},
        bands={q: w[3] for q, w in sorted(walks.items())},
        walk_steps={q: w[0] for q, w in sorted(walks.items())})
    say("ultra_kernels", card=card.replace(" ", "_"),
        **{k: (f"{v:.3f}" if isinstance(v, float) else v)
           for k, v in kernel_ms.items()})
    with open(runs["windowed", "meth"]["out"]) as f:
        names = {ln.split("\t")[3] for ln in f.read().split("\n")[1:] if ln}
    if names != set(walks):
        raise AssertionError(f"meth rows for {sorted(names)} only")
    for cmd, files in (("meth", [("out", FLOAT_COLS, None)]),
                       ("eventalign", [("out", EA_FLOAT_COLS, None),
                                       ("summary", SUMMARY_FLOAT_COLS, 2)])):
        a, b = runs["windowed", cmd], runs["unchunked", cmd]
        if a["walks"] != b["walks"]:
            raise AssertionError(f"ultra {cmd}: walks differ between the "
                                 "windowed and the unchunked ABEA")
        for key, cols, norm in files:
            same = filecmp.cmp(a[key], b[key], shallow=False)
            bad = 0 if same else tolerant_bad(read_text(a[key]),
                                              read_text(b[key]), cols, norm)
            say("ultra_compare", entry=cmd, file=key, walks_identical=True,
                byte_identical=same, deviant_rows=bad)
            if bad:
                raise AssertionError(f"ultra {cmd} {key}: {bad} rows deviate")
    return runs["windowed", "meth"]["counts"], err, timings


def run_once(torch, fn):
    """(fn(), its ms between CUDA events): one run of a plain version at a
    shape where it is too slow to repeat."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_busy(torch, prof, top: int = 6):
    """(busy ms: the union of the card's spans, {kernel: [ms, launches]}
    for the ``top`` kernels by time and the rest as "other") of a
    torch.profiler run."""
    spans, per = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        name = ev.name.replace("(anonymous namespace)::", "")
        name = re.split(r"[(<]", name.removeprefix("void "), maxsplit=1)[0]
        d = per.setdefault(name.strip() or ev.name, [0.0, 0])
        d[0] += (t1 - t0) / 1e3
        d[1] += 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    out = {k: [round(ms, 3), n] for k, (ms, n) in ranked[:top]}
    if ranked[top:]:
        out["other"] = [round(sum(v[0] for _, v in ranked[top:]), 3),
                        sum(v[1] for _, v in ranked[top:])]
    return busy / 1e3, out


def profile_ultra(torch, card, runner, datasets, reps: int = 3) -> None:
    """``--profile``: ultra x4 through both entry points, windowed and
    unchunked: the walls of ``reps`` warm runs, then one run under
    torch.profiler with the card's busy time, its share of that run's
    wall, and device ms and launches per kernel."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory(prefix="chip_profile_") as tmp:
        data = datasets.ultra_dataset(os.path.join(tmp, "ultra"), seed=2026)
        budget = runner.Pipeline.TRACE_BYTES_BUDGET
        for mode in ("windowed", "unchunked"):
            if mode == "unchunked":
                runner.Pipeline.TRACE_BYTES_BUDGET = 1 << 50
            try:
                for cmd in ("meth", "eventalign"):
                    out = os.path.join(tmp, f"{mode}_{cmd}.tsv")
                    summary = out + ".summary" if cmd == "eventalign" else None
                    run_cli(data, out, summary)
                    walls = [run_cli(data, out, summary)[0]
                             for _ in range(reps)]
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        wall = run_cli(data, out, summary)[0]
                    busy, per = device_busy(torch, prof)
                    say("profile", mode=mode, entry=cmd,
                        warm_walls_s=",".join(f"{w:.3f}" for w in walls),
                        profiled_wall_s=f"{wall:.3f}",
                        busy_ms=f"{busy:.1f}",
                        busy_share=f"{100 * busy / (1e3 * wall):.1f}%",
                        kernels=json.dumps(per, separators=(",", ":")),
                        card=card.replace(" ", "_"))
            finally:
                runner.Pipeline.TRACE_BYTES_BUDGET = budget


def main(argv: list[str]) -> int:
    import torch

    if argv not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(GOLDEN, "meth.exp")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f5c_tpu_torch import backend, datasets
    from f5c_tpu_torch.ops import (_build, abea, abea_cuda, abea_ultra_cuda,
                                   hmm, hmm_cuda)
    from f5c_tpu_torch.pipeline import runner

    # 1. probe
    card = card_line()
    print(card, flush=True)
    say("probe", **backend.probe())
    dev = backend.resolve_device("cuda")

    # 2. build
    t0 = time.time()
    _build.library()
    regs = [ln.split("info    : ")[1] for ln in
            _build.build_info.get("log", "").splitlines() if "Used" in ln]
    say("build", seconds=f"{time.time() - t0:.2f}",
        cached=_build.build_info["cached"], ptxas="; ".join(regs))
    if argv == ["--profile"]:
        profile_ultra(torch, card, runner, datasets)
        print(card, flush=True)
        return 0

    counters = (abea_cuda.launches, hmm_cuda.launches,
                abea_ultra_cuda.launches)
    kernel_mods = [abea_cuda, hmm_cuda, abea_ultra_cuda]

    def reset_counts():
        for d in counters:
            for k in d:
                d[k] = 0

    def read_counts():
        return {k: v for d in counters for k, v in d.items()}

    def forced_windows():
        """Every golden read through the windowed ABEA, in windows of a
        few hundred bands."""
        runner.Pipeline.TRACE_BYTES_BUDGET = FORCE_BUDGET
        runner.Pipeline.WIN_BANDS = FORCE_WIN

    budget, win_bands = (runner.Pipeline.TRACE_BYTES_BUDGET,
                         runner.Pipeline.WIN_BANDS)

    def default_windows():
        runner.Pipeline.TRACE_BYTES_BUDGET = budget
        runner.Pipeline.WIN_BANDS = win_bands

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the golden set, its signals read from the zlib copy of
        # signals.blow5 (no zstandard module needed)
        source = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        golden = datasets.copy_dataset(source, os.path.join(tmp, "golden"))
        truth = os.path.join(GOLDEN, "meth.exp")

        # 3. kernel vs plain: the golden reads' own launches + synthetic
        spy = Spy(kernel_mods)
        try:
            run_cli(golden, os.path.join(tmp, "warmup.tsv"))
        finally:
            spy.close()
        err_golden = compare_launches(spy.calls, torch)
        err_synth = compare_launches(synthetic_calls(torch, dev), torch)
        torch.cuda.synchronize()
        say("kernel_vs_plain", golden=err_golden, synthetic=err_synth)

        # 3b. the windowed ABEA: golden reads forced windowed + synthetic
        forced_windows()
        reset_counts()
        spy = Spy(kernel_mods)
        try:
            wall, processed, _ = run_cli(golden,
                                         os.path.join(tmp, "windowed.tsv"))
        finally:
            spy.close()
            default_windows()
        counts_win = read_counts()
        bad_win = deviant_rows(os.path.join(tmp, "windowed.tsv"), truth)
        err_golden_win = compare_launches(spy.calls, torch)
        synth_calls, synth_shape = synthetic_window_calls(torch, dev)
        err_synth_win = compare_launches(synth_calls, torch)
        torch.cuda.synchronize()
        say("window_vs_plain", golden=err_golden_win,
            synthetic=err_synth_win, synthetic_shape=synth_shape)
        say("golden_windowed", processed=processed, deviant_rows=bad_win,
            launches=counts_win, win=FORCE_WIN, wall_s=f"{wall:.3f}")
        if (processed != 6 or bad_win != 0 or counts_win["abea_fill"] != 0
                or counts_win["abea_fill_window"] == 0
                or counts_win["abea_walk_window"] == 0
                or counts_win["hmm_forward"] == 0):
            raise AssertionError("windowed golden gate failed")

        # 4. golden gates through the kernels
        reset_counts()
        wall, processed, stages = run_cli(golden,
                                          os.path.join(tmp, "golden.tsv"))
        counts = read_counts()
        bad = deviant_rows(os.path.join(tmp, "golden.tsv"), truth)
        say("golden", processed=processed, deviant_rows=bad,
            launches=counts, wall_s=f"{wall:.3f}")
        if (processed != 6 or bad != 0
                or min(counts[k] for k in ("abea_fill", "abea_walk",
                                           "hmm_forward")) == 0):
            raise AssertionError("golden gate failed")
        ea_out = os.path.join(tmp, "golden_ea.tsv")
        ea_sum = os.path.join(tmp, "golden_ea.summary.tsv")
        reset_counts()
        wall, processed, _ = run_cli(golden, ea_out, summary=ea_sum)
        counts = read_counts()
        bad_ea = tolerant_bad(read_text(ea_out), read_text(
            os.path.join(GOLDEN, "eventalign.exp.gz")), EA_FLOAT_COLS)
        bad_sum = tolerant_bad(read_text(ea_sum), read_text(
            os.path.join(GOLDEN, "eventalign.summary.exp")),
            SUMMARY_FLOAT_COLS, norm_col=2)
        say("golden_eventalign", processed=processed, deviant_rows=bad_ea,
            summary_deviant_rows=bad_sum, launches=counts,
            wall_s=f"{wall:.3f}", card=card.replace(" ", "_"))
        if (processed != 6 or bad_ea != 0 or bad_sum != 0
                or counts["abea_fill"] == 0 or counts["abea_walk"] == 0):
            raise AssertionError("eventalign golden gate failed")

        # 5. scale run: 510 reads, twice warm, the second one recorded
        scale = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                           COPIES)
        n_reads = 6 * COPIES
        walls = []
        for rep in range(2):
            out = os.path.join(tmp, f"scale{rep}.tsv")
            reset_counts()
            spy = Spy(kernel_mods) if rep == 1 else None
            try:
                wall, processed, stages = run_cli(scale, out)
            finally:
                if spy is not None:
                    spy.close()
            counts = {k: v for k, v in read_counts().items()
                      if k in ("abea_fill", "abea_walk", "hmm_forward")}
            bad = deviant_rows(out, truth, copies=COPIES)
            walls.append(wall)
            say("scale", run=rep + 1, reads=processed, deviant_rows=bad,
                wall_s=f"{wall:.3f}", reads_per_s=f"{n_reads / wall:.2f}",
                stages=stages.replace(" ", ","), launches=counts,
                waves=f"{runner.Pipeline.WAVE}x{runner.Pipeline.INFLIGHT}",
                card=card.replace(" ", "_"))
            if processed != n_reads or bad != 0 or min(counts.values()) == 0:
                raise AssertionError("scale run failed")
        err_scale = compare_launches(spy.calls, torch)

        # kernel and plain times at the scale run's first (largest)
        # launch; the window kernels are timed in phase 6
        fill_a, fill_kw = spy.calls["abea_fill"][0]
        walk_a, walk_kw = spy.calls["abea_walk"][0]
        hmm_a, hmm_kw = spy.calls["hmm_forward"][0]
        timed = {
            "abea_fill": (lambda: abea_cuda.abea_fill(*fill_a, **fill_kw),
                          lambda: abea.abea_fill_plain(*fill_a[:11])),
            "abea_walk": (lambda: abea_cuda.abea_walk(*walk_a, **walk_kw),
                          lambda: abea.abea_walk_plain(*walk_a[:6])),
            "hmm_forward": (lambda: hmm_cuda.hmm_forward(*hmm_a, **hmm_kw),
                            lambda: hmm.hmm_forward_plain(*hmm_a, **hmm_kw)),
        }
        shapes = dict(reads=int(fill_a[2].shape[0]), bands=fill_a[11],
                      windows=int(hmm_a[0].shape[0]),
                      window_width=int(hmm_a[0].shape[1]))
        timings = {name: (time_ms(torch, kern, 20), time_ms(torch, plain, 2))
                   for name, (kern, plain) in timed.items()}
        say("timing", shapes=shapes, card=card.replace(" ", "_"),
            best_reads_per_s=f"{n_reads / min(walls):.2f}")

        # 6. ultra-long reads through both entry points, windowed (the
        # defaults) and unchunked (budget raised); the main path of the
        # window kernels is the windowed call-methylation run.  The
        # recorded calls are dropped first: they hold device memory.
        del spy, synth_calls, timed, fill_a, walk_a, hmm_a
        ultra_counts, err_ultra, ultra_timings = ultra_phase(
            tmp, torch, card, runner, datasets, kernel_mods, reset_counts,
            read_counts)
        timings.update(ultra_timings)

        errs = {name: max(e.get(name, 0) for e in (
            err_golden, err_synth, err_scale, err_golden_win,
            err_synth_win, err_ultra)) for name in KERNELS}
        kernels = []
        for name, (ms, plain_ms) in timings.items():
            launches = (ultra_counts if name.endswith("_window")
                        else counts)[name]
            kernels.append(dict(
                name=name, route="cuda", source=KERNELS[name][0],
                replaces=KERNELS[name][1], launches=launches,
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms))

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
