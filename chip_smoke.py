#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f5c_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # golden x85 and phase 6's runs profiled

Phases (each prints one line; any failure raises and exits nonzero):

1. probe: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: the kernels of f5c_tpu_torch/csrc with nvcc for sm_90a;
3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card -- the ABEA kernels (unchunked and windowed) bit-identical,
   the fused HMM forward (window metadata in, scores out) within
   f5c_tpu_torch/ops/hmm.py's tolerance and its in-kernel k-mer ranks
   (the rank probe) bit-identical to ops/hmm_meta.build_inputs -- on the
   golden reads' own launches (also with every read forced through the
   windowed ABEA) and on synthetic batches (mixed read lengths, HMM
   windows of 1-300 and of 600, 2,500 and 5,000 k-mers, the rank cases of
   tests/test_torch_ranks.py, one read of ~5,000 bands in windows of
   1,000, and one long read -- a chain of ~420 tiles of the fill and the
   walk -- among 40 short ones, held to the plain versions at two of its
   windows);
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
   with CUDA events at those shapes (the HMM with its launch's window
   classes, warp-steps, and the time of the unfused input assembly
   build_inputs that the kernel replaces);
6. ultra run: 4 synthetic reads of 100-300 kb (datasets.ultra_dataset)
   through call-methylation and eventalign at the default settings, where
   every read takes the windowed ABEA, and again with the trace budget
   raised so that none does: per read the same walk bit for bit, the same
   output files; walls, peak device memory, windows per read; the window
   kernels held bit for bit to their plain versions, and timed, at two
   windows of the windowed run (the last one, from band ~786k, and a full
   one of 65,536 bands x 4 reads), and the HMM launches of that run held
   to theirs; the unchunked kernels timed.

It prints a JSON line of the kernels (launches on the main path, max
abs error against the plain version, ms, plain ms, and the roofline bound
of the timed launch: bytes each input read once and each output written
once over 3.35 TB/s, or f32 operations over 67 TFLOP/s, whichever is
larger), the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or outside a checkout of the
repository, it fails before printing results; it fails too if the JAX
package or jax was imported.

``--profile`` runs only phases 1-2, then golden x85 (call-methylation)
and phase 6's four configurations, each warm three times and once under
torch.profiler: walls, the card's busy time and share of the wall,
device ms and launches per kernel.
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
MIX_LONG, MIX_WIN = 20_000, 4096   # the long read's k-mers; windows
# the roofline of one H100 SXM (NVIDIA's datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ABEA_CELL_OPS = 13   # f32 ops of a band cell: emission 5, scores 6, max 2
HMM_CELL_OPS = 55    # f32 ops (exp/log as one) of an HMM (k-mer, event) cell
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
# the wrapper of a kernel where its name differs (the fused HMM kernel
# counts its launches as hmm_forward)
WRAPPERS = {"hmm_forward": "hmm_forward_meta"}
HMM_META = ("meta", "packed_ref", "read_tab", "ev_pool", "level_mean",
            "level_stdv", "level_log_stdv")


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
                attr = WRAPPERS.get(name, name)
                if hasattr(mod, attr):
                    fn = getattr(mod, attr)
                    self._orig.append((mod, attr, fn))
                    setattr(mod, attr, self._wrap(name, fn))

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
    ABEA must be, the HMM must be within tolerance, and its rank probe,
    "hmm_ranks", bit-identical)."""
    from f5c_tpu_torch.ops import (abea, abea_cuda, abea_ultra,
                                   abea_ultra_cuda, hmm_cuda)

    err = {}
    for args, kw in spy_calls.get("abea_fill", ()):
        got = abea_cuda.abea_fill(*args, **kw)
        want = abea.abea_fill_plain(*args[:11])
        err["abea_fill"] = max(err.get("abea_fill", 0), _int_err(got, want))
    for args, kw in spy_calls.get("abea_walk", ()):
        got = abea_cuda.abea_walk(*args, **kw)
        want = abea.abea_walk_plain(*args[:6])
        err["abea_walk"] = max(err.get("abea_walk", 0), _int_err(got, want))
    for args, kw in spy_calls.get("hmm_forward", ()):
        e, e_ranks = hold_hmm(torch, args, kw)
        err["hmm_forward"] = max(err.get("hmm_forward", 0.0), e)
        err["hmm_ranks"] = max(err.get("hmm_ranks", 0), e_ranks)
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
                 "abea_walk_window", "hmm_ranks"):
        if err.get(name, 0) != 0:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err[name]})")
    return err


def hold_hmm(torch, args, kw):
    """One fused HMM launch (meta, packed_ref, read_tab, ev_pool, the
    model tables, k) against its plain version, within hmm.py's
    tolerance, and its in-kernel ranks (the probe) against build_inputs,
    bit for bit.  Returns (max abs error of the scores, of the ranks)."""
    from f5c_tpu_torch.ops import hmm, hmm_cuda, hmm_meta

    got = hmm_cuda.hmm_forward_meta(*args, **kw)
    want = hmm_meta.hmm_forward_meta_plain(
        *args[:8], allow_pre=kw.get("allow_pre", True),
        allow_post=kw.get("allow_post", True))
    torch.testing.assert_close(got, want, rtol=hmm.RTOL, atol=hmm.ATOL)
    fin = torch.isfinite(want)
    e = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    meta, packed, read_tab, k = args[0], args[1], args[2], args[7]
    kw_r = max(int(hmm_meta.window_fields(meta, k)["n_km"].max()), 1)
    ranks = hmm_cuda.hmm_window_ranks(meta, packed, read_tab, k, kw_r)
    want_r = hmm_meta.build_inputs(meta, packed, read_tab, k=k, kw=kw_r)[0]
    return e, _int_err((ranks,), (want_r,))


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
    events do not follow it), and HMM windows of 1-300 k-mers (in launch
    order, and with every window on a warp of its own) and of 600, 2,500
    and 5,000, each with the soft clips on and off."""
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
    hmm_calls = []
    for n_kmers in ([int(n) for n in rng.integers(1, 300, 200)]
                    + [129, 256, 300], [600, 20], [2500], [5000]):
        w = synthetic.hmm_meta_windows(rng, n_kmers, cpg)
        hmm_args = tuple(torch.as_tensor(w[k], device=dev)
                         for k in HMM_META) + (w["k"],)
        narrow = (w["n_narrow"], 0) if len(n_kmers) > 100 else (0,)
        hmm_calls += [(hmm_args, {"allow_pre": a, "allow_post": a,
                                  "n_narrow": n, "max_km": w["max_km"]})
                      for a in (True, False) for n in narrow]
    return {"abea_fill": [(fill_args + (x["n_bands"],), {})],
            "abea_walk": [(walk_args + (x["n_bytes"],), {})],
            "hmm_forward": hmm_calls}


def rank_probe_cases(torch, dev) -> int:
    """The rank probe held to build_inputs, bit for bit, on the cases of
    synthetic.rank_cases; returns the windows checked."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import hmm_cuda, hmm_meta

    k = builtin_model("dna_r9_cpg").k
    n = 0
    for c in synthetic.rank_cases(np.random.default_rng(2029), k):
        meta, packed, read_tab = (torch.as_tensor(c[key], device=dev) for key
                                  in ("meta", "packed_ref", "read_tab"))
        got = hmm_cuda.hmm_window_ranks(meta, packed, read_tab, k, c["kw"])
        want = hmm_meta.build_inputs(meta, packed, read_tab, k=k,
                                     kw=c["kw"])[0]
        if _int_err((got,), (want,)) != 0:
            raise AssertionError("rank probe differs from build_inputs")
        n += meta.shape[0]
    return n


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


def hold_windows(torch, calls, win: int, picks: dict):
    """The window kernels of a windowed run held to their plain versions
    on the same card tensors, bit for bit, at the windows ``picks``
    ({tag: window index}).  The plain re-fill's end state must also equal
    the forward fill's checkpoint there, which holds the forward launch
    (no trace, the whole reads) to the plain version at those windows,
    and the walk's recorded input must be the plain re-fill's trace.
    Returns ({name: max_abs_err}, {tag: {name: (ms, plain_ms, bound_ms,
    bound_by)}}, fields to print, {tag: (base, plain re-fill)})."""
    import numpy as np

    from f5c_tpu_torch.ops import abea_ultra, abea_ultra_cuda

    fwd = calls["abea_fill_window"][0][0]
    if fwd[15] or fwd[12] != 2:
        raise AssertionError("the first window launch is not the forward")
    n_win = fwd[14]
    refill = {a[12]: a for a, _ in calls["abea_fill_window"][1:]}
    walks = {a[2]: a for a, _ in calls["abea_walk_window"]}
    nb = np.diff(fwd[10].cpu().numpy())
    if (min(picks.values()) < 0 or len(refill) != n_win
            or len(walks) != n_win):
        raise AssertionError("the window launches are not those of the "
                             "main path")
    fwd_ms = time_ms(torch, lambda: abea_ultra_cuda.abea_fill_window(*fwd),
                     1)
    ckpt = abea_ultra_cuda.abea_fill_window(*fwd)[0]
    err = {"abea_fill_window": 0, "abea_walk_window": 0}
    timings, plain_fills = {}, {}
    info = dict(fill_window_forward=fwd_ms, n_windows=n_win)
    for tag, w in picks.items():
        base = 2 + w * win
        fa, wa = refill[base], walks[base]
        want_f, plain_f = run_once(
            torch, lambda: abea_ultra.fill_window_plain(*fa))
        want_w, plain_w = run_once(
            torch, lambda: abea_ultra.walk_window_plain(*wa))
        got_f = abea_ultra_cuda.abea_fill_window(*fa)
        got_w = abea_ultra_cuda.abea_walk_window(*wa)
        err["abea_fill_window"] = max(
            err["abea_fill_window"], _int_err(got_f, want_f),
            _int_err((ckpt[:, w:w + 1].contiguous(),), want_f[:1]),
            _int_err(wa[:2], want_f[1:]))
        err["abea_walk_window"] = max(err["abea_walk_window"],
                                      _int_err(got_w, want_w))
        ms_f = time_ms(torch, lambda: abea_ultra_cuda.abea_fill_window(*fa),
                       3)
        ms_w = time_ms(torch, lambda: abea_ultra_cuda.abea_walk_window(*wa),
                       3)
        timings[tag] = {
            "abea_fill_window": (ms_f, plain_f, *bound_of(
                "abea_fill_window", fa, {}, got_f)),
            "abea_walk_window": (ms_w, plain_w, *bound_of(
                "abea_walk_window", wa, {}, got_w))}
        info[f"window_{tag}"] = dict(
            index=w, base=base, bands=int(np.clip(nb - base, 0, win).max()),
            reads=int((nb > base).sum()), fill_ms=round(ms_f, 3),
            fill_plain_ms=round(plain_f, 1), walk_ms=round(ms_w, 3),
            walk_plain_ms=round(plain_w, 1),
            walk_steps=int((got_w[0][:, 2] - wa[3][:, 2]).sum()))
        plain_fills[tag] = (base, want_f)
    for name, e in err.items():
        if e != 0:
            raise AssertionError(f"{name}: kernel differs from plain at the "
                                 f"run's windows (max abs err {e})")
    return err, timings, info, plain_fills


def mixed_long_short(torch, dev):
    """One long read (20,000 k-mers: a chain of ~54,000 bands, ~420 tiles
    of the fill and the walk) among 40 short ones, through the unchunked
    kernels (fill, walk) and the windowed ones (windows of MIX_WIN).  The
    two paths must agree bit for bit; the window kernels are held to
    their plain versions at the middle and the last window of the long
    read, and the unchunked fill's trace rows there to the plain
    re-fill's.  Returns ({name: max_abs_err}, fields to print)."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import abea, abea_cuda, abea_ultra_cuda

    rng = np.random.default_rng(2028)
    nuc = builtin_model("dna_r9_nucleotide")
    n_kmers = [MIX_LONG] + [int(n) for n in rng.integers(50, 2500, 40)]
    seqs, events = synthetic.abea_reads(rng, n_kmers, nuc, unrelated=(7,))
    x = synthetic.abea_inputs(seqs, events, nuc)
    t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
         else v for k, v in x.items()}
    args = tuple(t[k] for k in (
        "ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off", "rk_len",
        "level_mean", "level_stdv", "level_log_stdv", "params",
        "band_off"))
    nb = np.diff(x["band_off"])
    chain = int(nb.max())
    if chain // abea.FILL_TILE < 50 or chain // abea.WALK_TILE < 50:
        raise AssertionError("the long read spans < 50 tiles")
    fill = abea_cuda.abea_fill(*args, x["n_bands"])
    walk_args = (fill[0], fill[1], t["band_off"], fill[2], t["rk_len"],
                 t["byte_off"], x["n_bytes"])
    walk = abea_cuda.abea_walk(*walk_args)
    fill_ms = time_ms(torch, lambda: abea_cuda.abea_fill(
        *args, x["n_bands"]), 5)
    walk_ms = time_ms(torch, lambda: abea_cuda.abea_walk(*walk_args), 5)
    spy = Spy([abea_ultra_cuda])
    try:
        got = abea_ultra_cuda.abea_align_windowed(
            *args, t["byte_off"], x["n_bytes"], chain, MIX_WIN)
    finally:
        spy.close()
    if _int_err(got, (walk[0], fill[2], walk[1])) != 0:
        raise AssertionError("mixed batch: the windowed ABEA differs from "
                             "the unchunked kernels")
    nw = len(spy.calls["abea_walk_window"])
    err, _, info, plain_fills = hold_windows(
        torch, spy.calls, MIX_WIN, {"mid": nw // 2, "last": nw - 1})
    e_fill = 0
    for base, (_, p_tr, p_llk) in plain_fills.values():
        for i in np.nonzero(nb > base)[0]:
            rows = int(min(nb[i] - base, MIX_WIN))
            b = int(x["band_off"][i]) + base
            e_fill = max(e_fill, _int_err(
                (fill[0][b:b + rows], fill[1][b:b + rows]),
                (p_tr[i, :rows], p_llk[i, :rows])))
    if e_fill:
        raise AssertionError("mixed batch: the fill differs from plain at "
                             f"the long read's windows ({e_fill})")
    err.update(abea_fill=e_fill, abea_walk=0)
    f_bound = bound_of("abea_fill", args + (x["n_bands"],), {}, fill)
    w_bound = bound_of("abea_walk", walk_args, {}, walk)
    info.update(reads=len(seqs), chain_bands=chain,
                walk_steps=int(walk[1].max()), fill_ms=round(fill_ms, 3),
                fill_bound_ms=round(f_bound[0], 4),
                fill_ns_per_band=round(1e6 * fill_ms / chain, 1),
                walk_ms=round(walk_ms, 3),
                walk_bound_ms=round(w_bound[0], 4),
                walk_ns_per_step=round(1e6 * walk_ms / int(walk[1].max()),
                                       1))
    return err, info


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
                nb = (spy.calls["abea_fill_window"][0][0][10].diff()
                      .min().item())
                err, timings, info, _ = hold_windows(
                    torch, spy.calls, win,
                    {"last": len(spy.calls["abea_walk_window"]) - 1,
                     "full": (nb - 2) // win - 1})
                timings = timings["full"]
                kernel_ms.update(info)
                err.update(compare_launches(
                    {"hmm_forward": spy.calls["hmm_forward"]}, torch))
                kernel_ms.update(hmm_launches=len(spy.calls["hmm_forward"]),
                                 hmm_max_abs_err=err["hmm_forward"])
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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))


def roofline(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the least time of the card for
    this work."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bound_of(name: str, args, kw, out):
    """The roofline bound of one kernel call from its inputs and outputs:
    every input read once and every output written once (for the walks,
    the trace bytes and llk words of the steps taken), and the f32
    operations of the cells computed."""
    if name == "abea_fill":
        cells = args[11] * 100
        return roofline(_nbytes(*args[:11], *out), cells * ABEA_CELL_OPS)
    if name == "abea_walk":
        steps = int(out[1].long().sum())
        return roofline(5 * steps + _nbytes(*args[2:6], *out), 0)
    if name == "hmm_forward":
        return roofline(_nbytes(*args[:7], out),
                        hmm_shape(args, kw)["cells"] * HMM_CELL_OPS)
    if name == "abea_fill_window":
        base, win, n_win = args[12], args[13], args[14]
        nb = (args[10][1:] - args[10][:-1]).long()
        bands = int((nb - base).clamp(0, n_win * win).sum())
        # each band takes one new k-mer rank or event (4 bytes) beyond
        # the first tile's reach of BW k-mers and events per read
        inputs = 4 * bands + 8 * 100 * int((nb > base).sum())
        return roofline(inputs + _nbytes(args[11], *out),
                        bands * 100 * ABEA_CELL_OPS)
    if name == "abea_walk_window":
        steps = int((out[0][:, 2] - args[3][:, 2]).long().sum())
        return roofline(5 * steps + -(-steps // 4) + 2 * _nbytes(args[3]),
                        0)
    raise KeyError(name)


def hmm_shape(args, kw) -> dict:
    """The work of one fused HMM launch, from its window metadata: its
    windows, width classes, warps and warp-steps (hmm_cuda.launch_shape)
    and its (k-mer, event) cells."""
    from f5c_tpu_torch.ops import hmm_cuda, hmm_meta

    f = hmm_meta.window_fields(args[0], args[7])
    return hmm_cuda.launch_shape(f["n_km"].cpu().numpy(),
                                 f["n_ev"].cpu().numpy(),
                                 kw.get("n_narrow", 0))


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


def profile_runs(torch, card, runner, datasets, reps: int = 3) -> None:
    """``--profile``: golden x85 through call-methylation, and ultra x4
    through both entry points, windowed and unchunked: the walls of
    ``reps`` warm runs, then one run under torch.profiler with the card's
    busy time, its share of that run's wall, and device ms and launches
    per kernel."""
    from torch.profiler import ProfilerActivity, profile

    def measure(data, out, summary, **fields):
        run_cli(data, out, summary)
        walls = [run_cli(data, out, summary)[0] for _ in range(reps)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run_cli(data, out, summary)[0]
        busy, per = device_busy(torch, prof)
        say("profile", **fields,
            warm_walls_s=",".join(f"{w:.3f}" for w in walls),
            profiled_wall_s=f"{wall:.3f}", busy_ms=f"{busy:.1f}",
            busy_share=f"{100 * busy / (1e3 * wall):.1f}%",
            kernels=json.dumps(per, separators=(",", ":")),
            card=card.replace(" ", "_"))

    with tempfile.TemporaryDirectory(prefix="chip_profile_") as tmp:
        source = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        scale = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                           COPIES)
        measure(scale, os.path.join(tmp, "x85.tsv"), None, mode="golden_x85",
                entry="meth")
        data = datasets.ultra_dataset(os.path.join(tmp, "ultra"), seed=2026)
        budget = runner.Pipeline.TRACE_BYTES_BUDGET
        for mode in ("windowed", "unchunked"):
            if mode == "unchunked":
                runner.Pipeline.TRACE_BYTES_BUDGET = 1 << 50
            try:
                for cmd in ("meth", "eventalign"):
                    out = os.path.join(tmp, f"{mode}_{cmd}.tsv")
                    summary = out + ".summary" if cmd == "eventalign" else None
                    measure(data, out, summary, mode=mode, entry=cmd)
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
                                   hmm_cuda, hmm_meta)
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
        profile_runs(torch, card, runner, datasets)
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
        probed = rank_probe_cases(torch, dev)
        torch.cuda.synchronize()
        say("kernel_vs_plain", golden=err_golden, synthetic=err_synth,
            rank_probe_windows=probed)

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
        err_mixed, mixed_info = mixed_long_short(torch, dev)
        torch.cuda.synchronize()
        say("long_and_short", errors=err_mixed, win=MIX_WIN,
            card=card.replace(" ", "_"),
            **{k: (f"{v:.3f}" if isinstance(v, float) else v)
               for k, v in mixed_info.items()})
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
            "hmm_forward": (
                lambda: hmm_cuda.hmm_forward_meta(*hmm_a, **hmm_kw),
                lambda: hmm_meta.hmm_forward_meta_plain(*hmm_a)),
        }
        # the serial chains of the ABEA launch: the longest read's bands
        # (fill) and the longest walk's steps
        chain = int((fill_a[10][1:] - fill_a[10][:-1]).max())
        steps = int(abea_cuda.abea_walk(*walk_a, **walk_kw)[1].max())
        hmm_work = hmm_shape(hmm_a, hmm_kw)
        shapes = dict(reads=int(fill_a[2].shape[0]), bands=fill_a[11],
                      chain_bands=chain, walk_steps=steps,
                      **{f"hmm_{k}": v for k, v in hmm_work.items()},
                      hmm_max_km=hmm_kw["max_km"])
        timings = {name: (time_ms(torch, kern, 20), time_ms(torch, plain, 2),
                          *bound_of(name, args, kw, kern()))
                   for name, (kern, plain), (args, kw) in zip(
                       timed, timed.values(),
                       ((fill_a, fill_kw), (walk_a, walk_kw),
                        (hmm_a, hmm_kw)))}
        # the unfused input assembly the HMM kernel replaces (K6: the
        # parent's torch ops before its forward kernel), at this launch
        k6_ms = time_ms(torch, lambda: hmm_meta.build_inputs(
            *hmm_a[:3], k=hmm_a[7], kw=max(hmm_kw["max_km"], 1)), 20)
        # an SM sub-partition's time per warp-step: the kernel's time over
        # the warp-steps each of the card's 4 x SMs sub-partitions takes
        smsp = 4 * torch.cuda.get_device_properties(0).multi_processor_count
        ns_ws = (1e6 * timings["hmm_forward"][0] * smsp
                 / hmm_work["warp_steps"])
        say("timing", shapes=shapes, card=card.replace(" ", "_"),
            best_reads_per_s=f"{n_reads / min(walls):.2f}",
            fill_ns_per_band=f"{1e6 * timings['abea_fill'][0] / chain:.1f}",
            walk_ns_per_step=f"{1e6 * timings['abea_walk'][0] / steps:.1f}",
            hmm_ns_per_warp_step=f"{ns_ws:.1f}",
            k6_build_inputs_ms=f"{k6_ms:.4f}")

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
            err_synth_win, err_mixed, err_ultra)) for name in KERNELS}
        kernels = []
        for name, (ms, plain_ms, bound_ms, bound_by) in timings.items():
            launches = (ultra_counts if name.endswith("_window")
                        else counts)[name]
            # no PyTorch call computes the ABEA fill, its walk or the HMM
            # forward pass: library_ms is null
            kernels.append(dict(
                name=name, route="cuda", source=KERNELS[name][0],
                replaces=KERNELS[name][1], launches=launches,
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None))

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "f5c_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
