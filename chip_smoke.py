#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f5c_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # golden x85 and phase 6's runs profiled

Phases (each prints one line; any failure raises and exits nonzero):

1. probe: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: the kernels of f5c_tpu_torch/csrc with nvcc for sm_90a;
3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card -- the ABEA kernels (unchunked and windowed, which take the
   sequences 2-bit packed and rank their k-mers themselves: K11 fused)
   bit-identical, and at every fill launch the fills' k-mer ranks (their
   probe) bit for bit ranks_from_packed's, also at k = 5, 6 and 9 on
   reads at every offset mod 4 of the packed buffer,
   the fused HMM forward (window metadata in, scores out) within
   f5c_tpu_torch/ops/hmm.py's tolerance and its in-kernel k-mer ranks
   (the rank probe) bit-identical to ops/hmm_meta.build_inputs -- on the
   golden reads' own launches (also with every read forced through the
   windowed ABEA) and on synthetic batches (mixed read lengths, HMM
   windows of 1-300 and of 600, 2,500 and 5,000 k-mers, the rank cases of
   tests/test_torch_ranks.py, one read of ~5,000 bands in windows of
   1,000, and one long read -- a chain of ~420 tiles of the fill and the
   walk -- among 40 short ones, held to the plain versions at two of its
   windows); every unchunked walk launch by each route (the tile-parallel
   walk of csrc/abea_walk_tiled.cu, the one-warp walk, the crossover's
   mix) and every window walk by both (tiled, one-warp) bit for bit the
   plain walks, and the long read's walk the plain tiled walk
   (ops/abea.py abea_walk_tiled_plain), the routes and the tiled walk's
   three phases timed; the event detector (K9) bit for bit its plain version and
   native.detect_events on the golden signals and on synthetic DNA (tiny
   values whose prefix sums round, the densest pattern) and RNA signals,
   and its chunk-parallel peak scan alone (the probe) on the golden
   signals' tracks and the adversarial synthetic.peak_tracks, at the
   kernel's own chunk length and at 32 and 1,000 samples, bit for bit the
   sequential scan, in as many rounds as its plain model takes;
   the chunk Viterbi (K8) bit for bit its plain version and, chunk by
   chunk, the host DP (native.viterbi_chunk_spec) on a synthetic round,
   on two rounds of its partition's edge chunks (1 to 400 k-mers, 1 to
   4,000 events: the register and the tiled kernel) and on a round whose
   events, gm or gs leave the range of the register kernel's fast
   division, with its movement tables in shared memory and all in global
   memory;
4. golden gates: ``f5c_tpu_torch.cli.main([...])`` on tests/data/golden,
   against the vendored truth under f5c's tolerance |x - t| <= 0.1|t| +
   0.02: call-methylation (6 reads, 0 deviant rows against meth.exp, every
   kernel of its path launched, the events detected on the card with
   --events-engine device; auto is host), the same bytes with the host
   event detector, the same with every read
   forced through the windowed ABEA, and eventalign --summary (0 deviant
   rows against eventalign.exp.gz and eventalign.summary.exp) with the
   native engine and with F5C_TPU_EA_ENGINE=device (the same bytes; every
   round's chunks held to the plain version and to the host DP, one round
   again with its tables in global memory); resquiggle (TSV and PAF) on
   the card against the port on the CPU, byte for byte;
5. scale run: the golden set replicated to 510 reads (one batch of f5c's
   default -K 512) through call-methylation, twice warm with each events
   engine (host, device, host, device); every copy's rows within
   tolerance of meth.exp; reads/s and stage times; eventalign on the same
   reads with the native and the device engine (walls, stage times, the
   probes that decide auto; every round of the last device run held to
   the plain version and the host DP); then each kernel against its
   plain version on the launches of the last run (the chunk Viterbi at
   that eventalign run's largest round), timed with CUDA events at those
   shapes (the event detector and the chunk Viterbi also without their
   wrappers' host work; the HMM with its launch's window classes,
   warp-steps, and the time of the unfused input assembly build_inputs
   that the kernel replaces);
6. ultra run: 4 synthetic reads of 100-300 kb (datasets.ultra_dataset)
   through call-methylation and eventalign with the trace budget lowered
   (a share of datasets.ULTRA_WINDOWED_SHARE bands a read), where every
   read takes the windowed ABEA, and again at the default settings, where
   the 2-bit trace keeps every read on the unchunked ABEA (no window
   kernel launches): per read the same walk bit for bit, the same output
   files; walls, peak device memory, windows per read, the trace's bytes
   a band, the default share and each read's bands; the window
   kernels held bit for bit to their plain versions, and timed, at two
   windows of the windowed run (the last one, from band ~786k, and a full
   one of 65,536 bands x 4 reads), and the HMM launches of that run held
   to theirs; the event detector held to native.detect_events and its
   plain version on the 4 reads and timed (its peak kernel also alone);
   windowed call-methylation once more with device events: its peak
   device memory (K9's scratch) and the bytes of the host-events run;
   the unchunked kernels timed, and the unchunked fill's trace rows at
   those two windows held byte for byte to the plain re-fills'; the
   unchunked walk (811,435 bands on the longest read) by both routes held
   to the plain tiled walk and timed, with the tiled walk's phases (at
   the full window too);
7. pores: the synthetic R10 set (4 reads, full-size 9-mer tables:
   f5c_tpu_torch.synthetic.r10_models / r10_dataset) through
   call-methylation and eventalign --summary with the native and the
   device re-alignment engine, and the synthetic RNA004 set through
   eventalign --m6anet (chemistry from the BLOW5 header), each on the
   card and with --device cpu: the same bytes (call-methylation's HMM
   columns within f5c's tolerance); every K1, K4, K2 and K8 launch of the
   card runs held to its plain version (K8 also to the host DP); then 512
   reads of the R10 set on the card, K1, K4 and K2 at their first launch
   (a full wave of 128 reads) and K8 at its largest round held to their
   plain versions (K8 also to the host DP) and timed with their bounds;
8. chain: index -> call-methylation on the card (the golden set, whole
   and as --shard 0/2 and 1/2) -> meth-freq (with and without -s) ->
   freq-merge of the shards: the whole run's calls within f5c's
   tolerance of meth.exp, the shards' rows those of the whole run, and
   freq-merge of the shards equal to meth-freq of the whole run;
9. profile_dir: call-methylation --profile-dir DIR on the card; the
   torch.profiler trace in DIR names the fill, walk and HMM kernels;
10. parallel: f5c_tpu_torch.parallel.mesh_check on the 510 reads of
    phase 5 over two slots of cuda:0 (align + HMM of call-methylation
    and device-engine eventalign bit for bit the single-device run; K1,
    K4, K2 and K8 launched in both slots; the transfer table), then two
    ``--dist`` processes on cuda:0 (a gloo group on the host) running
    call-methylation (each rank with its own --profile-dir, whose trace
    names the fill, walk and HMM kernels) and eventalign --summary on the
    golden set (eventalign launched under srun's environment, with no
    --dist-* option): the merged files byte for byte a single-process
    run's, the parts removed.  One card: this measures the layer's
    overhead, not scaling.

It prints a JSON line of the kernels (launches on the main path, max
abs error against the plain version, ms (for K4 and K10 the tiled walk,
the route of every read of the main path, by its launch span, with its
phases alone, the tiles it chases and the one-warp walk's ms beside, and
for K4 the whole wrapper call as wrapper_ms; for K8 and K9 the kernels
alone, with the whole wrapper call as wrapper_ms; for K9 also its peak
kernel alone, peaks_ms and its bound, and the rounds of its peak scan on
the main path, and as library_ms torch.cumsum's prefix sums of its
samples; K9's three stages, sums and tracks, peak scan and assembly, each
timed alone at golden x85's first launch and, as ultra_*, at the ultra
launch, with their own bounds and plain models, the sums' library_ms two
flat torch.cumsum calls; for K11, fused into K1 and K3, its probe against the torch ops
that ranked before, its launches K1's and K3's), plain ms, and the
roofline bound
of the timed launch: bytes each input read once and each output written
once over 3.35 TB/s, f32 operations over 67 TFLOP/s or f64 operations
over 34 TFLOP/s, whichever is largest), the card's name and power limit,
and last ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or outside a checkout of the
repository, it fails before printing results; it fails too if the JAX
package or jax was imported.

``--profile`` runs only phases 1-2, then golden x85 (call-methylation
with each events engine in 10 warm pairs, the order alternating, then
each once under torch.profiler; eventalign with the native and the
device engine) and phase 6's four configurations, each with both events
engines, the others each warm three times and once under torch.profiler:
walls, the card's busy time and share of the wall, device ms and
launches per kernel (K9's always by name, and with device events the
times its kernels' names occur in the exported trace).
"""

from __future__ import annotations

import filecmp
import json
import os
import re
import shutil
import socket
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
HMM_COLS_V2 = (5, 6, 7)     # meth-out-version 2: llr, ll_meth, ll_unmeth
FORCE_BUDGET, FORCE_WIN = 1_000_000, 300  # every golden read windowed
K9_WAVE_READS = 512         # [pores]: the R10 set timed at a full wave
K9_WAVE_MIN = 128           # reads in its first ABEA launch (a wave)
SYNTH_WIN = 1000
# K8 at golden x85's largest eventalign round (128 chunks) by this
# script's span, as the one-block-a-chunk kernel of f97def0 took it
# (PERF.md: NVIDIA H100 80GB HBM3, 700 W)
K8_ONE_BLOCK_MS = 0.1218
EVENTS_PAIRS = 10           # --profile: golden x85 host/device events pairs
DEVICE_EVENTS = ("--events-engine", "device")   # auto is host
MIX_LONG, MIX_WIN = 20_000, 4096   # the long read's k-mers; windows
# the roofline of one H100 SXM (NVIDIA's datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
ABEA_CELL_OPS = 13   # f32 ops of a band cell: emission 5, scores 6, max 2
HMM_CELL_OPS = 55    # f32 ops (exp/log as one) of an HMM (k-mer, event) cell
# event detection, per sample: the two prefix sums (2 f64 adds, 1 f32
# square) and two t-stat tracks (10 f64 and 8 f32 operations each), and
# the peak scan's ~4 f32 differences; per event 2 f64 and 5 f32 (tstat_at,
# peak_detector, f5c_events_from_peaks)
EV_F64_PER_SAMPLE, EV_F32_PER_SAMPLE = 22, 21
EV_F64_PER_EVENT, EV_F32_PER_EVENT = 2, 5
# f32 operations a sample of K9's sums and tracks alone (the square, the
# two tracks' 8 each; their f64 ones are EV_F64_PER_SAMPLE) and of its
# peak scan (~4 comparisons)
EV_SUMS_F32_PER_SAMPLE, EV_PEAK_F32_PER_SAMPLE = 17, 4
# f32 ops of a Viterbi (k-mer, event) cell: emission 6, MATCH 5 adds and 4
# maxes, BAD_EVENT 2 adds and 1 max, KMER_SKIP 2 adds, 1 max, 3 more
VIT_CELL_OPS = 24
KERNELS = {
    "abea_fill": ("f5c_tpu_torch/csrc/abea.cu", "f5c_tpu/ops/abea_ring.py:69"),
    # K11, fused into K1 and K3; timed and held through its probe
    "abea_ranks": ("f5c_tpu_torch/csrc/abea_band.cuh",
                   "f5c_tpu/ops/seq_ranks.py:72"),
    # K4: the tile-parallel walk, the route of every read of at least
    # abea_cuda.TILED_MIN_BANDS bands (every read of the main path); the
    # one-warp walk of csrc/abea.cu, the route of shorter reads, is held
    # and timed beside it ("abea_walk_warp")
    "abea_walk": ("f5c_tpu_torch/csrc/abea_walk_tiled.cu",
                  "f5c_tpu/ops/abea_ring.py:377"),
    "hmm_forward": ("f5c_tpu_torch/csrc/hmm.cu",
                    "f5c_tpu/ops/hmm_pallas.py:57"),
    "abea_fill_window": ("f5c_tpu_torch/csrc/abea_ultra.cu",
                         "f5c_tpu/ops/abea_ultra.py:49"),
    # K10: the tile-parallel walk of a window (the one-warp window walk of
    # csrc/abea_ultra.cu is held beside it, off the path)
    "abea_walk_window": ("f5c_tpu_torch/csrc/abea_walk_tiled.cu",
                         "f5c_tpu/ops/abea_ultra.py:306"),
    "events": ("f5c_tpu_torch/csrc/events.cu",
               "f5c_tpu/ops/events_device.py:272"),
    "viterbi": ("f5c_tpu_torch/csrc/viterbi.cu", "f5c_tpu/ops/hmm.py:517"),
}
# K9's three stages, each timed alone at golden x85's first launch and at
# the ultra launch (time_events_stages) and listed as a kernel of its own
K9_STAGES = {
    "events_sums": ("f5c_tpu_torch/csrc/events.cu",
                    "f5c_tpu/ops/events_device.py:95"),
    "events_peaks": ("f5c_tpu_torch/csrc/events.cu",
                     "f5c_tpu/ops/events_device.py:198"),
    "events_assemble": ("f5c_tpu_torch/csrc/events.cu",
                        "f5c_tpu/ops/events_device.py:308"),
}
# their rows, by launch ("golden_x85", "ultra")
STAGES: dict = {}
# the wrapper of a kernel where its name differs (the fused HMM kernel
# counts its launches as hmm_forward)
WRAPPERS = {"hmm_forward": "hmm_forward_meta", "events": "detect_events",
            "viterbi": "viterbi_rounds"}
HMM_META = ("meta", "packed_ref", "read_tab", "ev_pool", "level_mean",
            "level_stdv", "level_log_stdv")
# the fill wrappers' arguments of a synthetic.abea_inputs batch (the
# sequences 2-bit packed), and its plain fills' (ranked on the host)
FILL_ARGS = ("ev_pool", "ev_off", "ev_len", "seq_packed", "seq_off",
             "rk_len", "k", "level_mean", "level_stdv", "level_log_stdv",
             "params", "band_off")
PLAIN_FILL_ARGS = ("ev_pool", "ev_off", "ev_len", "rk_pool", "rk_off",
                   "rk_len", "level_mean", "level_stdv", "level_log_stdv",
                   "params", "band_off")


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


def run_cli(paths: dict, out: str, summary: str | None = None,
            extra=(), ea_engine: str | None = None):
    """One call-methylation run through the CLI, or with ``summary`` one
    eventalign --summary run (with ``ea_engine`` as F5C_TPU_EA_ENGINE);
    ``extra`` are more options; returns (wall seconds, processed reads,
    stage-seconds line)."""
    argv = ["--device", "cuda", *data_argv(paths, out), *extra]
    if summary is None:
        argv = ["call-methylation", "--meth-out-version", "1", *argv]
    else:
        argv = ["eventalign", "--summary", summary, *argv]
    wall, err = run_argv(argv, ea_engine)
    processed = int(err.split("processed: ")[1].split(";")[0])
    stages = [ln for ln in err.splitlines() if "stage seconds" in ln]
    return wall, processed, stages[-1].split("stage seconds: ")[1]


def run_argv(argv, ea_engine: str | None = None) -> tuple[float, str]:
    """One ``f5c_tpu_torch.cli.main(argv)`` (with ``ea_engine`` as
    F5C_TPU_EA_ENGINE); raises unless it exits 0.  Returns (wall seconds,
    its stderr)."""
    from f5c_tpu_torch import cli

    saved = os.environ.get("F5C_TPU_EA_ENGINE")
    if ea_engine is not None:
        os.environ["F5C_TPU_EA_ENGINE"] = ea_engine
    try:
        with CapturedStderr() as cap:
            t0 = time.time()
            rc = cli.main(argv)
            wall = time.time() - t0
    finally:
        if ea_engine is not None:
            if saved is None:
                os.environ.pop("F5C_TPU_EA_ENGINE", None)
            else:
                os.environ["F5C_TPU_EA_ENGINE"] = saved
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return wall, cap.text


def data_argv(d: dict, out: str) -> list:
    return ["--min-mapq", "0", "-b", d["bam"], "-g", d["genome"], "-r",
            d["reads"], "--slow5", d["slow5"], "-o", out]


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
    "hmm_ranks", bit-identical; so must the fills' k-mer ranks, through
    their probe, "abea_ranks", at every fill launch)."""
    from f5c_tpu_torch.ops import (abea, abea_cuda, abea_ultra,
                                   abea_ultra_cuda, events_cuda,
                                   events_device, hmm, viterbi_cuda)

    err = {}
    for name in ("abea_fill", "abea_fill_window"):
        for args, _ in spy_calls.get(name, ()):
            err["abea_ranks"] = max(err.get("abea_ranks", 0),
                                    hold_abea_ranks(*args[3:7]))
    for args, kw in spy_calls.get("abea_fill", ()):
        got = abea_cuda.abea_fill(*args, **kw)
        want = abea.abea_fill_packed_plain(*args[:12])
        err["abea_fill"] = max(err.get("abea_fill", 0), _int_err(got, want))
    for args, kw in spy_calls.get("abea_walk", ()):
        # each route on every read, and the crossover's mix
        want = abea.abea_walk_plain(*args[:6])
        kw = {k: v for k, v in kw.items() if k != "route"}
        for key, route in (("abea_walk", "tiled"), ("abea_walk", None),
                           ("abea_walk_warp", "warp")):
            got = abea_cuda.abea_walk(*args, route=route, **kw)
            err[key] = max(err.get(key, 0), _int_err(got, want))
    for args, kw in spy_calls.get("hmm_forward", ()):
        e, e_ranks = hold_hmm(torch, args, kw)
        err["hmm_forward"] = max(err.get("hmm_forward", 0.0), e)
        err["hmm_ranks"] = max(err.get("hmm_ranks", 0), e_ranks)
    for args, kw in spy_calls.get("abea_fill_window", ()):
        got = abea_ultra_cuda.abea_fill_window(*args, **kw)
        want = abea_ultra.fill_window_packed_plain(*args, **kw)
        err["abea_fill_window"] = max(err.get("abea_fill_window", 0),
                                      _int_err(got, want))
    for args, kw in spy_calls.get("abea_walk_window", ()):
        want = abea_ultra.walk_window_plain(*args)
        for key, route in (("abea_walk_window", "tiled"),
                           ("abea_walk_window_warp", "warp")):
            got = abea_ultra_cuda.abea_walk_window(*args, route=route)
            err[key] = max(err.get(key, 0), _int_err(got, want))
    for args, kw in spy_calls.get("events", ()):
        got = events_cuda.detect_events(*args, **kw)
        want = events_device.detect_events_plain(*args, **kw)
        err["events"] = max(err.get("events", 0), _int_err(got, want))
    for args, kw in spy_calls.get("viterbi", ()):
        got = viterbi_cuda.viterbi_rounds(*args, **kw)
        want = hmm.viterbi_rounds_plain(*args[:9])
        err["viterbi"] = max(err.get("viterbi", 0), _int_err(got, want))
    for name in ("abea_fill", "abea_walk", "abea_walk_warp",
                 "abea_fill_window", "abea_walk_window",
                 "abea_walk_window_warp", "abea_ranks", "hmm_ranks", "events",
                 "viterbi"):
        if err.get(name, 0) != 0:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err[name]})")
    return err


def hold_abea_ranks(seq_packed, seq_off, rk_len, k) -> int:
    """The fills' k-mer ranks (the probe abea_cuda.abea_ranks) against
    their plain version (seq_ranks.ranks_at_kmers: ranks_from_packed at
    every read's k-mers), on the card; returns the largest difference."""
    from f5c_tpu_torch.ops import abea_cuda
    from f5c_tpu_torch.ops.seq_ranks import ranks_at_kmers

    return _int_err((abea_cuda.abea_ranks(seq_packed, seq_off, rk_len, k),),
                    (ranks_at_kmers(seq_packed, seq_off, rk_len, k),))


def abea_rank_probe_cases(torch, dev) -> dict:
    """The fills' k-mer ranks (the probe) held bit for bit to their plain
    version at k = 5, 6 and 9, on synthetic.abea_rank_cases (reads at
    every offset mod 4 of the packed buffer, Ns, a read of one k-mer) and
    on 2,000 random reads of up to 3,000 bases.  Returns {k: k-mers
    checked}."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.ops.seq_ranks import pack_seqs

    checked = {}
    for k in (5, 6, 9):
        rng = np.random.default_rng(2030 + k)
        checked[k] = 0
        for seqs in (synthetic.abea_rank_cases(rng, k),
                     [synthetic.random_seq(rng, int(n))
                      for n in rng.integers(k, 3000, 2000)]):
            packed, off = pack_seqs(seqs)
            rk_len = np.array([len(q) - k + 1 for q in seqs], np.int32)
            if hold_abea_ranks(*(torch.as_tensor(a, device=dev)
                                 for a in (packed, off, rk_len)), k):
                raise AssertionError(f"abea rank probe differs from "
                                     f"ranks_from_packed at k = {k}")
            checked[k] += int(rk_len.sum())
    return checked


def hold_native(spy_calls, model) -> dict:
    """Each recorded call of the event detector re-run and held to
    native.detect_events read by read, and each recorded Viterbi round to
    the host DP chunk by chunk (native.viterbi_chunk_spec), bit for bit.
    Returns {"events": reads, "viterbi": chunks} checked."""
    import numpy as np

    from f5c_tpu_torch import native
    from f5c_tpu_torch.ops import events_cuda, hmm, viterbi_cuda

    n = {"events": 0, "viterbi": 0}
    for args, kw in spy_calls.get("events", ()):
        ev_off, *outs = (t.cpu().numpy() for t in
                         events_cuda.detect_events(*args, **kw))
        pa, off = args[0].cpu().numpy(), args[1].cpu().numpy()
        for i in range(off.shape[0] - 1):
            et = native.detect_events(pa[off[i]:off[i + 1]], rna=args[2])
            a, b = ev_off[i], ev_off[i + 1]
            if any(o[a:b].tobytes() != w.tobytes() for o, w in zip(
                    outs, (et.start, et.length, et.mean, et.stdv))):
                raise AssertionError(f"events differ from native.detect_"
                                     f"events on read {i} of a launch")
            n["events"] += 1
    tables = [np.asarray(t, np.float32) for t in (
        model.level_mean, model.level_stdv, model.level_log_stdv)]
    for args, kw in spy_calls.get("viterbi", ()):
        movs, ns = (t.cpu().numpy() for t in
                    viterbi_cuda.viterbi_rounds(*args, **kw))
        si, sf = args[0].cpu().numpy(), args[1].cpu().numpy()
        rank_pool, ev_pool = args[3].cpu().numpy(), args[4].cpu().numpy()
        for i in range(si.shape[0]):
            want = native.viterbi_chunk_spec(rank_pool, si[i], sf[i],
                                             args[2], ev_pool, *tables)
            if not np.array_equal(hmm.unpack_movements(movs[i], int(ns[i])),
                                  want):
                raise AssertionError(f"viterbi chunk {i} differs from the "
                                     "host DP")
            n["viterbi"] += 1
    return n


def synthetic_k8k9(torch, dev) -> dict:
    """K9 on synthetic.event_signals (DNA of a few lengths, tiny values,
    the densest pattern; RNA) and the golden signals, and K8 on a
    synthetic round of 300 mixed chunks, on two rounds of the
    partition's edge chunks (synthetic.viterbi_edge_shapes: 1 to REG_CAP
    k-mers on the register kernel, to 400 on the tiled one; 1 to 4,000
    events) and on 100 chunks of synthetic.viterbi_far_round (events, gm
    or gs outside the fast division's range: the register kernel's
    __fdiv_rn fill), each once as the wrapper places the movement tables
    and once with every table in global memory: each held to its plain
    version and to the host code.  Returns fields to print."""
    import numpy as np

    from f5c_tpu_torch import datasets, synthetic
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import hmm, viterbi_cuda

    nuc = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(2031)
    sig = synthetic.event_signals(rng, nuc, builtin_model(
        "rna_r9_nucleotide"))
    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    calls = {"events": [], "viterbi": []}
    for rna, pas in ((False, [f.get(r).to_pa() for r in f.read_ids()]
                      + sig["dna"]), (True, sig["rna"])):
        off = np.zeros(len(pas) + 1, np.int64)
        np.cumsum([p.shape[0] for p in pas], out=off[1:])
        calls["events"].append(((torch.from_numpy(np.concatenate(pas)).to(
            dev), torch.from_numpy(off).to(dev), rna), {}))
    tables = [torch.as_tensor(np.asarray(t, np.float32), device=dev)
              for t in (nuc.level_mean, nuc.level_stdv, nuc.level_log_stdv)]
    for shapes in (None, *(synthetic.viterbi_edge_shapes(
            viterbi_cuda.GROUP, viterbi_cuda.REG_CAP, tiled)
            for tiled in (False, True)), "far"):
        x = (synthetic.viterbi_far_round(rng, nuc, 100) if shapes == "far"
             else synthetic.viterbi_round(rng, nuc, 300, shapes=shapes))
        vargs = (torch.from_numpy(x["spec_i32"]).to(dev),
                 torch.from_numpy(x["spec_f32"]).to(dev),
                 hmm.viterbi_consts(),
                 torch.from_numpy(x["rank_pool"]).to(dev),
                 torch.from_numpy(x["ev_pool"]).to(dev), *tables,
                 hmm.viterbi_max_path(x["spec_i32"][:, 2],
                                      x["spec_i32"][:, 5]))
        calls["viterbi"].append((vargs, {}))
    err = compare_launches(calls, torch)
    held = hold_native(calls, nuc)
    cap = viterbi_cuda.TABLE_SMEM_MAX
    viterbi_cuda.TABLE_SMEM_MAX = 1       # every table in global memory
    try:
        err_g = compare_launches({"viterbi": calls["viterbi"]}, torch)
        held_g = hold_native({"viterbi": calls["viterbi"]}, nuc)
    finally:
        viterbi_cuda.TABLE_SMEM_MAX = cap
    return dict(errors=err, global_tables=err_g, native_reads=held["events"],
                native_chunks=held["viterbi"] + held_g["viterbi"])


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
    fill_args = tuple(t[k] for k in FILL_ARGS)
    from f5c_tpu_torch.ops import abea

    trace, llk, start_e = abea.abea_fill_packed_plain(*fill_args)
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
    args = tuple(t[k] for k in (*FILL_ARGS, "byte_off"))
    plain_args = tuple(t[k] for k in (*PLAIN_FILL_ARGS, "byte_off"))
    nb_max = int(np.diff(x["band_off"]).max())
    if abea_ultra.n_windows(nb_max, SYNTH_WIN) < 4:
        raise AssertionError("the synthetic read spans < 4 windows")
    spy = Spy([abea_ultra_cuda])
    try:
        got = abea_ultra_cuda.abea_align_windowed(
            *args, x["n_bytes"], nb_max, SYNTH_WIN)
    finally:
        spy.close()
    plain = abea_ultra.align_windowed(*plain_args, x["n_bytes"], nb_max,
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


def time_unchunked_kernels(torch, calls, plain_fills, win: int) -> dict:
    """The unchunked ABEA kernels of an ultra run, timed at its shapes
    (ms), and the fill's packed trace rows and llk held byte for byte, at
    the windows of ``plain_fills`` ({tag: (base, the plain re-fill's
    outputs on the host)}, from the windowed run: hold_windows), to the
    plain re-fill's rows of the same reads (matched by their k-mer
    counts)."""
    import numpy as np

    from f5c_tpu_torch.ops import abea_cuda

    fill, walk = calls["abea_fill"][0][0], calls["abea_walk"][0][0]
    trace, llk, _ = abea_cuda.abea_fill(*fill)
    band_off = fill[11].cpu().numpy()
    rk_len = fill[5].cpu().numpy()
    e, rows_held = 0, 0
    for base, (_, p_tr, p_llk), p_rk in plain_fills.values():
        for j, nk in enumerate(p_rk):
            [i] = np.nonzero(rk_len == nk)[0]
            rows = int(min(band_off[i + 1] - band_off[i] - base, win))
            if rows <= 0:
                continue
            b = int(band_off[i]) + base
            e = max(e, _int_err((trace[b:b + rows].cpu(),
                                 llk[b:b + rows].cpu()),
                                (p_tr[j, :rows], p_llk[j, :rows])))
            rows_held += rows
    if e or not rows_held:
        raise AssertionError("ultra: the unchunked fill's trace differs "
                             f"from the plain re-fill's ({e})")
    got = abea_cuda.abea_walk(*walk)
    walk_info = hold_walk_routes(torch, walk, got, "ultra unchunked")
    fill_ms = time_ms(torch, lambda: abea_cuda.abea_fill(*fill), 1)
    chain = int(np.diff(band_off).max())
    return dict(
        fill_unchunked=fill_ms,
        fill_unchunked_ns_per_band=round(1e6 * fill_ms / chain, 1),
        fill_unchunked_chain_bands=chain,
        walk_unchunked_steps=int(got[1].max()),
        walk_unchunked_bound_ms=bound_of("abea_walk", walk, {},
                                         got)[0],
        **{f"unchunked_{k}": v for k, v in walk_info.items()},
        fill_unchunked_rows_held=rows_held)


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

    from f5c_tpu_torch.ops import _build, abea, abea_ultra, abea_ultra_cuda

    fwd = calls["abea_fill_window"][0][0]
    if fwd[16] or fwd[13] != 2:
        raise AssertionError("the first window launch is not the forward")
    n_win = fwd[15]
    refill = {a[13]: a for a, _ in calls["abea_fill_window"][1:]}
    walks = {a[2]: a for a, _ in calls["abea_walk_window"]}
    nb = np.diff(fwd[11].cpu().numpy())
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
            torch, lambda: abea_ultra.fill_window_packed_plain(*fa))
        want_w, plain_w = run_once(
            torch, lambda: abea_ultra.walk_window_plain(*wa))
        got_f = abea_ultra_cuda.abea_fill_window(*fa)
        got_w = abea_ultra_cuda.abea_walk_window(*wa)
        warp_w = abea_ultra_cuda.abea_walk_window(*wa, route="warp")
        if _int_err(warp_w, want_w):
            raise AssertionError("the one-warp window walk differs from "
                                 "plain")
        err["abea_fill_window"] = max(
            err["abea_fill_window"], _int_err(got_f, want_f),
            _int_err((ckpt[:, w:w + 1].contiguous(),), want_f[:1]),
            _int_err(wa[:2], want_f[1:]))
        err["abea_walk_window"] = max(err["abea_walk_window"],
                                      _int_err(got_w, want_w))
        ms_f = time_ms(torch, lambda: abea_ultra_cuda.abea_fill_window(*fa),
                       3)
        # the walks by their launch spans (the wrapper's copies of its
        # (k, e, n) and output outside them)
        ms_w = kernel_ms(torch, _build, lambda: abea_ultra_cuda.
                         abea_walk_window(*wa), 3)
        ms_warp = kernel_ms(torch, _build, lambda: abea_ultra_cuda.
                            abea_walk_window(*wa, route="warp"), 3)
        phases = walk_phase_ms(torch, lambda p, sc: abea_ultra_cuda.
                               abea_walk_window(*wa, phases=p, scratch=sc),
                               3)
        timings[tag] = {
            "abea_fill_window": (ms_f, plain_f, *bound_of(
                "abea_fill_window", fa, {}, got_f)),
            "abea_walk_window": (ms_w, plain_w, *bound_of(
                "abea_walk_window", wa, {}, got_w))}
        info[f"window_{tag}"] = dict(
            index=w, base=base, bands=int(np.clip(nb - base, 0, win).max()),
            reads=int((nb > base).sum()), fill_ms=round(ms_f, 3),
            fill_plain_ms=round(plain_f, 1),
            fill_ns_per_band=round(1e6 * ms_f / win, 1),
            walk_ms=round(ms_w, 3), walk_warp_ms=round(ms_warp, 3),
            walk_phases_ms=phases, walk_plain_ms=round(plain_w, 1),
            walk_chase_tiles=-(-win // abea.WALK_TILE),
            walk_steps=int((got_w[0][:, 2] - wa[3][:, 2]).sum()))
        plain_fills[tag] = (base, want_f)
    for name, e in err.items():
        if e != 0:
            raise AssertionError(f"{name}: kernel differs from plain at the "
                                 f"run's windows (max abs err {e})")
    return err, timings, info, plain_fills


def hold_walk_routes(torch, walk_args, walk, what: str) -> dict:
    """An unchunked walk launch (``walk``: the wrapper's output on
    ``walk_args``) held bit for bit by each route -- the one-warp kernel
    and the tiled kernels on every read -- and to the plain tiled walk
    (abea.abea_walk_tiled_plain, the plain version of its three phases);
    each route and the tiled walk's phases timed by their launch spans.
    Returns fields to print."""
    from f5c_tpu_torch.ops import _build, abea, abea_cuda

    want, plain_ms = run_once(
        torch, lambda: abea.abea_walk_tiled_plain(*walk_args[:6]))
    routes = {r: abea_cuda.abea_walk(*walk_args, route=r)
              for r in ("warp", "tiled")}
    for r, got in list(routes.items()) + [("crossover", walk)]:
        if _int_err(got, want):
            raise AssertionError(f"{what}: the {r} walk differs from the "
                                 "plain tiled walk")
    bands = (walk_args[2][1:] - walk_args[2][:-1]).cpu().numpy()
    ms = {r: round(kernel_ms(torch, _build, lambda: abea_cuda.abea_walk(
        *walk_args, route=r), 5), 4) for r in ("warp", "tiled")}
    return dict(walk_warp_ms=ms["warp"], walk_tiled_ms=ms["tiled"],
                walk_tiled_phases_ms=walk_phase_ms(
                    torch, lambda p, sc: abea_cuda.abea_walk(
                        *walk_args, route="tiled", phases=p, scratch=sc), 5),
                walk_tiled_plain_ms=round(plain_ms, 1),
                walk_chase_tiles=int(-(-bands.max() // abea.WALK_TILE)),
                walk_tiled_reads=int((bands >= abea_cuda.TILED_MIN_BANDS)
                                     .sum()))


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
    args = tuple(t[k] for k in FILL_ARGS)
    nb = np.diff(x["band_off"])
    chain = int(nb.max())
    if chain // abea.FILL_TILE < 50 or chain // abea.WALK_TILE < 50:
        raise AssertionError("the long read spans < 50 tiles")
    fill = abea_cuda.abea_fill(*args, x["n_bands"])
    walk_args = (fill[0], fill[1], t["band_off"], fill[2], t["rk_len"],
                 t["byte_off"], x["n_bytes"])
    walk = abea_cuda.abea_walk(*walk_args)
    walk_info = hold_walk_routes(torch, walk_args, walk, "mixed batch")
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
    info.update(walk_info)
    info.update(reads=len(seqs), chain_bands=chain,
                walk_steps=int(walk[1].max()), fill_ms=round(fill_ms, 3),
                fill_bound_ms=round(f_bound[0], 4),
                fill_ns_per_band=round(1e6 * fill_ms / chain, 1),
                walk_ms=round(walk_ms, 3),
                walk_bound_ms=round(w_bound[0], 4),
                walk_ns_per_step=round(1e6 * walk_ms / int(walk[1].max()),
                                       1))
    return err, info


def ultra_budget(runner, datasets) -> int:
    """The trace budget under which every ultra read takes the windowed
    ABEA: a share of datasets.ULTRA_WINDOWED_SHARE bands a read."""
    from f5c_tpu_torch.ops.abea import TRACE_ROW_BYTES

    return (runner.Pipeline.WAVE * (TRACE_ROW_BYTES + 4)
            * datasets.ULTRA_WINDOWED_SHARE)


def ultra_phase(tmp, torch, card, runner, datasets, kernel_mods,
                reset_counts, read_counts):
    """Phase 6.  Returns the launch counts of the windowed
    call-methylation run (the budget lowered), the main path of the
    window kernels, the window kernels' errors and (ms, plain_ms) at
    that run's shapes, and the fields of its full window (hold_windows:
    the walk by each route, the tiled walk's phases)."""
    import filecmp

    from f5c_tpu_torch.ops import abea_ultra
    from f5c_tpu_torch.ops.abea import TRACE_ROW_BYTES

    data = datasets.ultra_dataset(os.path.join(tmp, "ultra"), seed=2026)
    win = runner.Pipeline.WIN_BANDS
    budget = runner.Pipeline.TRACE_BYTES_BUDGET
    runs, kernel_ms = {}, {}
    for mode in ("windowed", "unchunked"):
        if mode == "windowed":
            runner.Pipeline.TRACE_BYTES_BUDGET = ultra_budget(runner,
                                                              datasets)
        try:
            # warm-up with the kernel calls recorded: each ABEA kernel
            # held to its plain version and timed at these shapes, then
            # the calls dropped so that they hold no device memory during
            # the measured runs
            spy = Spy(kernel_mods)
            try:
                run_cli(data, os.path.join(tmp, f"ultra_{mode}_warm.tsv"),
                        extra=DEVICE_EVENTS)
            finally:
                spy.close()
            # all four reads in the window launches, or none
            win_reads = {a[2].shape[0] for a, _ in
                         spy.calls["abea_fill_window"]}
            if win_reads != ({4} if mode == "windowed" else set()):
                raise AssertionError(f"ultra {mode}: window launches of "
                                     f"{sorted(win_reads)} reads")
            if mode == "windowed":
                nb = (spy.calls["abea_fill_window"][0][0][11].diff()
                      .min().item())
                err, timings, info, plain_fills = hold_windows(
                    torch, spy.calls, win,
                    {"last": len(spy.calls["abea_walk_window"]) - 1,
                     "full": (nb - 2) // win - 1})
                # kept on the host, with the reads' k-mer counts, for
                # the unchunked fill's hold
                rk = spy.calls["abea_fill_window"][0][0][5].cpu().numpy()
                plain_fills = {
                    tag: (base, [None if t is None else t.cpu()
                                 for t in want], rk)
                    for tag, (base, want) in plain_fills.items()}
                timings = timings["full"]
                kernel_ms.update(info)
                walk_full = info["window_full"]
                err.update(compare_launches(
                    {"hmm_forward": spy.calls["hmm_forward"]}, torch))
                kernel_ms.update(hmm_launches=len(spy.calls["hmm_forward"]),
                                 hmm_max_abs_err=err["hmm_forward"])
                kernel_ms.update(hold_ultra_events(torch, spy.calls["events"]))
            else:
                kernel_ms.update(time_unchunked_kernels(
                    torch, spy.calls, plain_fills, win))
            del spy
            entries = [("meth", ()), ("eventalign", ())]
            if mode == "windowed":
                # with device events too: K9's scratch in the peak
                entries.append(("meth_device_events", DEVICE_EVENTS))
            for cmd, extra in entries:
                out = os.path.join(tmp, f"ultra_{mode}_{cmd}.tsv")
                summary = out + ".summary" if cmd == "eventalign" else None
                rec = WalkRecorder(runner)
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                try:
                    wall, processed, stages = run_cli(data, out, summary,
                                                      extra=extra)
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
                        or (cmd != "eventalign"
                            and counts["hmm_forward"] == 0)
                        or (counts["events"] > 0) != bool(extra)):
                    raise AssertionError(f"ultra {mode} {cmd} run failed")
        finally:
            runner.Pipeline.TRACE_BYTES_BUDGET = budget
    walks = runs["windowed", "meth"]["walks"]
    say("ultra_windows", win=win, per_read={
        q: abea_ultra.n_windows(w[3], win) for q, w in sorted(walks.items())},
        bands={q: w[3] for q, w in sorted(walks.items())},
        walk_steps={q: w[0] for q, w in sorted(walks.items())})
    share = budget // (runner.Pipeline.WAVE * (TRACE_ROW_BYTES + 4))
    say("trace_layout", trace_row_bytes=TRACE_ROW_BYTES,
        default_share_bands=share,
        forced_share_bands=datasets.ULTRA_WINDOWED_SHARE,
        ultra_bands={q: w[3] for q, w in sorted(walks.items())})
    say("ultra_kernels", card=card.replace(" ", "_"),
        **{k: (f"{v:.3f}" if isinstance(v, float) else v)
           for k, v in kernel_ms.items()})
    dev_ev = runs["windowed", "meth_device_events"]
    same = filecmp.cmp(dev_ev["out"], runs["windowed", "meth"]["out"],
                       shallow=False)
    say("ultra_compare", entry="meth", file="device_events_vs_host",
        walks_identical=dev_ev["walks"] == walks, byte_identical=same)
    if not same or dev_ev["walks"] != walks:
        raise AssertionError("ultra meth: device events differ from host")
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
    return runs["windowed", "meth"]["counts"], err, timings, walk_full


def hold_ultra_events(torch, calls) -> dict:
    """The event detector's launch of the ultra run (the 4 reads' ~1.28 M
    events) held to its plain version and to native.detect_events bit for
    bit, and timed, its peak kernel also alone.  Returns fields to print."""
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import _build, events_cuda, events_device

    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} event launches in the ultra run")
    args, kw = calls[0]
    want, plain_ms = run_once(
        torch, lambda: events_device.detect_events_plain(*args, **kw))
    got = events_cuda.detect_events(*args, **kw)
    if _int_err(got, want) != 0:
        raise AssertionError("ultra events: kernel differs from plain")
    held = hold_native({"events": calls}, builtin_model("dna_r9_nucleotide"))
    ms = time_ms(torch, lambda: events_cuda.detect_events(*args, **kw), 3)
    kern_ms = kernel_ms(torch, _build,
                        lambda: events_cuda.detect_events(*args, **kw), 3)
    peak_scan = time_peak_scan(torch, _build, args, 3)
    stages = time_events_stages(torch, args, 5, "ultra")
    off = args[1].cpu().numpy()
    return dict(events_ms=kern_ms, events_wrapper_ms=ms,
                events_cumsum_ms=cumsum_ms(torch, args[0], 3),
                **{f"events_stage_{k}": v for k, v in stages.items()},
                events_fixed_reads=events_cuda.fixed_reads["events"],
                **{f"events_{k}": v for k, v in peak_scan.items()},
                events_plain_ms=plain_ms,
                events_bound_ms=bound_of("events", args, kw, got)[0],
                events_samples=int(off[-1]),
                events_longest_read=int((off[1:] - off[:-1]).max()),
                events_events=int(got[1].shape[0]),
                events_vs_native_reads=held["events"])


def cumsum_ms(torch, samples, reps: int) -> float:
    """torch.cumsum's ms over a K9 launch's samples in f64 and their
    squares (one call over both, as rows): the library's prefix sums, a
    reference for K9's sums kernel only, and not bit for bit the host's
    order (K9's sums are, by their sample-order redo)."""
    x = samples.double()
    rows = torch.stack([x, x * x])
    return time_ms(torch, lambda: torch.cumsum(rows, dim=1), reps)


def cumsum_flat_ms(torch, samples, reps: int) -> float:
    """The same prefix sums as two flat 1-D torch.cumsum calls, of the f64
    samples, then of their squares (the 2-row call of cumsum_ms may scan a
    row to a block): the fair yardstick of K9's sums."""
    x = samples.double()
    sq = x * x
    return time_ms(torch, lambda: (torch.cumsum(x, 0), torch.cumsum(sq, 0)),
                   reps)


def _bits_err(got, want) -> float:
    """0.0 when every output pair is equal bit for bit (floats as their
    bits), else the largest absolute difference (inf if none shows)."""
    import torch

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    same = all(g.shape == w.shape and torch.equal(
        g.view(ints.get(g.dtype, g.dtype)),
        w.to(g.device).view(ints.get(w.dtype, w.dtype)))
        for g, w in zip(got, want))
    if same:
        return 0.0
    diff = [float((g.double() - w.to(g.device).double()).abs().max())
            for g, w in zip(got, want) if g.shape == w.shape and g.numel()]
    return max([d for d in diff if d > 0] or [float("inf")])


def stage_rows(launches: int, err: float) -> list:
    """The JSON rows of K9's stages: timed alone at golden x85's first
    launch, the ultra launch's numbers beside them as ultra_*; their
    launches are K9's on the main path (each launch runs each stage once),
    their error the larger of theirs and K9's at every checked launch."""
    main = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, (source, replaces) in K9_STAGES.items():
        row, ultra = STAGES["golden_x85"][name], STAGES["ultra"][name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(row["max_abs_err"], ultra["max_abs_err"], err),
            **{k: row.get(k) for k in main},
            **{f"ultra_{k}": v for k, v in ultra.items()},
            **{k: v for k, v in row.items()
               if k not in main and k != "max_abs_err"}))
    return rows


def time_events_stages(torch, args, reps: int, label: str) -> dict:
    """K9's three stages at a recorded launch of the event detector, each
    launched alone on one scratch (events_cuda.stages): the sums and
    tracks held bit for bit to their plain model (sums_tracks_model), the
    bounds slab to the sequential peak_scan of each read's tracks, the
    assembly to its plain model (assemble_model) on the card's slabs;
    each timed (CUDA events over ``reps`` launches of the stage alone:
    where its kernels are shorter than their launches from the host, as
    the assembly's at golden x85, the host's launch rate), with its
    bound (bound_of) and its plain version's time (run once),
    and for the sums torch.cumsum's prefix sums of the launch's f64
    samples and squares, flat (library_ms) and as 2 rows.  Keeps the rows
    in STAGES[label]; returns fields to print."""
    from f5c_tpu_torch.ops import events_cuda
    from f5c_tpu_torch.ops import events_device as ed

    pa, off, rna = args[:3]
    L = events_cuda.stages(pa, off, rna)
    sums = (L.s, L.q, L.t1[:L.S_n], L.t2[:L.S_n], L.fixed)
    want, sums_plain = run_once(torch,
                                lambda: ed.sums_tracks_model(pa, off, rna))
    err = {"events_sums": _bits_err(sums, want)}
    t1, t2 = want[2].tolist(), want[3].tolist()
    o = off.cpu().tolist()
    peaks, peaks_plain = run_once(torch, lambda: [
        ed.peak_scan(t1[a:b], t2[a:b], b - a, rna) for a, b in zip(o, o[1:])])
    bnd, ne = L.bnd.cpu().tolist(), L.n_ev.cpu().tolist()
    err["events_peaks"] = float(any(
        bnd[a + 2 * i:a + 2 * i + ne[i] + 1] != [0] + p + [b - a]
        for i, (a, b, p) in enumerate(zip(o, o[1:], peaks))))
    slabs = [t.cpu() for t in (L.s, L.q, L.off, L.bnd, L.ev_off)]
    events = (L.start, *L.out)
    want_ev, asm_plain = run_once(torch, lambda: ed.assemble_model(*slabs))
    err["events_assemble"] = _bits_err(events, want_ev)
    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise AssertionError(f"K9 stages at {label} differ from their plain "
                             f"models: {bad}")
    timed = {"events_sums": (L.sums, sums_plain, bound_of(
                 "events_sums", (pa, off), {}, sums)),
             "events_peaks": (L.peaks, peaks_plain, bound_of(
                 "events_peaks", (L.t1[:L.S_n], L.t2[:L.S_n], off), {},
                 (L.n_ev,))),
             "events_assemble": (L.assemble, asm_plain, bound_of(
                 "events_assemble", (L.s, L.q, off, L.bnd, L.ev_off), {},
                 events))}
    rows = {name: dict(ms=time_ms(torch, fn, reps), plain_ms=plain,
                       bound_ms=bound[0], bound_by=bound[1],
                       max_abs_err=err[name])
            for name, (fn, plain, bound) in timed.items()}
    rows["events_sums"].update(
        library_ms=cumsum_flat_ms(torch, pa, reps),
        library_2row_ms=cumsum_ms(torch, pa, reps), blocks=L.n_tiles,
        fixed_reads=int(L.fixed.sum()))
    STAGES[label] = rows
    return {f"{name[7:]}_{k}": (round(v, 5) if isinstance(v, float) else v)
            for name, row in rows.items() for k, v in row.items()}


def hold_peak_probe(torch, dev) -> dict:
    """K9's peak scan alone (events_cuda.peaks_from_tracks) on the golden
    signals' tracks and on synthetic.peak_tracks, at the kernel's own
    chunk length (0) and at 32 and 1,000 samples: each read's peaks
    events_device.peak_scan's, in order, and its rounds those of the
    plain model at the same chunk length.  Returns fields to print."""
    import numpy as np

    from f5c_tpu_torch import datasets, synthetic
    from f5c_tpu_torch.io.slow5 import Slow5File
    from f5c_tpu_torch.ops import events_cuda, events_device

    f = Slow5File(datasets.GOLDEN_SIGNALS_ZLIB)
    golden = [f.get(r).to_pa() for r in f.read_ids()]
    rounds = {}
    for x in synthetic.peak_probe_batches(np.random.default_rng(2034),
                                          golden):
        args, rna, so = (x["t1"], x["t2"], x["sig_off"]), x["rna"], \
            x["sig_off"].tolist()
        for chunk in (0, 32, 1000):
            got, r = events_cuda.peaks_from_tracks(
                *(a.to(dev) for a in args), rna, chunk)
            want, r_model = events_cuda.peaks_from_tracks(*args, rna, chunk)
            for i, name in enumerate(x["names"]):
                lo, hi = so[i], so[i + 1]
                seq = events_device.peak_scan(x["t1"][lo:hi].tolist(),
                                              x["t2"][lo:hi].tolist(),
                                              hi - lo, rna)
                if got[i] != seq or want[i] != seq or r[i] != r_model[i]:
                    raise AssertionError(f"peak probe: {name} at chunk "
                                         f"{chunk} differs")
                rounds[f"{name}@{chunk}"] = int(r[i])
    return dict(probe_reads=len(rounds),
                probe_rounds_max=max(rounds.values()),
                probe_rounds=json.dumps(rounds, separators=(",", ":")))


def time_peak_scan(torch, _build, args, reps: int) -> dict:
    """K9's peak kernel alone at a recorded launch of the event detector:
    the launch's tracks (its plain version's, moved to the card) through
    the probe at the kernel's own chunk length, its peaks held to the
    launch's event starts, timed (the kernel's CUDA-event spans, mean of
    ``reps``), with its bound: the two tracks read once (8 bytes a
    sample), the bounds written once (4 bytes a peak), the f32
    comparisons (~4 a sample) over the card's rate."""
    from f5c_tpu_torch.ops import events_cuda, events_device

    pa, off, rna = args[:3]
    t1, t2 = events_device.tracks_plain(pa, off, rna)
    targs = (t1.to(pa.device), t2.to(pa.device), off, rna)
    peaks, rounds = events_cuda.peaks_from_tracks(*targs)
    ev_off, start = (t.cpu().numpy() for t in
                     events_cuda.detect_events(*args)[:2])
    for i, p in enumerate(peaks):
        if p != start[ev_off[i] + 1:ev_off[i + 1]].tolist():
            raise AssertionError(f"peak probe: read {i} differs from the "
                                 "launch's event starts")
    ms = kernel_ms(torch, _build,
                   lambda: events_cuda.peaks_from_tracks(*targs), reps)
    n_peaks = sum(len(p) for p in peaks)
    bound = roofline(8 * pa.numel() + 4 * n_peaks, 4 * pa.numel())
    return dict(peaks_ms=ms, peaks_bound_ms=bound[0],
                peaks_rounds_max=int(rounds.max()),
                peaks_rounds_mean=float(rounds.mean()))


def same_bytes(*pairs) -> bool:
    return all(filecmp.cmp(a, b, shallow=False) for a, b in pairs)


def pores_phase(tmp, torch, card, kernel_mods, reset_counts,
                read_counts) -> dict:
    """Phase 7, [pores]: the synthetic R10 9-mer set of
    tests/test_torch_pores.py through call-methylation and eventalign
    --summary (native and device re-alignment engines) on the card, and
    the RNA004 set of tests/test_torch_pores_rna.py through eventalign
    --m6anet (chemistry from the BLOW5 header): each run's K1, K4, K2 and
    K8 launches held to their plain versions (K8 also to the host DP),
    its output to the same run with --device cpu (bytes; the HMM columns
    within f5c's tolerance); then the k = 9 launches timed at a full wave
    (``k9_full_wave``).  Returns the errors against the plain versions."""
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import load_model_file

    t_phase = time.time()
    nuc_path, cpg_path = synthetic.r10_models(os.path.join(tmp, "r10m"))
    r10 = synthetic.r10_dataset(os.path.join(tmp, "r10"), nuc_path)
    rna = synthetic.rna004_dataset(os.path.join(tmp, "rna004"))
    recal = ["--min-recalib-events", "100"]
    r10_meth = ["--pore", "r10", "--kmer-model", nuc_path, "--meth-model",
                cpg_path, *recal]
    r10_ea = ["--pore", "r10", "--kmer-model", nuc_path, *recal]
    runs = {
        # name: (command, dataset, options, re-alignment engine)
        "meth": ("call-methylation", r10, r10_meth, None),
        "ea_native": ("eventalign", r10, r10_ea, "native"),
        "ea_device": ("eventalign", r10, r10_ea, "device"),
        "m6anet": ("eventalign", rna, ["--m6anet", *recal], None),
    }
    calls, counts, walls, out = {}, {}, {}, {}
    for name, (cmd, d, opts, engine) in runs.items():
        for device in ("cuda", "cpu"):
            if device == "cpu" and name == "ea_device":
                continue        # the CPU run of the native engine serves
            o = os.path.join(tmp, f"pores_{name}_{device}.tsv")
            extra = (["--summary", o + ".summary"] if cmd == "eventalign"
                     else [])
            reset_counts()
            spy = Spy(kernel_mods) if device == "cuda" else None
            try:
                walls[name, device] = run_argv(
                    [cmd, *data_argv(d, o), *opts, *extra, "--device",
                     device], ea_engine=engine)[0]
            finally:
                if spy is not None:
                    spy.close()
            if spy is not None:
                counts[name] = read_counts()
                calls[name] = spy.calls
            out[name, device] = o
    err = {}
    for name in runs:
        for k, v in compare_launches(calls[name], torch).items():
            err[k] = max(err.get(k, 0), v)
    held = hold_native({"viterbi": calls["ea_device"]["viterbi"]},
                       load_model_file(nuc_path))
    dev_rows = tolerant_bad(read_text(out["meth", "cuda"]),
                            read_text(out["meth", "cpu"]), HMM_COLS_V2)
    ea_files = [(out[n, "cuda"] + x, out["ea_native", "cpu"] + x)
                for n in ("ea_native", "ea_device") for x in ("",
                                                               ".summary")]
    m6a_files = [(out["m6anet", "cuda"] + x, out["m6anet", "cpu"] + x)
                 for x in ("", ".summary")]
    same_ea, same_m6a = same_bytes(*ea_files), same_bytes(*m6a_files)
    launched = {
        "meth": ("abea_fill", "abea_walk", "hmm_forward"),
        "ea_native": ("abea_fill", "abea_walk"),
        "ea_device": ("abea_fill", "abea_walk", "viterbi"),
        "m6anet": ("abea_fill", "abea_walk")}
    missing = [(n, k) for n, ks in launched.items() for k in ks
               if counts[n][k] == 0]
    k = int(calls["meth"]["hmm_forward"][0][0][7])
    say("pores", card=card.replace(" ", "_"), k=k,
        cpg_levels=int(calls["meth"]["hmm_forward"][0][0][4].shape[0]),
        vs_plain=err, viterbi_chunks_vs_host=held["viterbi"],
        meth_rows=len(read_text(out["meth", "cuda"]).splitlines()) - 1,
        meth_deviant_rows_vs_cpu=dev_rows, eventalign_same_bytes=same_ea,
        m6anet_same_bytes=same_m6a,
        launches={n: {kk: c[kk] for kk in launched[n]}
                  for n, c in counts.items()},
        walls_s={f"{n}_{dv}": round(w, 3) for (n, dv), w in walls.items()},
        seconds=f"{time.time() - t_phase:.1f}")
    if (k != 9 or dev_rows or not same_ea or not same_m6a or missing
            or any(err.get(n, 0) != 0 for n in (
                "abea_fill", "abea_walk", "hmm_ranks", "viterbi"))):
        raise AssertionError(f"pores phase failed (launches missing: "
                             f"{missing})")
    del calls
    wave = k9_full_wave(tmp, torch, card, kernel_mods, nuc_path, r10_meth,
                        r10_ea)
    for name, e in wave["vs_plain"].items():
        err[name] = max(err.get(name, 0), e)
    return err


def k9_full_wave(tmp, torch, card, kernel_mods, nuc_path, meth_opts,
                 ea_opts) -> dict:
    """The k = 9 launches at a full wave: K9_WAVE_READS synthetic R10 reads
    (lengths as in the 4-read set) through call-methylation and the
    device-engine eventalign on the card; K1, K4 and K2 at the first
    launch (WAVE reads) and K8 at the largest round, each held to its
    plain version, timed (K8's kernels alone, as in phase 5) and bounded.
    Prints [pores_k9_wave]; returns {"vs_plain": {name: max abs err}}."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import load_model_file
    from f5c_tpu_torch.ops import (_build, abea, abea_cuda, hmm, hmm_cuda,
                                   hmm_meta, viterbi_cuda)

    t_phase = time.time()
    lengths = np.random.default_rng(11).integers(700, 1401, K9_WAVE_READS)
    d = synthetic.r10_dataset(os.path.join(tmp, "r10_wave"), nuc_path,
                              lengths=lengths)
    t_data = time.time() - t_phase
    spy, walls = Spy(kernel_mods), {}
    try:
        walls["meth"] = run_argv(["call-methylation", *data_argv(
            d, os.path.join(tmp, "wave_meth.tsv")), *meth_opts])[0]
        out_ea = os.path.join(tmp, "wave_ea.tsv")
        walls["ea_device"] = run_argv(
            ["eventalign", *data_argv(d, out_ea), *ea_opts, "--summary",
             out_ea + ".summary"], ea_engine="device")[0]
    finally:
        spy.close()
    fill_a, fill_kw = spy.calls["abea_fill"][0]
    walk_a, walk_kw = spy.calls["abea_walk"][0]
    hmm_a, hmm_kw = spy.calls["hmm_forward"][0]
    vit_a, vit_kw = max(spy.calls["viterbi"],
                        key=lambda c: int(c[0][0].shape[0]))
    del spy
    held = hold_native({"viterbi": [(vit_a, vit_kw)]},
                       load_model_file(nuc_path))
    kernels = {
        "abea_fill": ((fill_a, fill_kw),
                      lambda: abea_cuda.abea_fill(*fill_a, **fill_kw),
                      lambda: abea.abea_fill_packed_plain(*fill_a[:12])),
        "abea_walk": ((walk_a, walk_kw),
                      lambda: abea_cuda.abea_walk(*walk_a, **walk_kw),
                      lambda: abea.abea_walk_plain(*walk_a[:6])),
        "hmm_forward": ((hmm_a, hmm_kw),
                        lambda: hmm_cuda.hmm_forward_meta(*hmm_a, **hmm_kw),
                        lambda: hmm_meta.hmm_forward_meta_plain(*hmm_a)),
        "viterbi": ((vit_a, vit_kw),
                    lambda: viterbi_cuda.viterbi_rounds(*vit_a, **vit_kw),
                    lambda: hmm.viterbi_rounds_plain(*vit_a[:9])),
    }
    timed, err = {}, {}
    for name, ((args, kw), kern, plain) in kernels.items():
        got = kern()
        want, plain_ms = run_once(torch, plain)
        if name == "hmm_forward":
            err[name], err["hmm_ranks"] = hold_hmm(torch, args, kw)
        else:
            err[name] = _int_err(got, want)
        ms = (kernel_ms(torch, _build, kern, 20) if name == "viterbi"
              else time_ms(torch, kern, 20))
        bound, by = bound_of(name, args, kw, got)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by)
    # the rates phase 5 gives at k = 6: per band of the longest read, per
    # step of the longest walk, per warp-step of an SM sub-partition
    chain = int((fill_a[11][1:] - fill_a[11][:-1]).max())
    steps = int(abea_cuda.abea_walk(*walk_a, **walk_kw)[1].max())
    hmm_work = hmm_shape(hmm_a, hmm_kw)
    smsp = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    vit_spec = vit_kw.get("host_spec")
    say("pores_k9_wave", card=card.replace(" ", "_"), reads=len(lengths),
        launch_reads=int(fill_a[2].shape[0]), bands=fill_a[12],
        chain_bands=chain, walk_steps=steps,
        **{f"hmm_{k}": v for k, v in hmm_work.items()},
        hmm_max_km=hmm_kw["max_km"], viterbi_chunks=int(vit_a[0].shape[0]),
        viterbi_cells=int((vit_spec[:, 2].astype(np.int64)
                           * vit_spec[:, 5]).sum()),
        viterbi_chunks_vs_host=held["viterbi"],
        viterbi_ns_per_row=(
            f"{1e6 * timed['viterbi']['ms'] / int(vit_spec[:, 5].max()):.1f}"),
        vs_plain=err, k9_ms=json.dumps(timed, separators=(",", ":")),
        fill_ns_per_band=f"{1e6 * timed['abea_fill']['ms'] / chain:.1f}",
        walk_ns_per_step=f"{1e6 * timed['abea_walk']['ms'] / steps:.1f}",
        hmm_ns_per_warp_step=(
            f"{1e6 * timed['hmm_forward']['ms'] * smsp
                / hmm_work['warp_steps']:.1f}"),
        walls_s={n: round(w, 3) for n, w in walls.items()},
        data_s=f"{t_data:.1f}", seconds=f"{time.time() - t_phase:.1f}")
    if (int(fill_a[2].shape[0]) < K9_WAVE_MIN or any(
            err[n] != 0 for n in ("abea_fill", "abea_walk", "hmm_ranks",
                                  "viterbi"))):
        raise AssertionError("pores: the k = 9 wave is not full, or a "
                             "kernel differs from its plain version")
    return {"vs_plain": err}


def chain_phase(tmp, card, source, truth, reset_counts, read_counts) -> None:
    """Phase 8, [chain]: ``index`` -> ``call-methylation`` on the card (the
    golden set; the whole run and ``--shard 0/2``, ``1/2``) ->
    ``meth-freq`` (with and without -s) -> ``freq-merge`` of the two
    shards: the whole run's calls within f5c's tolerance of meth.exp, the
    shards' rows those of the whole run, and freq-merge of the shards
    equal to meth-freq of the whole run.  (The host steps are held to
    the JAX package's bytes by tests/test_torch_subcommands.py.)"""
    from f5c_tpu_torch.datasets import ROLES

    t_phase = time.time()
    d, counts = {}, {}
    os.makedirs(os.path.join(tmp, "chain"))
    for role, src in source.items():
        d[role] = os.path.join(tmp, "chain", ROLES[role])
        shutil.copy(src, d[role])
    run_argv(["index", d["reads"], "--slow5", d["slow5"]])

    def f(name):
        return os.path.join(tmp, "chain", name)

    for tag, shard in (("all", []), ("s0", ["--shard", "0/2"]),
                       ("s1", ["--shard", "1/2"])):
        reset_counts()
        run_argv(["call-methylation", "--meth-out-version", "1",
                  *data_argv(d, f(f"meth_{tag}.tsv")), *shard])
        counts[tag] = read_counts()
        run_argv(["meth-freq", "-i", f(f"meth_{tag}.tsv"), "-o",
                  f(f"freq_{tag}.tsv")])
    run_argv(["meth-freq", "-s", "-i", f("meth_all.tsv"), "-o",
              f("freq_split.tsv")])
    run_argv(["freq-merge", f("freq_s0.tsv"), f("freq_s1.tsv"), "-o",
              f("merged.tsv")])
    meth_bad = deviant_rows(f("meth_all.tsv"), truth)
    rows = {t: sorted(read_text(f(f"meth_{t}.tsv")).splitlines()[1:])
            for t in ("all", "s0", "s1")}
    shards_are_whole = (sorted(rows["s0"] + rows["s1"]) == rows["all"]
                        and rows["s0"] != [] and rows["s1"] != [])
    merge_is_whole = same_bytes((f("merged.tsv"), f("freq_all.tsv")))
    sites = len(read_text(f("freq_all.tsv")).splitlines()) - 1
    split_sites = len(read_text(f("freq_split.tsv")).splitlines()) - 1
    kernels = [counts[t][k] for t in counts
               for k in ("abea_fill", "abea_walk", "hmm_forward")]
    say("chain", card=card.replace(" ", "_"), meth_deviant_rows=meth_bad,
        shard_rows_are_whole=shards_are_whole,
        merge_of_shards_is_whole=merge_is_whole, sites=sites,
        split_sites=split_sites,
        card_launches={t: {k: counts[t][k] for k in (
            "abea_fill", "abea_walk", "hmm_forward")} for t in counts},
        seconds=f"{time.time() - t_phase:.1f}")
    if (meth_bad or not shards_are_whole or not merge_is_whole
            or sites < 10 or split_sites < sites or min(kernels) == 0):
        raise AssertionError("chain phase failed")


def profile_dir_phase(tmp, golden) -> None:
    """Phase 9, [profile_dir]: one call-methylation --profile-dir DIR on the
    card; DIR holds a torch.profiler trace that names K1, K4 and K2."""
    import glob

    prof = os.path.join(tmp, "profile_dir")
    wall, _ = run_argv(["call-methylation",
                        *data_argv(golden, os.path.join(tmp, "prof.tsv")),
                        "--profile-dir", prof])
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    text = read_text(traces[0]) if len(traces) == 1 else ""
    names = {n: text.count(n) for n in PROFILED_KERNELS}
    say("profile_dir", traces=len(traces), wall_s=f"{wall:.3f}",
        trace_mb=f"{len(text) / 2**20:.2f}", kernel_mentions=names)
    if len(traces) != 1 or min(names.values()) == 0:
        raise AssertionError("profile_dir: no trace, or a kernel missing")


PROFILED_KERNELS = ("abea_fill_kernel", "walk_chase_kernel",
                    "hmm_forward_meta_kernel")


def free_port(lo: int = 0) -> int:
    """A port of 127.0.0.1 that is free now: any (``lo`` 0), or one at
    or above ``lo``."""
    import random

    while True:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", random.randint(lo, 65535) if lo else 0))
            except OSError:
                continue
            return s.getsockname()[1]


def dist_ranks(tmp, tag: str, argv: list, n: int = 2,
               profile: bool = False,
               slurm: bool = False) -> tuple[float, list]:
    """``n`` processes of ``python -m f5c_tpu_torch.cli *argv --dist`` on
    this host (a gloo group at a free port of 127.0.0.1, retried once on
    a fresh port; with ``profile`` each rank with its own --profile-dir
    ``tmp/<tag>_prof<rank>``): launched with the three --dist-* options,
    or with ``slurm`` with none, under the environment srun gives a
    2-task step on this host (its job id maps to the port by the JAX
    package's rule).  Returns (wall seconds, [(exit code, stderr)]);
    every process has ended."""
    from f5c_tpu_torch.parallel import distributed

    launch_vars = (*distributed.ENV_VARS, "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                   distributed.OMPI_URI, *distributed.OMPI_VARS,
                   *distributed.SLURM_VARS, distributed.PORT_OVERRIDE)
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in launch_vars}
    env["PYTHONPATH"] = ROOT
    port0 = 65535 - 2**12 + 1
    for attempt in range(2):
        port = free_port(port0 if slurm else 0)
        procs, errs = [], []
        t0 = time.time()
        for r in range(n):
            errs.append(tempfile.TemporaryFile(mode="w+"))
            prof = []
            if profile:
                prof = ["--profile-dir", os.path.join(tmp, f"{tag}_prof{r}")]
                shutil.rmtree(prof[1], ignore_errors=True)
            launch, rank_env = ["--dist-coordinator", f"127.0.0.1:{port}",
                                "--dist-nprocs", str(n),
                                "--dist-rank", str(r)], {}
            if slurm:
                launch, rank_env = [], {
                    "SLURM_JOB_ID": str(4096 + port - port0),
                    "SLURM_STEP_NODELIST": "127.0.0.1",
                    "SLURM_NTASKS": str(n), "SLURM_PROCID": str(r),
                    "SLURM_LOCALID": str(r)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "f5c_tpu_torch.cli", *argv, *prof,
                 "--dist", *launch],
                cwd=ROOT, env={**env, **rank_env},
                stdout=subprocess.DEVNULL, stderr=errs[-1]))
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        res = []
        for rc, f in zip(rcs, errs):
            f.seek(0)
            res.append((rc, f.read()))
            f.close()
        if attempt == 0 and any("EADDRINUSE" in e for _, e in res):
            continue
        return wall, res


def parallel_phase(tmp, card, golden, scale) -> None:
    """Phase 10, [parallel]: the multi-device and multi-process layer on
    the one card.  (a) parallel/mesh_check on golden x85 (510 reads, one
    batch) over two slots of cuda:0: call-methylation's align + HMM and
    device-engine eventalign re-alignment bit for bit the single-device
    run, K1, K4, K2 and K8 launched in both slots (counted per slot), the
    transfer table printed.  (b) two --dist ranks on cuda:0 (gloo on the
    host): call-methylation with the --dist-* options (each rank with its
    own --profile-dir, whose trace names the fill, walk and HMM kernels)
    and eventalign --summary under srun's environment and no option, on
    the golden set, the merged files the bytes of a single-process run,
    the part files removed.  Two slots or ranks on one card measure
    the dispatch's overhead, not scaling."""
    import glob

    import torch
    from f5c_tpu_torch.parallel import mesh, mesh_check

    t_phase = time.time()
    dev = torch.device("cuda", 0)
    res = mesh_check.run_mesh_parity(scale, [dev, dev])
    print("[parallel] transfer table (sharded run):\n"
          + mesh.transfer_table(), flush=True)
    slots = res["slots"]
    missing = [f"{k}.slot{d}" for k in ("abea_fill", "abea_walk",
                                        "hmm_forward", "viterbi")
               for d in (0, 1) if slots.get(f"{k}.slot{d}", 0) == 0]
    say("parallel_mesh", card=card.replace(" ", "_"), reads=res["reads"],
        eventalign_rows=res["ea_rows"], k8_rounds=res["rounds"],
        bit_identical=True,
        single_s=f"{res['single_s']:.3f}",
        sharded_s=f"{res['sharded_s']:.3f}",
        slot_launches={k: v for k, v in sorted(slots.items())},
        missing=missing)
    if missing:
        raise AssertionError(f"parallel: {missing} not launched")

    def f(name):
        return os.path.join(tmp, name)

    run_argv(["call-methylation", "--meth-out-version", "1",
              *data_argv(golden, f("par_single.tsv"))])
    run_argv(["eventalign", "--summary", f("par_single_ea.sum"),
              *data_argv(golden, f("par_single_ea.tsv"))])
    wall_m, ranks_m = dist_ranks(
        tmp, "par", ["call-methylation", "--meth-out-version", "1",
                     *data_argv(golden, f("par_dist.tsv"))], profile=True)
    wall_e, ranks_e = dist_ranks(
        tmp, "par_ea", ["eventalign", "--summary", f("par_dist_ea.sum"),
                        *data_argv(golden, f("par_dist_ea.tsv"))],
        slurm=True)
    failed = [err[-2000:] for rc, err in ranks_m + ranks_e if rc != 0]
    same = {name: same_bytes((f(f"par_single{x}"), f(f"par_dist{x}")))
            if not failed else False
            for name, x in (("meth", ".tsv"), ("eventalign", "_ea.tsv"),
                            ("summary", "_ea.sum"))}
    parts_left = sorted(os.path.basename(p)
                        for p in glob.glob(f("par_*.part*")))
    mentions = []
    for r in range(2):
        traces = glob.glob(os.path.join(f(f"par_prof{r}"),
                                        "*.pt.trace.json"))
        text = read_text(traces[0]) if len(traces) == 1 else ""
        mentions.append({n: text.count(n) for n in PROFILED_KERNELS})
    say("parallel_dist", card=card.replace(" ", "_"), ranks=2,
        launchers={"meth": "--dist-* options", "eventalign": "SLURM env"},
        exit_codes=[rc for rc, _ in ranks_m + ranks_e],
        byte_identical=same, parts_left=parts_left,
        rank_kernel_mentions=mentions,
        dist_meth_wall_s=f"{wall_m:.3f}", dist_ea_wall_s=f"{wall_e:.3f}",
        seconds=f"{time.time() - t_phase:.1f}")
    if (failed or not all(same.values()) or parts_left
            or min(min(m.values()) for m in mentions) == 0):
        raise AssertionError("parallel: --dist failed"
                             + "".join(f"\n{e}" for e in failed))


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


def walk_phase_ms(torch, fn, reps: int) -> dict:
    """The tiled walk's three phases, each launched alone by
    ``fn(phases, scratch)`` after one whole run into the same scratch
    (maps, chase, emission: csrc/abea_walk_tiled.cu), ms each by the
    wrapper's launch spans (kernel_ms)."""
    from f5c_tpu_torch.ops import _build

    scratch = {}
    fn(7, scratch)
    return {name: round(kernel_ms(torch, _build, lambda: fn(bit, scratch),
                                  reps), 4)
            for name, bit in (("maps", 1), ("chase", 2), ("emit", 4))}


def kernel_ms(torch, _build, fn, reps: int) -> float:
    """The kernels' own ms per call of a wrapper that waits on the card:
    the CUDA-event spans the wrapper records around its launches
    (``_build.launch_spans``), summed, over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    _build.launch_spans = []
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in _build.launch_spans) / reps
    finally:
        _build.launch_spans = None


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and hasattr(t, "element_size"))


def roofline(nbytes: float, ops: float, f64_ops: float = 0):
    """(bound ms, "bytes" or "operations"): the least time of the card for
    this work, the largest of its bytes, f32 and f64 operations over the
    card's rates."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = max(ops / F32_OPS_PER_S, f64_ops / F64_OPS_PER_S)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bound_of(name: str, args, kw, out):
    """The roofline bound of one kernel call from its inputs and outputs:
    every input read once and every output written once (for the walks,
    the 2-bit trace cells and llk words of the steps taken), and the f32
    operations of the cells computed."""
    if name == "abea_fill":
        cells = args[12] * 100
        return roofline(_nbytes(*args[:12], *out), cells * ABEA_CELL_OPS)
    if name == "abea_ranks":
        # the packed bases in (0.25 B a base), a rank out (4 B a base)
        return roofline(_nbytes(*args[:3], out), 0)
    if name == "abea_walk":
        # a step reads its cell's 2 bits of the trace and its band's llk
        steps = int(out[1].long().sum())
        return roofline(4.25 * steps + _nbytes(*args[2:6], *out), 0)
    if name == "hmm_forward":
        return roofline(_nbytes(*args[:7], out),
                        hmm_shape(args, kw)["cells"] * HMM_CELL_OPS)
    if name == "abea_fill_window":
        base, win, n_win = args[13], args[14], args[15]
        nb = (args[11][1:] - args[11][:-1]).long()
        bands = int((nb - base).clamp(0, n_win * win).sum())
        # each band takes one new k-mer (0.25 B: its base, packed) or one
        # new event (4 B) beyond the first tile's reach of BW k-mers and
        # events per read: the k-mers are the lower-left corner's moves
        # between the state in and the last state out
        llk = abea_ultra_state_llk(args[12]), abea_ultra_state_llk(
            out[0][:, -1])
        kmers = int((llk[1] - llk[0]).clamp(min=0).sum())
        inputs = (0.25 * kmers + 4 * (bands - kmers)
                  + 4.25 * 100 * int((nb > base).sum()))
        return roofline(inputs + _nbytes(args[12], *out),
                        bands * 100 * ABEA_CELL_OPS)
    if name == "abea_walk_window":
        steps = int((out[0][:, 2] - args[3][:, 2]).long().sum())
        return roofline(4.25 * steps + -(-steps // 4)
                        + 2 * _nbytes(args[3]), 0)
    if name == "events":
        samples, events = args[0].numel(), out[1].numel()
        return roofline(_nbytes(args[0], args[1], *out),
                        EV_F32_PER_SAMPLE * samples
                        + EV_F32_PER_EVENT * events,
                        EV_F64_PER_SAMPLE * samples
                        + EV_F64_PER_EVENT * events)
    if name == "events_sums":
        # the samples and offsets in; S, Q, T1, T2 and fixed out
        samples = args[0].numel()
        return roofline(_nbytes(args[0], args[1], *out),
                        EV_SUMS_F32_PER_SAMPLE * samples,
                        EV_F64_PER_SAMPLE * samples)
    if name == "events_peaks":
        # the two tracks and the offsets in; the bounds (an event's and
        # one more a read), the counts and the rounds out
        samples, reads = args[0].numel(), out[0].numel()
        bounds = int(out[0].sum()) + reads
        return roofline(_nbytes(*args) + 4 * bounds + 8 * reads,
                        EV_PEAK_F32_PER_SAMPLE * samples)
    if name == "events_assemble":
        # each bound read once with S and Q at it (an event's and one more
        # a read), the offsets, and the events out
        events, reads = out[0].numel(), args[2].numel() - 1
        return roofline(20 * (events + reads)
                        + _nbytes(args[2], args[4], *out),
                        EV_F32_PER_EVENT * events, EV_F64_PER_EVENT * events)
    if name == "viterbi":
        spec = kw.get("host_spec")
        spec = args[0].cpu().numpy() if spec is None else spec
        nk, ne = spec[:, 2].astype(float), spec[:, 5].astype(float)
        # specs, each chunk's ranks and events and its model entries
        # (mean, stdv, log stdv), once; movements and step counts out
        inputs = _nbytes(args[0], args[1]) + 16 * nk.sum() + 4 * ne.sum()
        return roofline(inputs + _nbytes(*out), VIT_CELL_OPS * (nk * ne).sum())
    raise KeyError(name)


def abea_ultra_state_llk(states):
    """Band bi-1's lower-left k-mer of each window state record (an int
    stored as f32 bits), as int64."""
    import torch
    from f5c_tpu_torch.ops.abea_ultra import ST_LLK

    return states[:, ST_LLK].contiguous().view(torch.int32).long()


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
    for the ``top`` kernels by time and K9's, the rest as "other") of a
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
    # K9's kernels are always listed by name
    shown = ranked[:top] + [kv for kv in ranked[top:]
                            if kv[0].startswith("events_")]
    rest = [kv for kv in ranked[top:] if kv not in shown]
    out = {k: [round(ms, 3), n] for k, (ms, n) in shown}
    if rest:
        out["other"] = [round(sum(v[0] for _, v in rest), 3),
                        sum(v[1] for _, v in rest)]
    return busy / 1e3, out


def profile_runs(torch, card, runner, datasets, reps: int = 3) -> None:
    """``--profile``: golden x85 through call-methylation, and ultra x4
    through both entry points, windowed and unchunked: the walls of
    ``reps`` warm runs, then one run under torch.profiler with the card's
    busy time, its share of that run's wall, and device ms and launches
    per kernel."""
    from torch.profiler import ProfilerActivity, profile

    def measure(data, out, summary, events="auto", ea_engine=None,
                n_warm=reps, **fields):
        def run():
            return run_cli(data, out, summary, ea_engine=ea_engine,
                           extra=("--events-engine", events))

        run()
        res = [run() for _ in range(n_warm)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()[0]
        busy, per = device_busy(torch, prof)
        if events == "device":
            # K9's kernels as the exported trace names them, beside the
            # profiler's events that device_busy reads
            path = out + ".trace.json"
            prof.export_chrome_trace(path)
            text = read_text(path)
            os.remove(path)
            fields["k9_trace_names"] = json.dumps(
                {k: text.count(f"events_{k}_kernel")
                 for k in ("tile_totals", "carry", "rescan", "fix", "tracks",
                           "peaks", "assemble")},
                separators=(",", ":"))
        say("profile", **fields, events=events, ea_engine=ea_engine,
            warm_walls_s=",".join(f"{w:.3f}" for w, _, _ in res),
            stages=" | ".join(st.replace(" ", ",") for _, _, st in res),
            profiled_wall_s=f"{wall:.3f}", busy_ms=f"{busy:.1f}",
            busy_share=f"{100 * busy / (1e3 * wall):.1f}%",
            kernels=json.dumps(per, separators=(",", ":")),
            card=card.replace(" ", "_"))

    with tempfile.TemporaryDirectory(prefix="chip_profile_") as tmp:
        source = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        scale = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                           COPIES)
        # the events engines, warm, in EVENTS_PAIRS pairs whose order
        # alternates, then each once under the profiler
        out = os.path.join(tmp, "x85.tsv")
        engines = ("host", "device")
        walls = {e: [] for e in engines}
        for e in engines:
            run_cli(scale, out, extra=("--events-engine", e))
        for i in range(EVENTS_PAIRS):
            for e in engines if i % 2 == 0 else engines[::-1]:
                walls[e].append(run_cli(scale, out,
                                        extra=("--events-engine", e)))
        for e in engines:
            ws = sorted(w for w, _, _ in walls[e])
            say("events_pairs", engine=e, pairs=EVENTS_PAIRS,
                walls_s=",".join(f"{w:.3f}" for w, _, _ in walls[e]),
                median_s=f"{(ws[len(ws) // 2 - 1] + ws[len(ws) // 2]) / 2:.3f}",
                quartiles_s=f"{ws[len(ws) // 4]:.3f},{ws[3 * len(ws) // 4]:.3f}",
                stages=" | ".join(st.replace(" ", ",")
                                  for _, _, st in walls[e]),
                card=card.replace(" ", "_"))
        for e in engines:
            measure(scale, out, None, events=e, n_warm=0, mode="golden_x85",
                    entry="meth")
        for engine in ("native", "device"):
            out = os.path.join(tmp, "x85_ea.tsv")
            measure(scale, out, out + ".summary", ea_engine=engine,
                    mode="golden_x85", entry="eventalign")
        data = datasets.ultra_dataset(os.path.join(tmp, "ultra"), seed=2026)
        budget = runner.Pipeline.TRACE_BYTES_BUDGET
        # windowed: the budget lowered; unchunked: the defaults
        for mode in ("windowed", "unchunked"):
            if mode == "windowed":
                runner.Pipeline.TRACE_BYTES_BUDGET = ultra_budget(runner,
                                                                  datasets)
            try:
                for cmd in ("meth", "eventalign"):
                    out = os.path.join(tmp, f"{mode}_{cmd}.tsv")
                    summary = out + ".summary" if cmd == "eventalign" else None
                    for events in ("host", "device"):
                        measure(data, out, summary, events=events, mode=mode,
                                entry=cmd)
            finally:
                runner.Pipeline.TRACE_BYTES_BUDGET = budget


def main(argv: list[str]) -> int:
    import numpy as np
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
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import (_build, abea, abea_cuda, abea_ultra_cuda,
                                   events_cuda, events_device, hmm, hmm_cuda,
                                   hmm_meta, viterbi_cuda)
    from f5c_tpu_torch.ops.seq_ranks import ranks_from_packed
    from f5c_tpu_torch.pipeline import eventalign, runner

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
                abea_ultra_cuda.launches, events_cuda.launches,
                viterbi_cuda.launches)
    kernel_mods = [abea_cuda, hmm_cuda, abea_ultra_cuda, events_cuda,
                   viterbi_cuda]
    nuc = builtin_model("dna_r9_nucleotide")

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
            run_cli(golden, os.path.join(tmp, "warmup.tsv"),
                    extra=DEVICE_EVENTS)
        finally:
            spy.close()
        err_golden = compare_launches(spy.calls, torch)
        held_golden = hold_native(spy.calls, nuc)
        err_synth = compare_launches(synthetic_calls(torch, dev), torch)
        probed = rank_probe_cases(torch, dev)
        abea_probed = abea_rank_probe_cases(torch, dev)
        k8k9 = synthetic_k8k9(torch, dev)
        k8k9.update(hold_peak_probe(torch, dev))
        torch.cuda.synchronize()
        say("kernel_vs_plain", golden=err_golden, synthetic=err_synth,
            rank_probe_windows=probed, abea_rank_probe_kmers=abea_probed,
            golden_events_vs_native=held_golden,
            events_fixed_reads=events_cuda.fixed_reads["events"])
        say("k8k9_vs_plain_and_host", **k8k9)

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
                                          os.path.join(tmp, "golden.tsv"),
                                          extra=DEVICE_EVENTS)
        counts = read_counts()
        bad = deviant_rows(os.path.join(tmp, "golden.tsv"), truth)
        say("golden", processed=processed, deviant_rows=bad,
            launches=counts, wall_s=f"{wall:.3f}")
        if (processed != 6 or bad != 0
                or min(counts[k] for k in ("abea_fill", "abea_walk",
                                           "hmm_forward", "events")) == 0):
            raise AssertionError("golden gate failed")
        # the same run with the host event detector: the same bytes
        reset_counts()
        run_cli(golden, os.path.join(tmp, "golden_host.tsv"),
                extra=("--events-engine", "host"))
        same_host = filecmp.cmp(os.path.join(tmp, "golden.tsv"),
                                os.path.join(tmp, "golden_host.tsv"),
                                shallow=False)
        say("golden_events_engines", byte_identical=same_host,
            host_run_events_launches=read_counts()["events"])
        if not same_host or read_counts()["events"] != 0:
            raise AssertionError("golden: device and host events differ")

        # eventalign: the native engine against the truth, then the device
        # engine (every round through the Viterbi kernel): the same bytes
        ea = {}
        for engine in ("native", "device"):
            ea_out = os.path.join(tmp, f"golden_ea_{engine}.tsv")
            ea_sum = os.path.join(tmp, f"golden_ea_{engine}.summary.tsv")
            reset_counts()
            spy = Spy(kernel_mods) if engine == "device" else None
            try:
                wall, processed, _ = run_cli(golden, ea_out, summary=ea_sum,
                                             ea_engine=engine)
            finally:
                if spy is not None:
                    spy.close()
            counts = read_counts()
            bad_ea = tolerant_bad(read_text(ea_out), read_text(
                os.path.join(GOLDEN, "eventalign.exp.gz")), EA_FLOAT_COLS)
            bad_sum = tolerant_bad(read_text(ea_sum), read_text(
                os.path.join(GOLDEN, "eventalign.summary.exp")),
                SUMMARY_FLOAT_COLS, norm_col=2)
            ea[engine] = (ea_out, ea_sum, counts)
            say("golden_eventalign", engine=engine, processed=processed,
                deviant_rows=bad_ea, summary_deviant_rows=bad_sum,
                launches=counts, wall_s=f"{wall:.3f}",
                card=card.replace(" ", "_"))
            if (processed != 6 or bad_ea != 0 or bad_sum != 0
                    or counts["abea_fill"] == 0 or counts["abea_walk"] == 0
                    or (counts["viterbi"] > 0) != (engine == "device")):
                raise AssertionError("eventalign golden gate failed")
        vit_counts = ea["device"][2]
        same_ea = all(filecmp.cmp(a, b, shallow=False) for a, b in zip(
            ea["native"][:2], ea["device"][:2]))
        vit_calls = spy.calls["viterbi"]
        err_vit = compare_launches({"viterbi": vit_calls}, torch)
        held_vit = hold_native({"viterbi": vit_calls}, nuc)
        # the largest round again with its tables in global memory
        big = max(vit_calls, key=lambda c: int(c[0][0].shape[0]))
        cap = viterbi_cuda.TABLE_SMEM_MAX
        viterbi_cuda.TABLE_SMEM_MAX = 1
        try:
            err_big = compare_launches({"viterbi": [big]}, torch)
            held_big = hold_native({"viterbi": [big]}, nuc)
        finally:
            viterbi_cuda.TABLE_SMEM_MAX = cap
        # the probes of the JAX rule for auto (device when a round's host
        # DPs outlast two dispatches)
        dispatch = eventalign.measured_dispatch_overhead(dev)
        host_chunk = eventalign.measured_host_chunk_secs(nuc)
        say("golden_eventalign_engines", byte_identical=same_ea,
            rounds=len(vit_calls), chunks=held_vit["viterbi"],
            vs_plain=err_vit, global_tables_round=dict(
                chunks=held_big["viterbi"], vs_plain=err_big),
            dispatch_probe_s=f"{dispatch:.6f}",
            host_chunk_s=f"{host_chunk:.6f}",
            jax_rule_reads_for_device=int(2 * dispatch / host_chunk) + 1)
        if not same_ea:
            raise AssertionError("eventalign: the device engine's bytes "
                                 "differ from the native engine's")

        # resquiggle on the card against the port on the CPU
        from f5c_tpu_torch import cli

        rq = {}
        for device in ("cuda", "cpu"):
            for fmt in ("tsv", "paf"):
                out = os.path.join(tmp, f"rq_{device}.{fmt}")
                reset_counts()
                with CapturedStderr():
                    t0 = time.time()
                    rc = cli.main(["resquiggle", golden["reads"], "--slow5",
                                   golden["slow5"], "--device", device,
                                   "-o", out, *(["-c"] if fmt == "paf"
                                                else []),
                                   *(DEVICE_EVENTS if device == "cuda"
                                     else ())])
                    rq[device, fmt] = (out, time.time() - t0, read_counts())
                if rc != 0:
                    raise AssertionError(f"resquiggle {device} exited {rc}")
        same_rq = {fmt: filecmp.cmp(rq["cuda", fmt][0], rq["cpu", fmt][0],
                                    shallow=False) for fmt in ("tsv", "paf")}
        rq_counts = rq["cuda", "tsv"][2]
        say("resquiggle", byte_identical=same_rq,
            rows=len(read_text(rq["cuda", "tsv"][0]).splitlines()) - 1,
            wall_cuda_s=f"{rq['cuda', 'tsv'][1]:.3f}",
            wall_cpu_s=f"{rq['cpu', 'tsv'][1]:.3f}", launches=rq_counts)
        if (not all(same_rq.values()) or min(rq_counts[k] for k in (
                "events", "abea_fill", "abea_walk")) == 0):
            raise AssertionError("resquiggle on the card differs from the "
                                 "CPU or skipped a kernel")

        # 5. scale run: 510 reads, twice warm with each events engine in
        # turns, the last (device events) run recorded
        scale = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                           COPIES)
        n_reads = 6 * COPIES
        walls = {"host": [], "device": []}
        engines = ("host", "device", "host", "device")
        for rep, engine in enumerate(engines):
            out = os.path.join(tmp, f"scale{rep}.tsv")
            reset_counts()
            events_cuda.rounds.update(max=0, sum=0, reads=0)
            spy = Spy(kernel_mods) if rep == len(engines) - 1 else None
            try:
                wall, processed, stages = run_cli(
                    scale, out, extra=("--events-engine", engine))
            finally:
                if spy is not None:
                    spy.close()
            counts_all = read_counts()
            counts = {k: v for k, v in counts_all.items()
                      if k in ("abea_fill", "abea_walk", "hmm_forward",
                               "events")}
            # the peak scan's rounds on the main path (the last run)
            scan_rounds = dict(events_cuda.rounds)
            bad = deviant_rows(out, truth, copies=COPIES)
            walls[engine].append(wall)
            say("scale", run=rep + 1, events_engine=engine, reads=processed,
                deviant_rows=bad, wall_s=f"{wall:.3f}",
                reads_per_s=f"{n_reads / wall:.2f}",
                stages=stages.replace(" ", ","), launches=counts,
                waves=f"{runner.Pipeline.WAVE}x{runner.Pipeline.INFLIGHT}",
                card=card.replace(" ", "_"))
            if (processed != n_reads or bad != 0
                    or (counts["events"] > 0) != (engine == "device")
                    or min(counts[k] for k in ("abea_fill", "abea_walk",
                                               "hmm_forward")) == 0):
                raise AssertionError("scale run failed")
        err_scale = compare_launches(spy.calls, torch)
        held_scale = hold_native({"events": spy.calls["events"]}, nuc)
        # eventalign on the same 510 reads with each re-alignment engine;
        # the last device run's rounds recorded
        ea_scale = {}
        ea_engines = ("native", "device", "native", "device")
        for rep, engine in enumerate(ea_engines):
            out = os.path.join(tmp, f"scale_ea_{engine}.tsv")
            reset_counts()
            ea_spy = Spy(kernel_mods) if rep == len(ea_engines) - 1 else None
            try:
                wall, processed, stages = run_cli(
                    scale, out, summary=out + ".s", ea_engine=engine)
            finally:
                if ea_spy is not None:
                    ea_spy.close()
            ea_scale.setdefault(engine, []).append(wall)
            say("scale_eventalign", engine=engine, reads=processed,
                wall_s=f"{wall:.3f}", stages=stages.replace(" ", ","),
                viterbi_launches=read_counts()["viterbi"],
                card=card.replace(" ", "_"))
        if not all(filecmp.cmp(os.path.join(tmp, "scale_ea_native.tsv" + x),
                               os.path.join(tmp, "scale_ea_device.tsv" + x),
                               shallow=False) for x in ("", ".s")):
            raise AssertionError("scale eventalign: engines differ")
        # every round of the device run held to the plain version and,
        # chunk by chunk, to the host DP; its largest round is timed
        scale_vit = ea_spy.calls["viterbi"]
        err_vit_scale = compare_launches({"viterbi": scale_vit}, torch)
        held_vit_scale = hold_native({"viterbi": scale_vit}, nuc)
        big_scale = max(scale_vit, key=lambda c: int(c[0][0].shape[0]))
        say("scale_eventalign_rounds", rounds=len(scale_vit),
            chunks=held_vit_scale["viterbi"], vs_plain=err_vit_scale)
        del ea_spy

        # kernel and plain times at the scale run's first (largest)
        # launch (the chunk Viterbi at the largest round of the scale
        # device-engine eventalign); the window kernels are timed in
        # phase 6.  K9's and K8's wrappers wait on the card, so their
        # kernels are timed apart from the wrappers too
        fill_a, fill_kw = spy.calls["abea_fill"][0]
        walk_a, walk_kw = spy.calls["abea_walk"][0]
        hmm_a, hmm_kw = spy.calls["hmm_forward"][0]
        ev_a, ev_kw = spy.calls["events"][0]
        vit_a, vit_kw = big_scale
        timed = {
            "abea_fill": (lambda: abea_cuda.abea_fill(*fill_a, **fill_kw),
                          lambda: abea.abea_fill_packed_plain(*fill_a[:12])),
            # K11 by its probe, against the torch ops that ranked the
            # packed sequences before the fill kernels did
            "abea_ranks": (lambda: abea_cuda.abea_ranks(*fill_a[3:7]),
                           lambda: ranks_from_packed(fill_a[3], fill_a[6])),
            "abea_walk": (lambda: abea_cuda.abea_walk(*walk_a, **walk_kw),
                          lambda: abea.abea_walk_plain(*walk_a[:6])),
            "hmm_forward": (
                lambda: hmm_cuda.hmm_forward_meta(*hmm_a, **hmm_kw),
                lambda: hmm_meta.hmm_forward_meta_plain(*hmm_a)),
            "events": (
                lambda: events_cuda.detect_events(*ev_a, **ev_kw),
                lambda: events_device.detect_events_plain(*ev_a, **ev_kw)),
            "viterbi": (
                lambda: viterbi_cuda.viterbi_rounds(*vit_a, **vit_kw),
                lambda: hmm.viterbi_rounds_plain(*vit_a[:9])),
        }
        # the serial chains of the ABEA launch: the longest read's bands
        # (fill) and the longest walk's steps; the walk by each route
        chain = int((fill_a[11][1:] - fill_a[11][:-1]).max())
        walk_out = abea_cuda.abea_walk(*walk_a, **walk_kw)
        steps = int(walk_out[1].max())
        walk_routes = hold_walk_routes(torch, walk_a, walk_out, "golden x85")
        hmm_work = hmm_shape(hmm_a, hmm_kw)
        shapes = dict(reads=int(fill_a[2].shape[0]), bands=fill_a[12],
                      chain_bands=chain, walk_steps=steps,
                      **{f"hmm_{k}": v for k, v in hmm_work.items()},
                      hmm_max_km=hmm_kw["max_km"])
        timings = {name: (time_ms(torch, kern, 20), time_ms(torch, plain, 2),
                          *bound_of(name, args, kw, kern()))
                   for name, (kern, plain), (args, kw) in zip(
                       timed, timed.values(),
                       ((fill_a, fill_kw), (fill_a[3:7], {}),
                        (walk_a, walk_kw), (hmm_a, hmm_kw), (ev_a, ev_kw),
                        (vit_a, vit_kw)))}
        # the library's prefix sums at K9's timed launch, the reference of
        # its sums kernel
        events_cumsum = cumsum_ms(torch, ev_a[0], 20)
        wrapper_ms = {}
        for name in ("events", "viterbi", "abea_walk"):
            kern_ms = kernel_ms(torch, _build, timed[name][0], 20)
            wrapper_ms[name] = timings[name][0]
            timings[name] = (kern_ms, *timings[name][1:])
        # K9's peak kernel alone at the timed launch, and its rounds on the
        # main path
        peak_scan = time_peak_scan(torch, _build, ev_a, 20)
        stages_x85 = time_events_stages(torch, ev_a, 20, "golden_x85")
        peak_scan.update(
            rounds_max=scan_rounds["max"],
            rounds_mean=scan_rounds["sum"] / max(scan_rounds["reads"], 1))
        # the unfused input assembly the HMM kernel replaces (K6: the
        # parent's torch ops before its forward kernel), at this launch
        k6_ms = time_ms(torch, lambda: hmm_meta.build_inputs(
            *hmm_a[:3], k=hmm_a[7], kw=max(hmm_kw["max_km"], 1)), 20)
        # an SM sub-partition's time per warp-step: the kernel's time over
        # the warp-steps each of the card's 4 x SMs sub-partitions takes
        smsp = 4 * torch.cuda.get_device_properties(0).multi_processor_count
        ns_ws = (1e6 * timings["hmm_forward"][0] * smsp
                 / hmm_work["warp_steps"])
        ev_n = ev_a[1].cpu().numpy()
        vit_spec = vit_kw.get("host_spec")
        say("timing_k8k9", card=card.replace(" ", "_"),
            events_reads=int(ev_n.shape[0] - 1), events_samples=int(ev_n[-1]),
            events_longest_read=int((ev_n[1:] - ev_n[:-1]).max()),
            events_vs_native_reads=held_scale["events"],
            viterbi_chunks=int(vit_spec.shape[0]),
            viterbi_cells=int((vit_spec[:, 2].astype(np.int64)
                               * vit_spec[:, 5]).sum()),
            viterbi_longest_chain=int((vit_spec[:, 2] + 2 * vit_spec[:, 5])
                                      .max()),
            viterbi_group=viterbi_cuda.GROUP,
            viterbi_ns_per_row=(f"{1e6 * timings['viterbi'][0]
                                   / int(vit_spec[:, 5].max()):.1f}"),
            viterbi_vs_one_block=f"{timings['viterbi'][0] / K8_ONE_BLOCK_MS:.3f}",
            walls_host_events=[round(w, 3) for w in walls["host"]],
            walls_device_events=[round(w, 3) for w in walls["device"]],
            walls_ea_native=[round(w, 3) for w in ea_scale["native"]],
            walls_ea_device=[round(w, 3) for w in ea_scale["device"]],
            events_wrapper_ms=round(wrapper_ms["events"], 4),
            events_peak_scan=json.dumps(peak_scan, separators=(",", ":")),
            events_stages=json.dumps(stages_x85, separators=(",", ":")),
            events_fixed_reads=events_cuda.fixed_reads["events"],
            viterbi_wrapper_ms=round(wrapper_ms["viterbi"], 4))
        say("timing", shapes=shapes, card=card.replace(" ", "_"),
            best_reads_per_s=f"{n_reads / min(walls['device']):.2f}",
            fill_ns_per_band=f"{1e6 * timings['abea_fill'][0] / chain:.1f}",
            walk_ns_per_step=f"{1e6 * timings['abea_walk'][0] / steps:.1f}",
            hmm_ns_per_warp_step=f"{ns_ws:.1f}",
            k6_build_inputs_ms=f"{k6_ms:.4f}", **walk_routes)

        # 6. ultra-long reads through both entry points, windowed (the
        # defaults) and unchunked (budget raised); the main path of the
        # window kernels is the windowed call-methylation run.  The
        # recorded calls are dropped first: they hold device memory.
        del (spy, synth_calls, timed, fill_a, walk_a, hmm_a, ev_a, vit_calls,
             scale_vit, big_scale, vit_a)
        ultra_counts, err_ultra, ultra_timings, ultra_walk = ultra_phase(
            tmp, torch, card, runner, datasets, kernel_mods, reset_counts,
            read_counts)
        timings.update(ultra_timings)

        # 7-9. other pore configurations, the host subcommands' chain and
        # --profile-dir
        err_pores = pores_phase(tmp, torch, card, kernel_mods, reset_counts,
                                read_counts)
        chain_phase(tmp, card, source, truth, reset_counts, read_counts)
        profile_dir_phase(tmp, golden)
        # 10. the mesh over two slots of the card, and two --dist ranks
        parallel_phase(tmp, card, golden, scale)

        walk_extra = {
            "abea_walk": dict(
                phases_ms=walk_routes["walk_tiled_phases_ms"],
                chase_tiles=walk_routes["walk_chase_tiles"],
                warp_ms=walk_routes["walk_warp_ms"],
                warp_launches=counts_all["abea_walk_warp"]),
            "abea_walk_window": dict(
                phases_ms=ultra_walk["walk_phases_ms"],
                chase_tiles=ultra_walk["walk_chase_tiles"],
                warp_ms=ultra_walk["walk_warp_ms"])}
        errs = {name: max(e.get(name, 0) for e in (
            err_golden, err_synth, err_scale, err_golden_win,
            err_synth_win, err_mixed, err_ultra, err_vit, err_big,
            err_vit_scale, k8k9["errors"], k8k9["global_tables"], err_pores))
            for name in KERNELS}
        kernels = []
        for name, (ms, plain_ms, bound_ms, bound_by) in timings.items():
            launches = (ultra_counts if name.endswith("_window")
                        else vit_counts if name == "viterbi"
                        else counts)[name] if name != "abea_ranks" else (
                counts["abea_fill"] + ultra_counts["abea_fill_window"])
            # no PyTorch call computes the ABEA fill, its walk, the k-mer
            # ranks, the HMM forward pass, event detection or the chunk
            # Viterbi: library_ms is null, but for K9 torch.cumsum's
            # prefix sums
            kernels.append(dict(
                name=name, route="cuda", source=KERNELS[name][0],
                replaces=KERNELS[name][1], launches=launches,
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=events_cumsum if name == "events" else None))
            if name == "events":
                kernels[-1]["library_call"] = (
                    "torch.cumsum of the f64 samples and their squares: "
                    "the prefix sums only, not bit for bit the host's "
                    "order")
            if name in wrapper_ms:
                # ms: the kernels alone; wrapper_ms: the whole call
                kernels[-1]["wrapper_ms"] = wrapper_ms[name]
            if name in walk_extra:
                # the tiled walk's phases alone, its serial chain (tiles
                # chased) and the one-warp walk's time on the same launch
                kernels[-1].update(walk_extra[name])
            if name == "events":
                kernels[-1].update(peak_scan)
        kernels += stage_rows(counts["events"], errs["events"])

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
