#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (f5c_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

1. probe: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
2. build: the kernels of f5c_tpu_torch/csrc with nvcc for sm_90a;
3. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card -- ABEA fill and walk bit-identical, HMM forward within
   f5c_tpu_torch/ops/hmm.py's tolerance -- on the golden reads' own
   launches and on synthetic batches (mixed read lengths, windows wider
   than 128 k-mers);
4. golden gate: ``f5c_tpu_torch.cli.main(["call-methylation", ...])`` on
   tests/data/golden: 6 reads processed, 0 deviant rows against meth.exp
   (f5c's tolerance |x - t| <= 0.1|t| + 0.02), every kernel launched;
5. scale run: the golden set replicated to 510 reads (one batch of f5c's
   default -K 512) through the same entry point, twice warm; every copy's
   rows within tolerance of meth.exp; reads/s and stage times; then each
   kernel against its plain version on the launches of that run, timed
   with CUDA events at those shapes.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it fails before printing results.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")
COPIES = 85                 # 85 x 6 golden reads = 510 reads
FLOAT_COLS = (4, 5, 6)      # meth-out-version 1: llr, ll_meth, ll_unmeth
KERNELS = {
    "abea_fill": ("f5c_tpu_torch/csrc/abea.cu", "f5c_tpu/ops/abea_ring.py:69"),
    "abea_walk": ("f5c_tpu_torch/csrc/abea.cu",
                  "f5c_tpu/ops/abea_ring.py:377"),
    "hmm_forward": ("f5c_tpu_torch/csrc/hmm.cu",
                    "f5c_tpu/ops/hmm_pallas.py:57"),
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


def run_cli(paths: dict, out: str):
    """One call-methylation run through the CLI; returns (wall seconds,
    processed reads, stage-seconds line)."""
    from f5c_tpu_torch import cli

    argv = ["call-methylation", "--device", "cuda", "--min-mapq", "0",
            "--meth-out-version", "1", "-b", paths["bam"], "-g",
            paths["genome"], "-r", paths["reads"], "--slow5", paths["slow5"],
            "-o", out]
    with CapturedStderr() as cap:
        t0 = time.time()
        rc = cli.main(argv)
        wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"call-methylation exited {rc}")
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


def compare_launches(spy_calls, torch):
    """Each recorded kernel call re-run through the kernel and the plain
    version on the card.  Returns {name: max_abs_err} (0 = bit-identical;
    ABEA must be, the HMM must be within tolerance)."""
    from f5c_tpu_torch.ops import abea, abea_cuda, hmm, hmm_cuda

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
    for name in ("abea_fill", "abea_walk"):
        if err.get(name, 0) != 0:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err[name]})")
    return err


def _int_err(got, want) -> int:
    e = 0
    for g, w in zip(got, want):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(GOLDEN, "meth.exp")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f5c_tpu_torch import backend, datasets
    from f5c_tpu_torch.ops import _build, abea, abea_cuda, hmm, hmm_cuda
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

    def reset_counts():
        for d in (abea_cuda.launches, hmm_cuda.launches):
            for k in d:
                d[k] = 0

    def read_counts():
        return {**abea_cuda.launches, **hmm_cuda.launches}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the golden set, its signals read from the zlib copy of
        # signals.blow5 (no zstandard module needed)
        source = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        golden = datasets.copy_dataset(source, os.path.join(tmp, "golden"))
        truth = os.path.join(GOLDEN, "meth.exp")

        # 3. kernel vs plain: the golden reads' own launches + synthetic
        spy = Spy([abea_cuda, hmm_cuda])
        try:
            run_cli(golden, os.path.join(tmp, "warmup.tsv"))
        finally:
            spy.close()
        err_golden = compare_launches(spy.calls, torch)
        err_synth = compare_launches(synthetic_calls(torch, dev), torch)
        torch.cuda.synchronize()
        say("kernel_vs_plain", golden=err_golden, synthetic=err_synth)

        # 4. golden gate through the kernels
        reset_counts()
        wall, processed, stages = run_cli(golden,
                                          os.path.join(tmp, "golden.tsv"))
        counts = read_counts()
        bad = deviant_rows(os.path.join(tmp, "golden.tsv"), truth)
        say("golden", processed=processed, deviant_rows=bad,
            launches=counts, wall_s=f"{wall:.3f}")
        if processed != 6 or bad != 0 or min(counts.values()) == 0:
            raise AssertionError("golden gate failed")

        # 5. scale run: 510 reads, twice warm, the second one recorded
        scale = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                           COPIES)
        n_reads = 6 * COPIES
        walls = []
        for rep in range(2):
            out = os.path.join(tmp, f"scale{rep}.tsv")
            reset_counts()
            spy = Spy([abea_cuda, hmm_cuda]) if rep == 1 else None
            try:
                wall, processed, stages = run_cli(scale, out)
            finally:
                if spy is not None:
                    spy.close()
            counts = read_counts()
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

        # kernel and plain times at the scale run's first (largest) launch
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
        kernels = []
        for name, (kern, plain) in timed.items():
            ms, plain_ms = time_ms(torch, kern, 20), time_ms(torch, plain, 2)
            errs = [e.get(name, 0) for e in (err_golden, err_synth,
                                             err_scale)]
            kernels.append(dict(
                name=name, route="cuda", source=KERNELS[name][0],
                replaces=KERNELS[name][1], launches=counts[name],
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))
        say("timing", shapes=shapes, card=card.replace(" ", "_"),
            best_reads_per_s=f"{n_reads / min(walls):.2f}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
