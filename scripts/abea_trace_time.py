#!/usr/bin/env python3
"""The ABEA trace at 2 bits a cell against a parent tree whose fills wrote
one byte a cell, on one card.

    mkdir -p ab/parent && git archive <parent> | tar -x -C ab/parent
    python3 scripts/abea_trace_time.py ab/parent [DIR ...] [--out DIR]
        [--no-ultra]

The parent's ``abea.cu`` and ``abea_ultra.cu`` (K1, K4, K3, K10; the same
C interface) are built with nvcc and the flags of ``ops/_build.py`` into
a library of their own under ``build/abea_trace_time/``; this tree's come
from ``_build.library()``.  Each DIR holds variants of this tree's
``abea.cu``, ``abea_ultra.cu``, ``abea_band.cuh`` and ``abea_walk.cuh``
(the same C interface and packed trace), built the same way and timed
beside them.  The launches are the main path's, recorded
from this tree's CLI: the first K1 and K4 launch of golden x85
call-methylation (510 reads, host events) and, from ultra x4
call-methylation with the budget lowered so that every read is windowed
(``chip_smoke.ultra_budget``), K3's forward launch, the re-fill of a
window that every read fills, and K10's walk of that window.  For each:

- the parent's kernels run on the parent's one-byte trace, this tree's
  on the packed one; the fills are held bit for bit (the parent's trace
  through ``ops/abea.py`` ``pack_trace``), and so are the walks'
  outputs;
- all are timed in turns (parent, change, variants, then the reverse
  order; CUDA-event
  means of 20 launches, 3 for K3 and K10) straight through ctypes, with
  no wrapper work.

Then (unless ``--no-ultra``) ultra x4 call-methylation and eventalign
--summary at each tree's
default budget (host events: the parent windows every read, this tree
none), each tree in a fresh process, in turns parent, change, change,
parent: the walls of 3 warm runs, the peak device memory above what was
held before the last of them, and the card's busy time of one run under
torch.profiler, with the window kernels' launches.  Prints a line per
measurement and the card's name and power limit; writes all of it as
JSON to ``OUT/trace.json`` (default ``build/abea_trace_time``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the Spy, the CLI runner, the card line)
from abea_fusion_time import (fill_smem_of, ptrs,  # noqa: E402
                              record_launches,
                              time_turns)

ENTRIES = ("f5c_abea_fill", "f5c_abea_walk", "f5c_abea_fill_window",
           "f5c_abea_walk_window")
# the parent's walk staged one-byte rows: 2 tiles of 128 x (128 + 4) B
PARENT_WALK_SMEM = 2 * 128 * (128 + 4)
PARENT_ROW = 128
ULTRA_KERNELS = ("abea_fill_kernel", "abea_walk_kernel",
                 "abea_fill_window_kernel", "abea_walk_window_kernel")


def build_abea(csrc: str, tag: str) -> ctypes.CDLL:
    """``csrc``'s abea.cu and abea_ultra.cu in a library of their own."""
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "abea_trace_time")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{tag}_abea.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    so, os.path.join(csrc, "abea.cu"),
                    os.path.join(csrc, "abea_ultra.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.fill_smem = fill_smem_of(csrc)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


class Tree:
    """One tree's four kernels through ctypes, with its trace row width
    and its walk's shared memory."""

    def __init__(self, lib, row: int, walk_smem: int):
        from f5c_tpu_torch.ops import abea

        self.lib, self.row, self.walk_smem = lib, row, walk_smem
        self.fill_smem = getattr(lib, "fill_smem", abea.fill_smem_bytes())

    def fill(self, torch, args):
        """K1 on the recorded abea_fill arguments; (trace, llk, start_e)."""
        (ev_pool, ev_off, ev_len, seq, seq_off, rk_len, k, lm, ls, lls,
         params, band_off, n_bands) = args
        dev, B = ev_pool.device, ev_len.shape[0]
        out = (torch.empty((n_bands, self.row), dtype=torch.uint8,
                           device=dev),
               torch.empty(n_bands, dtype=torch.int32, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev))

        def run():
            _check(self.lib.f5c_abea_fill(
                *ptrs(ev_pool, ev_off, ev_len, seq, seq_off, rk_len, lm, ls,
                      lls, params, band_off, *out), k, lm.shape[0], B,
                self.fill_smem, torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def walk(self, torch, trace, llk, args):
        """K4 over ``trace``/``llk`` with the recorded abea_walk
        arguments' other inputs; (flat, n)."""
        _, _, band_off, start_e, rk_len, byte_off, n_bytes = args
        dev, B = trace.device, start_e.shape[0]
        out = (torch.zeros(n_bytes, dtype=torch.uint8, device=dev),
               torch.empty(B, dtype=torch.int32, device=dev))

        def run():
            _check(self.lib.f5c_abea_walk(
                *ptrs(trace, llk, band_off, start_e, rk_len, byte_off, *out),
                B, self.walk_smem, torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def fill_window(self, torch, args):
        """K3 on the recorded abea_fill_window arguments; (states, trace
        or None, llk or None)."""
        (ev_pool, ev_off, ev_len, seq, seq_off, rk_len, k, lm, ls, lls,
         params, band_off, state, base, win, n_win, with_trace) = args
        from f5c_tpu_torch.ops.abea_ultra import STATE_WORDS

        dev, B = ev_pool.device, ev_len.shape[0]
        out = [torch.empty((B, n_win, STATE_WORDS), device=dev), None, None]
        if with_trace:
            out[1] = torch.empty((B, n_win * win, self.row),
                                 dtype=torch.uint8, device=dev)
            out[2] = torch.empty((B, n_win * win), dtype=torch.int32,
                                 device=dev)

        def run():
            _check(self.lib.f5c_abea_fill_window(
                *ptrs(ev_pool, ev_off, ev_len, seq, seq_off, rk_len, lm, ls,
                      lls, params, band_off, state, *out), k, lm.shape[0], B,
                base, win, n_win, self.fill_smem,
                torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def walk_window(self, torch, trace, llk, args):
        """K10 over ``trace``/``llk`` from the recorded abea_walk_window
        arguments' (k, e, n) and output, both copied afresh each launch;
        (kst, flat)."""
        _, _, base, kst0, flat0, byte_off = args
        B = kst0.shape[0]
        out = (torch.empty_like(kst0), torch.empty_like(flat0))

        def run():
            out[0].copy_(kst0)
            out[1].copy_(flat0)
            _check(self.lib.f5c_abea_walk_window(
                *ptrs(trace, llk, out[0], byte_off, out[1]), base,
                trace.shape[1], B, self.walk_smem,
                torch.cuda.current_stream().cuda_stream))
            return out
        return run


def _same(torch, got, want) -> bool:
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all((g is None and w is None) or torch.equal(bits(g), bits(w))
               for g, w in zip(got, want))


def measure_pair(torch, trees, tag, fill_args, walk_args, window, reps):
    """One fill launch and the walk over its trace, held between the
    trees and timed in turns.  Returns the record printed."""
    from f5c_tpu_torch.ops.abea import pack_trace

    fills, walks, outs = {}, {}, {}
    for name, tree in trees.items():
        fills[name] = (tree.fill_window if window else tree.fill)(
            torch, fill_args)
        outs[name] = fills[name]()
    torch.cuda.synchronize()
    p = outs["parent"]
    tr = 1 if window else 0        # the trace's place in the outputs
    packed_parent = list(p)
    if p[tr] is not None:
        packed_parent[tr] = pack_trace(p[tr])
    for name, o in outs.items():
        if name != "parent" and not _same(torch, o, packed_parent):
            raise AssertionError(f"{tag}: the {name} fill differs")
    res = dict(tag=tag, reads=int(fill_args[2].shape[0]),
               trace_bytes={n: int(o[tr].numel()) if o[tr] is not None
                            else 0 for n, o in outs.items()})
    res["fill_ms"] = time_turns(torch, fills, reps)
    if walk_args is not None:
        for name, tree in trees.items():
            o = outs[name]
            trace, llk = (o[1], o[2]) if window else (o[0], o[1])
            walks[name] = (tree.walk_window if window else tree.walk)(
                torch, trace, llk, walk_args)
        w = {name: [x.clone() for x in fn()] for name, fn in walks.items()}
        torch.cuda.synchronize()
        for name, o in w.items():
            if not _same(torch, o, w["parent"]):
                raise AssertionError(f"{tag}: the {name} walk differs")
        res["walk_ms"] = time_turns(torch, walks, reps)
        res["walk_steps"] = int(
            (w["change"][0][:, 2] - walk_args[3][:, 2]).sum() if window
            else w["change"][1].long().sum())
    chip_smoke.say("trace_launch", bit_identical=True,
                   **{k: json.dumps(v, separators=(",", ":"))
                      if isinstance(v, (dict, list)) else v
                      for k, v in res.items()})
    return res


def ultra_run(tree: str, data_json: str, out_json: str) -> int:
    """In a fresh process whose first path is ``tree``: ultra x4
    call-methylation and eventalign at that tree's defaults (host
    events): walls, peak, busy, window launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from f5c_tpu_torch.ops import abea_cuda, abea_ultra_cuda

    with open(data_json) as f:
        data, tmp = json.load(f)
    res = {}
    for entry in ("meth", "eventalign"):
        out = os.path.join(tmp, f"{os.getpid()}_{entry}.tsv")
        summary = out + ".summary" if entry == "eventalign" else None

        def run():
            return chip_smoke.run_cli(data, out, summary,
                                      extra=("--events-engine", "host"))

        run()
        walls = []
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            for d in (abea_cuda.launches, abea_ultra_cuda.launches):
                for k in d:
                    d[k] = 0
            walls.append(run()[0])
        peak = torch.cuda.max_memory_allocated() - held
        launches = {**abea_cuda.launches, **abea_ultra_cuda.launches}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()[0]
        busy, per = chip_smoke.device_busy(torch, prof, top=10)
        res[entry] = dict(walls_s=walls, peak_mb=peak / 2**20,
                          held_mb=held / 2**20, launches=launches,
                          profiled_wall_s=wall, busy_ms=busy,
                          kernels={k: v for k, v in per.items()
                                   if k in ULTRA_KERNELS})
    with open(out_json, "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("variants", nargs="*", metavar="DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "abea_trace_time"))
    ap.add_argument("--no-ultra", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("abea_trace_time: no CUDA device", file=sys.stderr)
        return 1
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.ops import _build, abea
    from f5c_tpu_torch.pipeline import runner

    parent = os.path.abspath(a.parent)
    card = chip_smoke.card_line()
    print(card, flush=True)
    trees = {"parent": Tree(build_abea(os.path.join(
                 parent, "f5c_tpu_torch", "csrc"), "parent"), PARENT_ROW,
                 PARENT_WALK_SMEM),
             "change": Tree(_build.library(), abea.TRACE_ROW_BYTES,
                            abea.walk_smem_bytes())}
    for d in a.variants:
        tag = os.path.basename(os.path.normpath(d))
        trees[tag] = Tree(build_abea(d, tag), abea.TRACE_ROW_BYTES,
                          abea.walk_smem_bytes())
    result = {"card": card, "launches": [], "ultra": []}
    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        source = datasets.dataset(chip_smoke.GOLDEN,
                                  slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        x85 = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                         chip_smoke.COPIES)
        ultra = datasets.ultra_dataset(os.path.join(tmp, "ultra"),
                                       seed=2026)
        calls = record_launches(torch, x85, os.path.join(tmp, "rec.tsv"))
        result["launches"].append(measure_pair(
            torch, trees, "golden_x85_first", calls["abea_fill"][0][0],
            calls["abea_walk"][0][0], False, 20))
        del calls
        calls = record_launches(
            torch, ultra, os.path.join(tmp, "urec.tsv"),
            budget=chip_smoke.ultra_budget(runner, datasets))
        win_calls = calls["abea_fill_window"]
        nb = int(win_calls[0][0][11].diff().min())
        full = next(c for c, _ in win_calls[1:]
                    if c[13] + c[14] <= nb)        # a window every read fills
        walk = next(c for c, _ in calls["abea_walk_window"]
                    if c[2] == full[13])
        result["launches"].append(measure_pair(
            torch, trees, "ultra_x4_k3_forward", win_calls[0][0], None,
            True, 3))
        result["launches"].append(measure_pair(
            torch, trees, "ultra_x4_full_window", full, walk, True, 3))
        del calls, win_calls, full, walk
        torch.cuda.empty_cache()
        data_json = os.path.join(tmp, "ultra.json")
        with open(data_json, "w") as f:
            json.dump([ultra, tmp], f)
        turns = () if a.no_ultra else ((parent, "parent"), (ROOT, "change"),
                                        (ROOT, "change"), (parent, "parent"))
        for i, (tree, tag) in enumerate(turns):
            out_json = os.path.join(tmp, f"ultra_{i}.json")
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            env["PYTHONPATH"] = tree
            t0 = time.time()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ultra-run", tree, data_json, out_json],
                           cwd=tree, env=env, check=True)
            with open(out_json) as f:
                res = json.load(f)
            result["ultra"].append(dict(tree=tag, turn=i, **res))
            for entry, r in res.items():
                chip_smoke.say(
                    "trace_ultra", tree=tag, turn=i, entry=entry,
                    walls_s=",".join(f"{w:.3f}" for w in r["walls_s"]),
                    peak_mb=f"{r['peak_mb']:.1f}",
                    held_mb=f"{r['held_mb']:.1f}",
                    busy_ms=f"{r['busy_ms']:.1f}",
                    profiled_wall_s=f"{r['profiled_wall_s']:.3f}",
                    launches=json.dumps(r["launches"],
                                        separators=(",", ":")),
                    kernels=json.dumps(r["kernels"], separators=(",", ":")),
                    process_s=f"{time.time() - t0:.1f}",
                    card=card.replace(" ", "_"))
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "trace.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ultra-run"]:
        sys.path.insert(0, sys.argv[2])
        sys.exit(ultra_run(*sys.argv[2:5]))
    sys.exit(main())
