#!/usr/bin/env python3
"""K11 fused into the ABEA fills, against a parent tree whose runner
ranked the packed sequences with torch ops before K1 and K3, on one card.

    mkdir -p ab/parent && git archive <parent> | tar -x -C ab/parent
    python3 scripts/abea_fusion_time.py ab/parent [DIR ...]
        [--out DIR] [--no-traces]

The parent's fill kernels (``PARENT/f5c_tpu_torch/csrc/abea.cu`` and
``abea_ultra.cu``, which read an i32 rank slab) are built with nvcc and
the flags of ``ops/_build.py`` into a library of their own under
``build/abea_fusion_time/``; this tree's come from ``_build.library()``.
Each DIR holds variants of this tree's ``abea.cu``, ``abea_ultra.cu``,
``abea_band.cuh`` and ``abea_walk.cuh`` (the same C interface), built
the same way and timed beside them.
The launches are the main path's, recorded from this tree's CLI: every
K1 launch of golden x85 call-methylation (510 reads, host events) and,
for K3, the forward launch and the full window of ultra x4
call-methylation (``datasets.ultra_dataset(seed=2026)``) with the trace
budget lowered so that every read is windowed
(``chip_smoke.ultra_budget``).  For each:

- every fill is held to the parent's bit for bit, then all are timed in
  turns (parent, change, variants, then the reverse order; CUDA-event
  means of 20 launches, 3 for K3) straight through ctypes, with no
  wrapper work;
- the parent's rank chain (the parent's ``seq_ranks.ranks_from_packed``
  on the launch's packed sequences, as its ``_launch_abea`` ran it) is
  timed the same way and its kernel launches counted with
  torch.profiler; the probe ``abea_cuda.abea_ranks`` is timed beside it.

Then (unless ``--no-traces``) one golden x85 and one ultra x4 windowed
(``F5C_TPU_TRACE_BYTES`` lowered the same way) call-methylation run
under
``--profile-dir`` from each tree (each a fresh process, this tree then
the parent): the kernel launches and device time by name in each trace,
and what the parent's runs launched that this tree's did not.  Prints a
line per measurement and the card's name and power limit; writes all of
it as JSON to ``OUT/fusion.json`` (default ``build/abea_fusion_time``).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the Spy, the CLI runner, the card line)

_vp, _int = ctypes.c_void_p, ctypes.c_int
PARENT_FILL = [_vp] * 14 + [_int] * 3 + [_vp]
PARENT_FILL_WINDOW = [_vp] * 15 + [_int] * 6 + [_vp]
TRACE_KERNELS = ("abea_fill_kernel", "abea_fill_window_kernel",
                 "abea_walk_kernel", "abea_walk_window_kernel",
                 "hmm_forward_meta_kernel")


def fill_smem_of(csrc: str) -> int:
    """The fill kernels' dynamic shared memory in the tree of ``csrc``
    (its abea_band.cuh's FILL_SMEM: the kernels refuse any other size)."""
    import re

    with open(os.path.join(csrc, "abea_band.cuh")) as f:
        text = f.read()
    consts = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+)\s*=\s*([^;,]+)[;,]", text)}
    names = {k: int(v) for k, v in consts.items() if v.strip().isdigit()}
    return int(eval(consts["FILL_SMEM"], {}, names))


def build_fills(csrc: str, tag: str, signatures) -> ctypes.CDLL:
    """``csrc``'s abea.cu and abea_ultra.cu in a library of their own,
    its two fill entry points bound with ``signatures``."""
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "abea_fusion_time")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{tag}_abea.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    so, os.path.join(csrc, "abea.cu"),
                    os.path.join(csrc, "abea_ultra.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.fill_smem = fill_smem_of(csrc)
    for name, argtypes in zip(("f5c_abea_fill", "f5c_abea_fill_window"),
                              signatures):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def parent_ranker(parent: str):
    """The parent tree's ranks_from_packed (its K11 torch ops)."""
    path = os.path.join(parent, "f5c_tpu_torch", "ops", "seq_ranks.py")
    spec = importlib.util.spec_from_file_location("parent_seq_ranks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ranks_from_packed


def ptrs(*tensors):
    return [t.data_ptr() if t is not None else None for t in tensors]


def fills(torch, libs: dict, args, window: bool, rk):
    """{tag: closure} launching one fill each on the recorded wrapper
    arguments ``args``: the "parent" library's on ``rk``, the parent's
    ranks of the packed sequences, every other one on the sequences.  The
    parent wrote one trace byte a cell, the others the packed rows
    (``abea.TRACE_ROW_BYTES`` a band)."""
    from f5c_tpu_torch.ops import abea
    from f5c_tpu_torch.ops.abea_ultra import STATE_WORDS

    ev_pool, ev_off, ev_len, seq, seq_off, rk_len, k, lm, ls, lls, params, \
        band_off = args[:12]
    B, dev = ev_len.shape[0], ev_pool.device
    stream = torch.cuda.current_stream().cuda_stream
    if window:
        state, base, win, n_win, trace = args[12:17]
        shape = (B, n_win * win)
    else:
        n_bands = args[12]

    def outputs(row):
        if window:
            return [torch.empty((B, n_win, STATE_WORDS), device=dev)] + (
                [torch.empty((*shape, row), dtype=torch.uint8, device=dev),
                 torch.empty(shape, dtype=torch.int32, device=dev)]
                if trace else [None, None])
        return [torch.empty((n_bands, row), dtype=torch.uint8, device=dev),
                torch.empty(n_bands, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev)]

    def launch(fn, seq_arg, k_args, o, smem):
        head = ptrs(ev_pool, ev_off, ev_len, seq_arg, seq_off, rk_len, lm,
                    ls, lls, params, band_off)
        if window:
            err = fn(*head, *ptrs(state, *o), *k_args, lm.shape[0], B, base,
                     win, n_win, smem, stream)
        else:
            err = fn(*head, *ptrs(*o), *k_args, lm.shape[0], B, smem, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o

    name = "f5c_abea_fill_window" if window else "f5c_abea_fill"
    closures = {}
    for tag, lib in libs.items():
        o = outputs(abea.PAD if tag == "parent" else abea.TRACE_ROW_BYTES)
        smem = getattr(lib, "fill_smem", abea.fill_smem_bytes())
        closures[tag] = (lambda f=getattr(lib, name), o=o, m=smem:
                         launch(f, rk, [], o, m)) if tag == "parent" else (
            lambda f=getattr(lib, name), o=o, m=smem:
            launch(f, seq, [k], o, m))
    return closures


def time_turns(torch, fns: dict, reps: int) -> dict:
    """{tag: [mean ms, mean ms]} of each closure, in turns A B .. B A
    (first launches warm up)."""
    for fn in fns.values():
        fn()
    times = {tag: [] for tag in fns}
    order = list(fns) + list(fns)[::-1]
    for tag in order:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fns[tag]()
        b.record()
        b.synchronize()
        times[tag].append(a.elapsed_time(b) / reps)
    return times


def count_kernels(torch, fn) -> tuple[int, float]:
    """(kernel launches, their device ms) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "memcpy" not in e.name.lower()
           and "memset" not in e.name.lower()]
    return len(evs), sum(e.time_range.end - e.time_range.start
                         for e in evs) / 1e3


def measure_launch(torch, libs, rank, tag, args, window, reps):
    from f5c_tpu_torch.ops import abea_cuda
    from f5c_tpu_torch.ops.abea import pack_trace

    seq, seq_off, rk_len, k = args[3:7]
    rk = rank(seq, k)
    fns = fills(torch, libs, args, window, rk)
    want = list(fns["parent"]())
    t = 1 if window else 0          # the trace, packed as the others' is
    if want[t] is not None:
        want[t] = pack_trace(want[t])
    for name, fn in fns.items():
        if name == "parent":
            continue
        got = fn()
        torch.cuda.synchronize()
        if not all((g is None and w is None) or torch.equal(
                g.view(torch.int32) if g.dtype == torch.float32 else g,
                w.view(torch.int32) if w.dtype == torch.float32 else w)
                for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: the {name} fill differs from the "
                                 "parent's")
    fill = time_turns(torch, fns, reps)
    chain = time_turns(torch, {"chain": lambda: rank(seq, k),
                               "probe": lambda: abea_cuda.abea_ranks(
                                   seq, seq_off, rk_len, k)}, 20)
    n_chain, chain_dev_ms = count_kernels(torch, lambda: rank(seq, k))
    n_probe, _ = count_kernels(torch, lambda: abea_cuda.abea_ranks(
        seq, seq_off, rk_len, k))
    res = dict(tag=tag, reads=int(args[2].shape[0]), k=int(k),
               bases=4 * int(seq.shape[0]), bit_identical=True,
               **{f"{name}_fill_ms": ms for name, ms in fill.items()},
               chain_ms=chain["chain"], chain_launches=n_chain,
               chain_device_ms=chain_dev_ms, probe_ms=chain["probe"],
               probe_launches=n_probe)
    chip_smoke.say("fusion_launch", **{k_: (json.dumps(v) if isinstance(
        v, list) else v) for k_, v in res.items()})
    return res


def record_launches(torch, data, out, extra=(), budget=None):
    """The ABEA calls of one call-methylation run of this tree's CLI (with
    ``budget`` as the trace budget)."""
    from f5c_tpu_torch.ops import abea_cuda, abea_ultra_cuda
    from f5c_tpu_torch.pipeline import runner

    saved = runner.Pipeline.TRACE_BYTES_BUDGET
    if budget is not None:
        runner.Pipeline.TRACE_BYTES_BUDGET = budget
    spy = chip_smoke.Spy([abea_cuda, abea_ultra_cuda])
    try:
        chip_smoke.run_cli(data, out, extra=extra)
    finally:
        spy.close()
        runner.Pipeline.TRACE_BYTES_BUDGET = saved
    return spy.calls


def trace_run(tree: str, data: dict, tmp: str, tag: str,
              budget=None) -> dict:
    """One call-methylation --profile-dir run of ``tree`` in a fresh
    process (with ``budget`` as F5C_TPU_TRACE_BYTES); its wall and
    {kernel name: [launches, device ms]} from its trace."""
    prof = os.path.join(tmp, f"prof_{tag}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = tree
    if budget is not None:
        env["F5C_TPU_TRACE_BYTES"] = str(budget)
    argv = ["call-methylation", "--meth-out-version", "1",
            *chip_smoke.data_argv(data, os.path.join(tmp, f"{tag}.tsv")),
            "--profile-dir", prof]
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "f5c_tpu_torch.cli", *argv],
                   cwd=tree, env=env, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    wall = time.time() - t0
    [path] = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    per = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        name = ev["name"].replace("(anonymous namespace)::", "")
        name = re.split(r"[(<]", name.removeprefix("void "), maxsplit=1)[0]
        d = per.setdefault(name.strip() or ev["name"], [0, 0.0])
        d[0] += 1
        d[1] += ev.get("dur", 0) / 1e3
    return dict(wall_s=wall, kernels=per)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("variants", nargs="*", metavar="DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "abea_fusion_time"))
    ap.add_argument("--no-traces", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("abea_fusion_time: no CUDA device", file=sys.stderr)
        return 1
    from f5c_tpu_torch import datasets
    from f5c_tpu_torch.ops import _build
    from f5c_tpu_torch.pipeline import runner

    parent = os.path.abspath(a.parent)
    card = chip_smoke.card_line()
    print(card, flush=True)
    sigs = [_build._SIGNATURES[n] for n in ("f5c_abea_fill",
                                             "f5c_abea_fill_window")]
    libs = {"parent": build_fills(os.path.join(parent, "f5c_tpu_torch",
                                               "csrc"), "parent",
                                  (PARENT_FILL, PARENT_FILL_WINDOW)),
            "change": _build.library()}
    for d in a.variants:
        tag = os.path.basename(os.path.normpath(d))
        libs[tag] = build_fills(d, tag, sigs)
    rank = parent_ranker(parent)
    result = {"card": card, "launches": [], "traces": {}}
    with tempfile.TemporaryDirectory(prefix="fusion_") as tmp:
        source = datasets.dataset(chip_smoke.GOLDEN,
                                  slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        x85 = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                         chip_smoke.COPIES)
        ultra = datasets.ultra_dataset(os.path.join(tmp, "ultra"),
                                       seed=2026)
        calls = record_launches(torch, x85, os.path.join(tmp, "rec.tsv"))
        for i, (args, _) in enumerate(calls["abea_fill"]):
            result["launches"].append(measure_launch(
                torch, libs, rank, f"golden_x85_k1_{i}", args, False, 20))
        del calls
        # every ultra read windowed (at the defaults they run unchunked)
        budget = chip_smoke.ultra_budget(runner, datasets)
        calls = record_launches(torch, ultra, os.path.join(tmp, "urec.tsv"),
                                budget=budget)
        win_calls = calls["abea_fill_window"]
        nb = int(win_calls[0][0][11].diff().min())
        full = next(c for c, _ in win_calls[1:]
                    if c[13] + c[14] <= nb)        # a window every read fills
        for tag, args in (("ultra_x4_k3_forward", win_calls[0][0]),
                          ("ultra_x4_k3_full_window", full)):
            result["launches"].append(measure_launch(
                torch, libs, rank, tag, args, True, 3))
        del calls, win_calls, full
        torch.cuda.empty_cache()
        for name, data, b in (() if a.no_traces else
                              (("golden_x85", x85, None),
                               ("ultra_x4", ultra, budget))):
            runs = {}
            for tree, tree_tag in ((ROOT, "change"), (parent, "parent")):
                runs[tree_tag] = trace_run(tree, data, tmp,
                                           f"{name}_{tree_tag}", b)
            lost = {}
            for k, (n, ms) in runs["parent"]["kernels"].items():
                n_c, ms_c = runs["change"]["kernels"].get(k, (0, 0.0))
                if n != n_c:
                    lost[k] = [n - n_c, round(ms - ms_c, 4)]
            result["traces"][name] = dict(runs, parent_only=lost)
            chip_smoke.say(
                "fusion_trace", run=name,
                wall_s={t: round(r["wall_s"], 3) for t, r in runs.items()},
                kernel_launches={t: sum(n for n, _ in r["kernels"].values())
                                 for t, r in runs.items()},
                fills={t: {k: r["kernels"].get(k) for k in TRACE_KERNELS
                           if k in r["kernels"]} for t, r in runs.items()},
                parent_only=json.dumps(lost, separators=(",", ":")),
                card=card.replace(" ", "_"))
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "fusion.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
