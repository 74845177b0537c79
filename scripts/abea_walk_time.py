#!/usr/bin/env python3
"""The tile-parallel ABEA walk and the fill's band step against a parent
tree's one-warp walk and fill, on one card.

    mkdir -p ab/parent && git archive <parent> | tar -x -C ab/parent
    python3 scripts/abea_walk_time.py ab/parent [--tiled DIR ...]
        [--fill DIR ...] [--out DIR] [--no-ultra] [--fills-only]

The parent's ``abea.cu`` and ``abea_ultra.cu`` (K1, K4, K3, K10 with the
2-bit trace: the parent's K4 C interface takes no read list) are built
with nvcc and the flags of ``ops/_build.py`` into a library of their own
under ``build/abea_walk_time/``; this tree's come from
``_build.library()``.  The launches are the main path's, recorded from
this tree's CLI (call-methylation, host events): golden x85's first K1
and K4 launch (510 reads), ultra x4's unchunked launch of the longest
chain at the default budget (ul300's solo launch, 811,435 bands), and,
with the budget
lowered so that every ultra read is windowed
(``chip_smoke.ultra_budget``), K3's forward launch, the re-fill of a
window every read fills and K10's walk of that window; and the fill and
walk of ``chip_smoke.mixed_long_short``'s batch (a 54,002-band read
among 40 short ones).  For each launch:

- the fills, parent and change, held bit for bit and timed in turns
  (CUDA-event means of 20 launches, 3 at ultra size), with ns a band of
  the longest chain and the reads whose bands took __fdiv_rn in this
  tree's fill (``guarded_reads``, the kernels' route report; the rest
  took the fast quotient);
- the walks, held bit for bit: the parent's one-warp kernel, this
  tree's one-warp kernel and tiled walk (all reads each), timed in
  turns straight through ctypes with no wrapper work; the tiled walk's
  three phases timed alone too (maps, chase, emission; a window's with
  the copy of its carried (k, e, n) and output, as its whole walk), its
  serial chain (tiles chased) printed.  Each ``--tiled DIR`` holds a variant of
  this tree's ``abea_walk_tiled.cu`` (the same C interface), built with
  this tree's headers and timed beside it as ``tiled_<DIR's name>``;
  each ``--fill DIR`` a variant of this tree's ``abea.cu``,
  ``abea_ultra.cu`` and their headers (built with that directory's
  headers and launched with its FILL_SMEM), whose fills are held bit for
  bit and timed beside the others as ``fill_<DIR's name>``.  The
  registers and spills of every tree's three fill instances (nvcc's
  ``-Xptxas -v``) are printed first.  ``--fills-only`` times the fills
  alone (no walk, no crossover).

Then the crossover: single reads of 256 to 65,536 bands, each walked
alone by the one-warp kernel and by the tiled walk in turns, and golden
x85's and the mixed batch's walks by each route (one-warp, tiled, the
crossover's mix: ``abea_cuda.TILED_MIN_BANDS``).

Then (unless ``--no-ultra``) ultra x4 call-methylation and eventalign
--summary at the default budget (unchunked) and with the budget lowered
(windowed), host events, each tree in a fresh process, in turns parent,
change, change, parent: the walls of 3 warm runs and the card's busy time
of one run under torch.profiler, with the ABEA kernels' times; every
output (the TSV, and eventalign's summary) byte for byte the same in
every tree, turn and configuration (sha256).  Prints a
line per measurement and the card's name and power limit; writes all of
it as JSON to ``OUT/walk.json`` (default ``build/abea_walk_time``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
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
                              record_launches, time_turns)

_vp, _int = ctypes.c_void_p, ctypes.c_int
# the parent's C entry points (its walk takes no read list)
PARENT_SIGNATURES = {
    "f5c_abea_fill": [_vp] * 14 + [_int] * 4 + [_vp],
    "f5c_abea_walk": [_vp] * 8 + [_int] * 2 + [_vp],
    "f5c_abea_fill_window": [_vp] * 15 + [_int] * 7 + [_vp],
    "f5c_abea_walk_window": [_vp] * 5 + [_int] * 4 + [_vp],
}
ABEA_KERNELS = ("abea_fill_kernel", "abea_walk_kernel",
                "abea_fill_window_kernel", "abea_walk_window_kernel",
                "walk_maps_kernel", "walk_chase_kernel", "walk_emit_kernel")
SINGLE_BANDS = (256, 384, 512, 768, 1024, 2048, 4096, 16384, 65536)


def build_parent(csrc: str, tag: str = "parent") -> ctypes.CDLL:
    """``csrc``'s abea.cu and abea_ultra.cu in a library of their own
    (their fills: the parent's C interface)."""
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "abea_walk_time")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{tag}_abea.so")
    built = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-shared", "-o", so,
                            os.path.join(csrc, "abea.cu"),
                            os.path.join(csrc, "abea_ultra.cu")],
                           check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.fill_smem = fill_smem_of(csrc)
    lib.ptxas = chip_smoke.fill_ptxas(built.stdout + built.stderr)
    for name, argtypes in PARENT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_tiled(d: str, tag: str) -> ctypes.CDLL:
    """A variant ``abea_walk_tiled.cu`` of ``d``, built with this tree's
    headers into a library of its own."""
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "abea_walk_time")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"libtiled_{tag}.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-shared", "-o", so,
                    os.path.join(d, "abea_walk_tiled.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.f5c_abea_walk_tiled.argtypes = _build._SIGNATURES[
        "f5c_abea_walk_tiled"]
    lib.f5c_abea_walk_tiled.restype = ctypes.c_int
    return lib


def _check(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def _stream(torch) -> int:
    return torch.cuda.current_stream().cuda_stream


def fill_fn(torch, lib, args, window: bool):
    """One fill launch (K1, or K3 with ``window``) of ``lib`` on the
    recorded wrapper arguments; the closure returns its outputs."""
    from f5c_tpu_torch.ops import abea
    from f5c_tpu_torch.ops.abea_ultra import STATE_WORDS

    ev_pool, ev_off, ev_len, seq, seq_off, rk_len, k, lm, ls, lls, params, \
        band_off = args[:12]
    dev, B = ev_pool.device, ev_len.shape[0]
    smem = lib.fill_smem
    row = abea.TRACE_ROW_BYTES
    if window:
        state, base, win, n_win, with_trace = args[12:17]
        out = [torch.empty((B, n_win, STATE_WORDS), device=dev), None, None]
        if with_trace:
            out[1] = torch.empty((B, n_win * win, row), dtype=torch.uint8,
                                 device=dev)
            out[2] = torch.empty((B, n_win * win), dtype=torch.int32,
                                 device=dev)

        def run():
            _check(lib.f5c_abea_fill_window(
                *ptrs(ev_pool, ev_off, ev_len, seq, seq_off, rk_len, lm, ls,
                      lls, params, band_off, state, *out), k, lm.shape[0], B,
                base, win, n_win, smem, _stream(torch)))
            return out
        return run
    n_bands = args[12]
    out = (torch.empty((n_bands, row), dtype=torch.uint8, device=dev),
           torch.empty(n_bands, dtype=torch.int32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))

    def run():
        _check(lib.f5c_abea_fill(
            *ptrs(ev_pool, ev_off, ev_len, seq, seq_off, rk_len, lm, ls, lls,
                  params, band_off, *out), k, lm.shape[0], B, smem,
            _stream(torch)))
        return out
    return run


class Tiled:
    """This tree's tiled walk of every read of one launch through ctypes,
    its scratch allocated once; ``run(phases)`` launches some phases."""

    def __init__(self, torch, lib, trace, llk, byte_off, out, bands=None,
                 band_off=None, start_e=None, rk_len=None, n_out=None,
                 kst=None, base=0, win=0):
        import numpy as np

        from f5c_tpu_torch.ops import abea
        from f5c_tpu_torch.ops.abea import MAP_ENTRIES, WALK_TILE

        dev = trace.device
        if bands is None:          # a window: every read, win rows each
            B = kst.shape[0]
            bands = np.full(B, win, np.int64)
            self.reads = None
        else:
            self.reads = torch.arange(len(bands), dtype=torch.int32,
                                      device=dev)
        tiles = abea.walk_tiles_of(np.asarray(bands, np.int64), WALK_TILE)
        off = np.zeros(len(bands) + 1, np.int32)
        np.cumsum(tiles, out=off[1:])
        self.n_tiles = int(off[-1])
        self.chain = int(tiles.max())
        self.tile_off = torch.as_tensor(off).to(dev)
        R = len(bands)
        self.scratch = (
            torch.empty(self.n_tiles * MAP_ENTRIES, dtype=torch.int16,
                        device=dev),
            torch.empty((R, 4), dtype=torch.int32, device=dev),
            torch.empty((self.n_tiles, 4), dtype=torch.int32, device=dev),
            torch.empty((R, 2), dtype=torch.int32, device=dev))
        self.torch, self.lib = torch, lib
        self.a = (trace, llk, band_off, start_e, rk_len, kst, n_out,
                  byte_off, out)
        self.base, self.win, self.R = base, win, R

    def run(self, phases: int = 7):
        from f5c_tpu_torch.ops import abea

        (trace, llk, band_off, start_e, rk_len, kst, n_out, byte_off,
         out) = self.a
        _check(self.lib.f5c_abea_walk_tiled(
            *ptrs(trace, llk, band_off, start_e, rk_len, kst, n_out,
                  byte_off, out, self.reads, self.tile_off, *self.scratch),
            self.base, self.win, self.R, self.n_tiles, phases,
            abea.walk_map_smem_bytes(), abea.walk_chase_smem_bytes(),
            abea.walk_emit_smem_bytes(), _stream(self.torch)))


def _tiled_libs(libs):
    """(name, library) of this tree's tiled walk and of each variant."""
    yield "tiled", libs["change"]
    for key, lib in libs.items():
        if key.startswith("tiled_"):
            yield key, lib


def walk_fns(torch, libs, trace, llk, walk_args=None, window_args=None):
    """{tag: closure} of the walks of one launch: the parent's and this
    tree's one-warp kernel, this tree's tiled walk and its phases alone;
    and (the outputs {tag: closure returning them}, the Tiled)."""
    from f5c_tpu_torch.ops import abea

    smem = abea.walk_smem_bytes()
    fns, outs = {}, {}
    if walk_args is not None:
        _, _, band_off, start_e, rk_len, byte_off, n_bytes = walk_args[:7]
        B, dev = start_e.shape[0], trace.device
        bands = (band_off[1:] - band_off[:-1]).cpu().numpy()
        for tag, lib in (("parent", libs["parent"]),
                         ("warp", libs["change"])):
            o = (torch.zeros(n_bytes, dtype=torch.uint8, device=dev),
                 torch.empty(B, dtype=torch.int32, device=dev))
            extra = [] if tag == "parent" else [None]

            def run(lib=lib, o=o, extra=extra):
                _check(lib.f5c_abea_walk(
                    *ptrs(trace, llk, band_off, start_e, rk_len, byte_off,
                          *o), *extra, B, smem, _stream(torch)))
                return o
            fns[tag] = outs[tag] = run
        for name, lib in _tiled_libs(libs):
            o = (torch.zeros(n_bytes, dtype=torch.uint8, device=dev),
                 torch.zeros(B, dtype=torch.int32, device=dev))
            t = Tiled(torch, lib, trace, llk, byte_off, o[0], bands=bands,
                      band_off=band_off, start_e=start_e, rk_len=rk_len,
                      n_out=o[1])
            fns[name] = t.run
            outs[name] = (lambda t=t, o=o: (t.run(), o)[1])
            if name == "tiled":
                tiled, phase = t, t.run
    else:
        _, _, base, kst0, flat0, byte_off = window_args
        B = kst0.shape[0]
        win = trace.shape[1]
        for tag, lib in (("parent", libs["parent"]),
                         ("warp", libs["change"])):
            o = (torch.empty_like(kst0), torch.empty_like(flat0))

            def run(lib=lib, o=o):
                o[0].copy_(kst0)
                o[1].copy_(flat0)
                _check(lib.f5c_abea_walk_window(
                    *ptrs(trace, llk, o[0], byte_off, o[1]), base, win, B,
                    smem, _stream(torch)))
                return o
            fns[tag] = outs[tag] = run
        for name, lib in _tiled_libs(libs):
            o = (torch.empty_like(kst0), torch.empty_like(flat0))
            t = Tiled(torch, lib, trace, llk, byte_off, o[1], kst=o[0],
                      base=base, win=win)

            def run_tiled(phases=7, t=t, o=o):
                o[0].copy_(kst0)
                o[1].copy_(flat0)
                t.run(phases)
                return o
            fns[name] = outs[name] = run_tiled
            if name == "tiled":
                # a phase alone starts from the carried (k, e, n) again
                tiled, phase = t, run_tiled
    fns["tiled_maps"] = lambda: phase(1)
    fns["tiled_chase"] = lambda: phase(2)
    fns["tiled_emit"] = lambda: phase(4)
    return fns, outs, tiled


def _bits(torch, t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(torch, got, want) -> bool:
    return all((g is None and w is None) or torch.equal(_bits(torch, g),
                                                        _bits(torch, w))
               for g, w in zip(got, want))


def measure(torch, libs, tag, fill_args, walk_args, window, reps, chain):
    """One fill launch and the walk over its trace: held between the
    trees and routes, timed in turns.  Returns the record printed."""
    fills = {name: fill_fn(torch, lib, fill_args, window)
             for name, lib in libs.items()
             if name in ("parent", "change") or name.startswith("fill_")}
    outs = {name: [x.clone() if x is not None else None for x in fn()]
            for name, fn in fills.items()}
    torch.cuda.synchronize()
    for name, o in outs.items():
        if not _same(torch, o, outs["parent"]):
            raise AssertionError(f"{tag}: the {name} fill differs")
    res = dict(tag=tag, reads=int(fill_args[2].shape[0]), chain_bands=chain)
    # this tree's route: reads whose bands took __fdiv_rn (the rest the
    # fast quotient)
    from f5c_tpu_torch.ops import abea_cuda, abea_ultra_cuda

    res["guarded_reads"] = int((abea_ultra_cuda.abea_fill_window(
        *fill_args, routes=True) if window else abea_cuda.abea_fill(
        *fill_args, routes=True))[3].sum())
    res["fill_ms"] = time_turns(torch, fills, reps)
    res["fill_ns_per_band"] = {
        k: [round(1e6 * v / chain, 1) for v in vs]
        for k, vs in res["fill_ms"].items()}
    if walk_args is not None:
        o = outs["change"]
        trace, llk = (o[1], o[2]) if window else (o[0], o[1])
        fns, wouts, tiled = walk_fns(
            torch, libs, trace, llk, None if window else walk_args,
            walk_args if window else None)
        got = {k: [x.clone() for x in fn()] for k, fn in wouts.items()}
        torch.cuda.synchronize()
        for k, g in got.items():
            if not _same(torch, g, got["parent"]):
                raise AssertionError(f"{tag}: the {k} walk differs")
        steps = (got["tiled"][0][:, 2] - walk_args[3][:, 2]) if window \
            else got["tiled"][1].long()
        res["walk_steps_max"] = int(steps.max())
        res["tiles"] = tiled.n_tiles
        res["chase_tiles"] = tiled.chain
        res["walk_ms"] = time_turns(torch, fns, reps)
    chip_smoke.say("walk_launch", bit_identical=True,
                   **{k: json.dumps(v, separators=(",", ":"))
                      if isinstance(v, (dict, list)) else v
                      for k, v in res.items()})
    return res


def route_times(torch, tag, walk_args, reps):
    """The wrapper's walk of one launch by each route, in turns (the
    wrapper's host work included: what the pipeline pays)."""
    from f5c_tpu_torch.ops import abea_cuda

    bands = (walk_args[2][1:] - walk_args[2][:-1]).cpu().numpy()
    fns = {route or "crossover": (lambda route=route: abea_cuda.abea_walk(
        *walk_args, bands=bands, route=route))
        for route in ("warp", "tiled", None)}
    outs = {k: [x.clone() for x in fn()] for k, fn in fns.items()}
    torch.cuda.synchronize()
    for k, o in outs.items():
        if not _same(torch, o, outs["warp"]):
            raise AssertionError(f"{tag}: route {k} differs")
    res = dict(tag=tag, tiled_reads=int(
        (bands >= abea_cuda.TILED_MIN_BANDS).sum()), reads=len(bands),
        ms=time_turns(torch, fns, reps))
    chip_smoke.say("walk_route", **{k: json.dumps(v, separators=(",", ":"))
                                    if isinstance(v, dict) else v
                                    for k, v in res.items()})
    return res


def single_reads(torch, libs, dev, reps=10):
    """The crossover: single reads of SINGLE_BANDS bands walked alone by
    the one-warp kernel and the tiled walk, in turns."""
    import numpy as np

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model

    nuc = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(2030)
    rows = []
    for nb in SINGLE_BANDS:
        nk = int((nb - 2) / 2.7)
        seqs, events = synthetic.abea_reads(rng, [nk], nuc)
        x = synthetic.abea_inputs(seqs, events, nuc)
        t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
             else v for k, v in x.items()}
        fill = fill_fn(torch, libs["change"], tuple(
            t[k] for k in chip_smoke.FILL_ARGS) + (x["n_bands"],), False)()
        walk_args = (fill[0], fill[1], t["band_off"], fill[2], t["rk_len"],
                     t["byte_off"], x["n_bytes"])
        fns, outs, tiled = walk_fns(torch, libs, fill[0], fill[1], walk_args)
        fns = {k: fns[k] for k in fns
               if k == "warp" or (k.startswith("tiled") and not any(
                   k.endswith(p) for p in ("_maps", "_chase", "_emit")))}
        w, g = outs["warp"](), outs["tiled"]()
        torch.cuda.synchronize()
        if not _same(torch, g, w):
            raise AssertionError(f"single read of {nb} bands: tiled differs")
        r = dict(bands=int(x["n_bands"]), steps=int(w[1].max()),
                 ms=time_turns(torch, fns, reps))
        chip_smoke.say("walk_single", **{k: json.dumps(v, separators=(
            ",", ":")) if isinstance(v, dict) else v for k, v in r.items()})
        rows.append(r)
    return rows


def ultra_run(tree: str, data_json: str, out_json: str) -> int:
    """In a fresh process whose first path is ``tree``: ultra x4
    call-methylation and eventalign (host events) at the budget the
    environment sets: walls, busy and the ABEA kernels' times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        walls = [run()[0] for _ in range(3)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()[0]
        busy, per = chip_smoke.device_busy(torch, prof, top=12)
        res[entry] = dict(walls_s=walls, profiled_wall_s=wall, busy_ms=busy,
                          kernels={k: v for k, v in per.items()
                                   if k in ABEA_KERNELS})
        digest = hashlib.sha256()
        for path in (out, summary):
            if path is not None:
                with open(path, "rb") as f:
                    digest.update(f.read())
        res[entry]["tsv_sha256"] = digest.hexdigest()
    with open(out_json, "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--tiled", action="append", default=[], metavar="DIR")
    ap.add_argument("--fill", action="append", default=[], metavar="DIR")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "abea_walk_time"))
    ap.add_argument("--no-ultra", action="store_true")
    ap.add_argument("--fills-only", action="store_true",
                    help="time the fills alone: no walk, no crossover")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("abea_walk_time: no CUDA device", file=sys.stderr)
        return 1
    from f5c_tpu_torch import datasets, synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import _build, abea
    from f5c_tpu_torch.pipeline import runner

    parent = os.path.abspath(a.parent)
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = {"parent": build_parent(os.path.join(parent, "f5c_tpu_torch",
                                                "csrc")),
            "change": _build.library()}
    result = {"card": card, "launches": [], "routes": [], "single": [],
              "ultra": []}
    for d in a.tiled:
        tag = os.path.basename(os.path.normpath(d))
        libs[f"tiled_{tag}"] = build_tiled(d, tag)
    libs["change"].fill_smem = abea.fill_smem_bytes()
    with open(os.path.join(os.path.dirname(_build.build_info["path"]),
                           "build.log")) as f:
        libs["change"].ptxas = chip_smoke.fill_ptxas(f.read())
    for d in a.fill:
        tag = os.path.basename(os.path.normpath(d))
        libs[f"fill_{tag}"] = build_parent(d, f"fill_{tag}")
    for tag, lib in libs.items():
        if hasattr(lib, "ptxas"):
            chip_smoke.say("fill_ptxas", tree=tag, **{
                k.replace("<", "_").replace(">", ""): v.replace(" ", "_")
                for k, v in lib.ptxas.items()})
    result["ptxas"] = {tag: lib.ptxas for tag, lib in libs.items()
                       if hasattr(lib, "ptxas")}
    walks = not a.fills_only
    L = result["launches"]
    with tempfile.TemporaryDirectory(prefix="walk_") as tmp:
        source = datasets.dataset(chip_smoke.GOLDEN,
                                  slow5=datasets.GOLDEN_SIGNALS_ZLIB)
        x85 = datasets.replicate_dataset(source, os.path.join(tmp, "x85"),
                                         chip_smoke.COPIES)
        ultra = datasets.ultra_dataset(os.path.join(tmp, "ultra"),
                                       seed=2026)
        calls = record_launches(torch, x85, os.path.join(tmp, "rec.tsv"))
        fa, wa = calls["abea_fill"][0][0], calls["abea_walk"][0][0]
        chain = int(fa[11].diff().max())
        L.append(measure(torch, libs, "golden_x85_first", fa,
                         wa if walks else None, False, 20, chain))
        if walks:
            result["routes"].append(route_times(torch, "golden_x85_first",
                                                wa[:7], 20))
        del calls, fa, wa
        # the 54,002-band read among 40 short ones (chip_smoke's batch)
        rng = np.random.default_rng(2028)
        nuc = builtin_model("dna_r9_nucleotide")
        n_kmers = [chip_smoke.MIX_LONG] + [
            int(n) for n in rng.integers(50, 2500, 40)]
        seqs, events = synthetic.abea_reads(rng, n_kmers, nuc,
                                            unrelated=(7,))
        x = synthetic.abea_inputs(seqs, events, nuc)
        t = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
             else v for k, v in x.items()}
        fa = tuple(t[k] for k in chip_smoke.FILL_ARGS) + (x["n_bands"],)
        fill = fill_fn(torch, libs["change"], fa, False)()
        wa = (fill[0], fill[1], t["band_off"], fill[2], t["rk_len"],
              t["byte_off"], x["n_bytes"])
        chain = int(np.diff(x["band_off"]).max())
        L.append(measure(torch, libs, "mixed_54k", fa, wa if walks else None,
                         False, 5, chain))
        if walks:
            result["routes"].append(route_times(torch, "mixed_54k", wa, 5))
        del fill, wa, fa, t
        calls = record_launches(torch, ultra, os.path.join(tmp, "u.tsv"))
        # the launch of the longest chain: at the defaults ul300's solo
        # launch
        chains = [int(c[11].diff().max()) for c, _ in calls["abea_fill"]]
        li = int(np.argmax(chains))
        fa, wa = calls["abea_fill"][li][0], calls["abea_walk"][li][0]
        chain = chains[li]
        L.append(measure(torch, libs, "ultra_x4_unchunked", fa,
                         wa if walks else None, False, 3, chain))
        del calls, fa, wa
        torch.cuda.empty_cache()
        calls = record_launches(
            torch, ultra, os.path.join(tmp, "uw.tsv"),
            budget=chip_smoke.ultra_budget(runner, datasets))
        win_calls = calls["abea_fill_window"]
        nb = int(win_calls[0][0][11].diff().min())
        full = next(c for c, _ in win_calls[1:]
                    if c[13] + c[14] <= nb)        # a window every read fills
        walk = next(c for c, _ in calls["abea_walk_window"]
                    if c[2] == full[13])
        L.append(measure(torch, libs, "ultra_x4_k3_forward", win_calls[0][0],
                         None, True, 3, int(win_calls[0][0][11].diff().max())))
        L.append(measure(torch, libs, "ultra_x4_full_window", full,
                         walk if walks else None, True, 3, full[14]))
        del calls, win_calls, full, walk
        torch.cuda.empty_cache()
        if walks:
            result["single"] = single_reads(torch, libs, dev)
        data_json = os.path.join(tmp, "ultra.json")
        with open(data_json, "w") as f:
            json.dump([ultra, tmp], f)
        turns = () if a.no_ultra else ((parent, "parent"), (ROOT, "change"),
                                        (ROOT, "change"), (parent, "parent"))
        budgets = {"unchunked": None,
                   "windowed": chip_smoke.ultra_budget(runner, datasets)}
        for config, budget in budgets.items():
            for i, (tree, tag) in enumerate(turns):
                out_json = os.path.join(tmp, f"ultra_{config}_{i}.json")
                env = {k: v for k, v in os.environ.items()
                       if k not in ("PYTHONPATH", "F5C_TPU_TRACE_BYTES")}
                env["PYTHONPATH"] = tree
                if budget is not None:
                    env["F5C_TPU_TRACE_BYTES"] = str(budget)
                t0 = time.time()
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--ultra-run", tree, data_json, out_json],
                               cwd=tree, env=env, check=True)
                with open(out_json) as f:
                    res = json.load(f)
                result["ultra"].append(dict(tree=tag, turn=i, config=config,
                                            **res))
                for entry, r in res.items():
                    chip_smoke.say(
                        "walk_ultra", config=config, tree=tag, turn=i,
                        entry=entry,
                        walls_s=",".join(f"{w:.3f}" for w in r["walls_s"]),
                        busy_ms=f"{r['busy_ms']:.1f}",
                        profiled_wall_s=f"{r['profiled_wall_s']:.3f}",
                        tsv_sha256=r["tsv_sha256"][:16],
                        kernels=json.dumps(r["kernels"],
                                           separators=(",", ":")),
                        process_s=f"{time.time() - t0:.1f}")
    # every tree, turn and configuration wrote the same bytes per entry
    for entry in ("meth", "eventalign"):
        hashes = {u[entry]["tsv_sha256"] for u in result["ultra"]}
        chip_smoke.say("walk_ultra_bytes", entry=entry,
                       byte_identical=len(hashes) <= 1)
        if len(hashes) > 1:
            raise AssertionError(f"ultra x4 {entry}: the outputs differ")
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "walk.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ultra-run"]:
        sys.path.insert(0, sys.argv[2])
        sys.exit(ultra_run(*sys.argv[2:5]))
    sys.exit(main())
