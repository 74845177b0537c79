#!/usr/bin/env python3
"""Time the chunk Viterbi (csrc/viterbi.cu, K8) built from one or more
source directories, on the same launches on one card, in turns.

    python3 scripts/viterbi_kernel_time.py [DIR[:gG][:scratch] ...]

Each DIR holds a ``viterbi.cu`` (default: the package's own
``f5c_tpu_torch/csrc``).  A source whose C entry takes a launch plan
(the package's) is built with -DVITERBI_GROUP=G for ``:gG`` (G = 8 or
16 lanes a chunk, 32 / G chunks a one-warp block; default 32, the
package's), launched with ``viterbi_cuda.table_plan``'s plan, and also
built with -DVITERBI_FILL_ONLY (the fill without the backtrace), which
splits its time into ns per event row and ns per backtrace step.
``:scratch`` puts every movement table in the global scratch; a build
with G < 32 always takes it (its blocks hold several chunks, the plan's
shared memory one).  An older source is the one-block-a-chunk kernel of
f97def0, whose entry takes a per-chunk scratch offset and no plan.  To
time that one against the package's, and the lanes a chunk:

    mkdir -p ab/k8_one_block
    git show f97def0:f5c_tpu_torch/csrc/viterbi.cu > ab/k8_one_block/viterbi.cu
    python3 scripts/viterbi_kernel_time.py ab/k8_one_block f5c_tpu_torch/csrc \\
        f5c_tpu_torch/csrc:scratch f5c_tpu_torch/csrc:g16 f5c_tpu_torch/csrc:g8

Each build is compiled with nvcc and the flags of ``ops/_build.py`` into
``build/viterbi_kernel_time/``.  The launch sets, made from seeds:

- ``golden_x85``: every round the device engine of ``eventalign
  --summary`` sends to the kernel on the 6 golden reads x 85 (captured
  through the wrapper; 149 rounds on the card), and ``golden_x85_max``,
  its largest round alone (128 chunks);
- ``synthetic_128``: ``synthetic.viterbi_round`` of 128 chunks;
- ``k9_wave_max``: the largest round of the device engine on 512
  synthetic R10 reads (9-mer tables; chip_smoke's [pores_k9_wave]).

Every build is first held bit for bit to the plain version
(``hmm.viterbi_rounds_plain``) on every launch (the fill-only builds
excepted), then the builds are timed in turns A B ... B A: the kernel
launches of one pass over a set (CUDA events, mean of REPS passes, the
plans made beforehand).  Printed per set and build: ms per pass, the
rows of each launch's longest chunk and the steps of its longest walk
(summed over the set), ns per event row (fill-only ms over those rows)
and ns per backtrace step (the full build's ms less the fill-only ms,
over those steps), ns per chain step (ms over rows + steps); then
``viterbi_cuda.viterbi_rounds`` itself over the set (the package's
build, as chip_smoke.py times K8): its kernel's CUDA-event spans, the
whole calls, and on the host's clock the calls, ``table_plan`` alone,
f97def0's plan alone and the plan's copy to the card alone, in us a
call; then the card's name and power limit.

    python3 scripts/viterbi_kernel_time.py --package DIR

times the package under DIR (``DIR/f5c_tpu_torch``, e.g. a parent
unpacked with ``git archive``, which builds its own kernels) through its
own entry points alone: the walls of WALL_RUNS warm ``eventalign
--summary`` calls on golden x85 with ``F5C_TPU_EA_ENGINE=device``, and
its wrapper on ``synthetic_128`` over WRAPPER_CALLS calls (the numbers
above).  Run it once a package, in turns (parent, change, change,
parent), to hold two trees' wrappers and walls to each other on one card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20
K9_WAVE_READS = 512
WALL_RUNS = 3           # --package: timed eventalign calls after a warm one
WRAPPER_CALLS = 500     # --package: wrapper calls on synthetic_128
_vp, _int = ctypes.c_void_p, ctypes.c_int


def has_plan(src_dir: str) -> bool:
    """Whether the source's C entry takes a launch plan."""
    with open(os.path.join(ROOT, src_dir, "viterbi.cu")) as f:
        return "void* plan" in f.read()


def build(src_dir: str, tag: str, group: int, fill_only: bool = False):
    """(the library, whether its entry takes a plan)."""
    from f5c_tpu_torch.ops import _build

    src = os.path.join(src_dir, "viterbi.cu")
    new = has_plan(src_dir)
    out = os.path.join(ROOT, "build", "viterbi_kernel_time", tag)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libviterbi.so")
    flags = ["-DVITERBI_FILL_ONLY"] if fill_only else []
    if group != 32:
        flags.append(f"-DVITERBI_GROUP={group}")
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags,
                          "-shared", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{res.stderr}")
    for ln in (res.stdout + res.stderr).splitlines():
        if "Used" in ln or "spill" in ln:
            print(f"[viterbi_kernel_time] ptxas {tag}: {ln.strip()}")
    lib = ctypes.CDLL(so)
    lib.f5c_viterbi_rounds.argtypes = (
        [_vp] * 12 + [_int] * 4 + [_vp])
    lib.f5c_viterbi_rounds.restype = _int
    return lib, new


def old_table_plan(np, n_kmers, n_events, scratch=False):
    """The launch layout of f97def0's wrapper: (scratch_off, scratch
    bytes, shared bytes) for one block of 128 threads a chunk; every
    table in the scratch with ``scratch``."""
    cells = n_events.astype(np.int64) * (n_kmers.astype(np.int64) + 1)
    k_max = max(int(n_kmers.max()), 1)
    base = (4 * (3 * k_max + 6 * (k_max + 1) + 4) + 15) // 16 * 16
    big = cells > (0 if scratch else min(160 * 1024, 232448 - base))
    off = np.full(cells.shape[0], -1, np.int64)
    off[big] = np.cumsum(cells[big]) - cells[big]
    table = int(cells[~big].max()) if (~big).any() else 0
    return off, int(cells[big].sum()), base + (table + 15) // 16 * 16


class Launch:
    """One recorded wrapper call, with the device buffers of one build's
    launch made beforehand."""

    def __init__(self, torch, np, args):
        self.args = args
        self.spec = args[0].cpu().numpy()
        self.N = self.spec.shape[0]
        self.max_path = args[8]
        self.k_max = max(int(self.spec[:, 2].max()), 1)
        self.consts = np.ascontiguousarray(args[2], dtype=np.float32)

    def prepare(self, torch, np, new, scratch):
        from f5c_tpu_torch.ops import viterbi_cuda

        dev = self.args[0].device
        if new:
            cap = viterbi_cuda.TABLE_SMEM_MAX
            viterbi_cuda.TABLE_SMEM_MAX = 0 if scratch else cap
            try:
                plan, nbytes, smem = viterbi_cuda.table_plan(
                    self.spec[:, 2], self.spec[:, 5])
            finally:
                viterbi_cuda.TABLE_SMEM_MAX = cap
        else:
            plan, nbytes, smem = old_table_plan(np, self.spec[:, 2],
                                                self.spec[:, 5], scratch)
        self.plan = torch.from_numpy(plan).to(dev)
        self.scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                   device=dev)
        self.smem = smem
        self.movs = torch.zeros((self.N, self.max_path // 2),
                                dtype=torch.uint8, device=dev)
        self.n_steps = torch.zeros(self.N, dtype=torch.int32, device=dev)

    def launch(self, torch, lib):
        a = self.args
        ptrs = [a[0].data_ptr(), a[1].data_ptr(), self.consts.ctypes.data,
                *(t.data_ptr() for t in a[3:8]), self.plan.data_ptr(),
                self.scratch.data_ptr(), self.movs.data_ptr(),
                self.n_steps.data_ptr()]
        err = lib.f5c_viterbi_rounds(
            *ptrs, self.N, self.max_path, self.k_max, self.smem,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"f5c_viterbi_rounds: CUDA error {err}")


def capture_rounds(argv, ea_engine="device") -> list:
    """The wrapper calls of one CLI run (args of viterbi_rounds)."""
    from f5c_tpu_torch import cli
    from f5c_tpu_torch.ops import viterbi_cuda

    calls = []
    orig = viterbi_cuda.viterbi_rounds

    def spy(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    saved = os.environ.get("F5C_TPU_EA_ENGINE")
    os.environ["F5C_TPU_EA_ENGINE"] = ea_engine
    viterbi_cuda.viterbi_rounds = spy
    try:
        if cli.main(argv) != 0:
            raise RuntimeError(f"{argv[0]} failed")
    finally:
        viterbi_cuda.viterbi_rounds = orig
        if saved is None:
            os.environ.pop("F5C_TPU_EA_ENGINE", None)
        else:
            os.environ["F5C_TPU_EA_ENGINE"] = saved
    return calls


def launch_sets(torch, np, tmp) -> dict:
    from f5c_tpu_torch import datasets, synthetic

    gold = os.path.join(ROOT, "tests", "data", "golden")
    src = datasets.dataset(gold, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
    x85 = datasets.replicate_dataset(src, os.path.join(tmp, "x85"), 85)
    opts = ["--min-mapq", "0", "-b", x85["bam"], "-g", x85["genome"], "-r",
            x85["reads"], "--slow5", x85["slow5"]]
    out = os.path.join(tmp, "ea.tsv")
    golden = capture_rounds(["eventalign", "--summary", out + ".s", *opts,
                             "-o", out])
    synth = synthetic_128(torch, np)
    nuc_path, _ = synthetic.r10_models(os.path.join(tmp, "r10m"))
    lengths = np.random.default_rng(11).integers(700, 1401, K9_WAVE_READS)
    d = synthetic.r10_dataset(os.path.join(tmp, "r10"), nuc_path,
                              lengths=lengths)
    out = os.path.join(tmp, "k9.tsv")
    k9 = capture_rounds(["eventalign", "--min-mapq", "0", "-b", d["bam"],
                         "-g", d["genome"], "-r", d["reads"], "--slow5",
                         d["slow5"], "-o", out, "--pore", "r10",
                         "--kmer-model", nuc_path, "--min-recalib-events",
                         "100", "--summary", out + ".s"])

    def largest(calls):
        return [max(calls, key=lambda a: int(a[0].shape[0]))]

    return {"golden_x85": golden, "golden_x85_max": largest(golden),
            "synthetic_128": synth, "k9_wave_max": largest(k9)}


def wrapper_ms(torch, np, launches, reps: int = REPS) -> dict:
    """``viterbi_cuda.viterbi_rounds`` over a launch set (the package's
    build), means of ``reps`` passes: the kernels' CUDA-event spans and the
    whole calls in ms a pass (chip_smoke.py's two K8 times), and on the
    host's clock, in us a call, the calls, ``table_plan`` alone, f97def0's
    plan alone and the plan's copy to the card alone."""
    import time

    from f5c_tpu_torch.ops import _build, viterbi_cuda

    def one_pass():
        for L in launches:
            viterbi_cuda.viterbi_rounds(*L.args, host_spec=L.spec)

    def host_us(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            for L in launches:
                fn(L)
        return 1e6 * (time.perf_counter() - t0) / (reps * len(launches))

    one_pass()
    torch.cuda.synchronize()
    _build.launch_spans = []
    try:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            one_pass()
        stop.record()
        t_host = time.perf_counter() - t0
        stop.synchronize()
        spans = sum(a.elapsed_time(b) for a, b in _build.launch_spans)
    finally:
        _build.launch_spans = None
    dev = launches[0].args[0].device
    plans = [viterbi_cuda.table_plan(L.spec[:, 2], L.spec[:, 5])[0]
             for L in launches]
    out = dict(
        span_ms=spans / reps, call_ms=start.elapsed_time(stop) / reps,
        call_host_us=1e6 * t_host / (reps * len(launches)),
        plan_us=host_us(lambda L: viterbi_cuda.table_plan(L.spec[:, 2],
                                                           L.spec[:, 5])),
        f97def0_plan_us=host_us(lambda L: old_table_plan(
            np, L.spec[:, 2], L.spec[:, 5])))
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in plans:
            torch.from_numpy(p).to(dev, non_blocking=True)
    out["upload_us"] = 1e6 * (time.perf_counter() - t0) / (reps * len(plans))
    torch.cuda.synchronize()
    return out


def synthetic_128(torch, np) -> list:
    """The args of viterbi_rounds on synthetic.viterbi_round's 128 chunks."""
    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import hmm

    nuc = builtin_model("dna_r9_nucleotide")
    x = synthetic.viterbi_round(np.random.default_rng(2040), nuc, 128)
    tables = [torch.as_tensor(np.asarray(t, np.float32), device="cuda")
              for t in (nuc.level_mean, nuc.level_stdv, nuc.level_log_stdv)]
    return [(torch.from_numpy(x["spec_i32"]).cuda(),
             torch.from_numpy(x["spec_f32"]).cuda(), hmm.viterbi_consts(),
             torch.from_numpy(x["rank_pool"]).cuda(),
             torch.from_numpy(x["ev_pool"]).cuda(), *tables,
             hmm.viterbi_max_path(x["spec_i32"][:, 2], x["spec_i32"][:, 5]))]


def package_run(torch, np, pkg: str) -> int:
    """--package: the walls of golden x85's device-engine eventalign and
    the wrapper on synthetic_128, through the package under ``pkg``."""
    import time

    import f5c_tpu_torch
    from f5c_tpu_torch import cli, datasets

    here = os.path.dirname(os.path.abspath(f5c_tpu_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(pkg):
        raise RuntimeError(f"f5c_tpu_torch comes from {here}, not {pkg}")
    gold = os.path.join(ROOT, "tests", "data", "golden")
    walls = []
    saved = os.environ.get("F5C_TPU_EA_ENGINE")
    os.environ["F5C_TPU_EA_ENGINE"] = "device"
    try:
        with tempfile.TemporaryDirectory(prefix="viterbi_pkg_") as tmp:
            src = datasets.dataset(gold, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
            x85 = datasets.replicate_dataset(src, os.path.join(tmp, "x85"),
                                             85)
            out = os.path.join(tmp, "ea.tsv")
            argv = ["eventalign", "--summary", out + ".s", "--min-mapq", "0",
                    "-b", x85["bam"], "-g", x85["genome"], "-r",
                    x85["reads"], "--slow5", x85["slow5"], "-o", out]
            for _ in range(WALL_RUNS + 1):
                t0 = time.perf_counter()
                if cli.main(argv) != 0:
                    raise RuntimeError("eventalign failed")
                walls.append(time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop("F5C_TPU_EA_ENGINE", None)
        else:
            os.environ["F5C_TPU_EA_ENGINE"] = saved
    launches = [Launch(torch, np, a) for a in synthetic_128(torch, np)]
    w = wrapper_ms(torch, np, launches, WRAPPER_CALLS)
    print(f"[viterbi_kernel_time] package={pkg} golden_x85_device_walls_s="
          + ",".join(f"{t:.3f}" for t in walls[1:]) + " synthetic_128 "
          + " ".join(f"{k}={v:.4f}" for k, v in w.items()), flush=True)
    return 0


def parse(spec: str):
    """(DIR, lanes a chunk, every table in the scratch) of DIR[:gG][:scratch]."""
    d, *opts = spec.split(":")
    g = next((int(o[1:]) for o in opts if o.startswith("g")), 32)
    return d, g, "scratch" in opts or g != 32


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if argv[:1] == ["--package"]:
        sys.path.insert(0, os.path.abspath(argv[1]))
    from f5c_tpu_torch.ops import hmm

    if not torch.cuda.is_available():
        print("viterbi_kernel_time: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--package"]:
        return package_run(torch, np, argv[1])
    csrc = os.path.join("f5c_tpu_torch", "csrc")
    specs = argv or [csrc]
    # one build per source directory and group (and its fill-only twin),
    # in parallel
    keys = sorted({parse(s)[:2] for s in specs})
    with ThreadPoolExecutor(2 * len(keys)) as pool:
        jobs = {(d, g, f): pool.submit(build, os.path.join(ROOT, d),
                                       f"v{i}{'_fill' if f else ''}", g, f)
                for i, (d, g) in enumerate(keys) for f in (False, True)
                if not f or has_plan(os.path.join(ROOT, d))}
        libs = {k: j.result() for k, j in jobs.items()}
    variants = []       # (name, lib, new, scratch, fill-only lib)
    for s in specs:
        d, g, scratch = parse(s)
        lib, new = libs[d, g, False]
        variants.append((s, lib, new, scratch,
                         libs[d, g, True][0] if new else None))
    with tempfile.TemporaryDirectory(prefix="viterbi_time_") as tmp:
        sets = launch_sets(torch, np, tmp)
    for name, calls in sets.items():
        launches = [Launch(torch, np, a) for a in calls]
        wants = [hmm.viterbi_rounds_plain(*a) for a in calls]
        rows = sum(int(L.spec[:, 5].max()) for L in launches)
        steps = sum(int(w[1].max()) for w in wants)
        for vname, lib, new, scratch, _ in variants:
            for L, want in zip(launches, wants):
                L.prepare(torch, np, new, scratch)
                L.launch(torch, lib)
                if not (torch.equal(L.movs, want[0])
                        and torch.equal(L.n_steps, want[1])):
                    raise AssertionError(f"{vname}: {name} differs from "
                                         "plain")
        runs = [(v, False) for v in variants]
        runs += [(v, True) for v in variants if v[4] is not None]
        times = {(v[0], f): [] for v, f in runs}
        for (vname, lib, new, scratch, fill_lib), fill in runs + runs[::-1]:
            lib_used = fill_lib if fill else lib
            for L in launches:
                L.prepare(torch, np, new, scratch)

            def one_pass():
                for L in launches:
                    L.launch(torch, lib_used)
            one_pass()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                one_pass()
            stop.record()
            stop.synchronize()
            times[vname, fill].append(start.elapsed_time(stop) / REPS)
        for vname, _, new, scratch, fill_lib in variants:
            ms = times[vname, False]
            line = (f"[viterbi_kernel_time] launch={name} source={vname} "
                    f"tables={'scratch' if scratch else 'plan'} "
                    f"launches={len(launches)} "
                    f"chunks={sum(L.N for L in launches)} "
                    f"longest_rows={rows} longest_steps={steps} "
                    f"ms={','.join(f'{m:.4f}' for m in ms)} "
                    f"ns_per_chain_step="
                    f"{1e6 * np.mean(ms) / (rows + steps):.1f}")
            if fill_lib is not None:
                fm = times[vname, True]
                line += (f" fill_ms={','.join(f'{m:.4f}' for m in fm)} "
                         f"ns_per_row={1e6 * np.mean(fm) / rows:.1f} "
                         f"ns_per_backtrace_step="
                         f"{1e6 * (np.mean(ms) - np.mean(fm)) / steps:.1f}")
            print(line, flush=True)
        # through the wrapper, the package's own build
        w = wrapper_ms(torch, np, launches)
        print(f"[viterbi_kernel_time] launch={name} wrapper "
              + " ".join(f"{k}={v:.4f}" for k, v in w.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
