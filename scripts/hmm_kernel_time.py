#!/usr/bin/env python3
"""Time the fused HMM kernel (csrc/hmm.cu) built from one or more source
directories, on the same launches on one card, in turns.

    python3 scripts/hmm_kernel_time.py [DIR ...]

Each DIR holds a ``hmm.cu`` and a ``hmm_ranks.cuh`` (default: the
package's own ``f5c_tpu_torch/csrc``); each is built with nvcc and the
flags of ``ops/_build.py`` into a library of its own under
``build/hmm_kernel_time/``.  The launches, made from a seed:

- ``golden_shaped``: 11,520 windows in launch order, 49 % of 16 k-mers,
  41 % of 17-32 and 10 % of 33-58 (the classes of chip_smoke.py's scale
  launch);
- ``golden_shaped_k9``: the same k-mer counts on the synthetic 9-mer
  CpG table (5^9 levels, 23 MB: ``synthetic.k9_models``), so that the
  table and k are all that differ from ``golden_shaped``;
- ``mixed``: 2,000 windows of 1-300 k-mers.

Every variant is first held to the plain version (hmm.py's tolerance),
then timed with CUDA events (mean of 50 launches), variants in turns
A B ... B A.  Prints a line per variant and launch: ms, warp-steps and
an SM sub-partition's ns per warp-step; then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def build(src_dir: str, tag: str) -> ctypes.CDLL:
    from f5c_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "hmm_kernel_time", tag)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libhmm.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    so, os.path.join(src_dir, "hmm.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.f5c_hmm_forward_meta.argtypes = _ARGTYPES
    lib.f5c_hmm_forward_meta.restype = ctypes.c_int
    return lib


def launch(lib, torch, t, x):
    """One launch of the kernel in ``lib`` on the batch ``t`` (tensors on
    the card) as ops/hmm_cuda.hmm_forward_meta makes it."""
    from f5c_tpu_torch.ops import hmm_cuda
    from f5c_tpu_torch.ops.hmm import CONSTS

    # shared memory for every window wider than one chunk, which every
    # variant takes (a few KB a block: it does not bound the occupancy)
    max_km = x["max_km"]
    kw_smem = (0 if max_km <= hmm_cuda.CHUNK
               else -(-max_km // hmm_cuda.CHUNK) * hmm_cuda.CHUNK)
    out = torch.empty(t["meta"].shape[0], dtype=torch.float32,
                      device=t["meta"].device)
    err = lib.f5c_hmm_forward_meta(
        *(t[k].data_ptr() for k in ("meta", "packed_ref", "read_tab",
                                    "ev_pool", "level_mean", "level_stdv",
                                    "level_log_stdv")),
        CONSTS.ctypes.data, out.data_ptr(), 4 * t["packed_ref"].shape[0],
        t["level_mean"].shape[0], x["k"], 1, 1, out.shape[0], x["n_narrow"],
        kw_smem, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    from f5c_tpu_torch import synthetic
    from f5c_tpu_torch.models import builtin_model
    from f5c_tpu_torch.ops import hmm, hmm_cuda, hmm_meta

    if not torch.cuda.is_available():
        print("hmm_kernel_time: no CUDA device", file=sys.stderr)
        return 1
    dirs = argv or [os.path.join(ROOT, "f5c_tpu_torch", "csrc")]
    libs = [(d, build(d, f"v{i}")) for i, d in enumerate(dirs)]
    cpg = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(2030)
    n = 11520
    golden = np.concatenate([
        np.full(int(0.49 * n), 16), rng.integers(17, 33, int(0.41 * n)),
        rng.integers(33, 59, n - int(0.49 * n) - int(0.41 * n))])
    batches = {"golden_shaped": (golden, cpg),
               "golden_shaped_k9": (golden, synthetic.k9_models()[1]),
               "mixed": (rng.integers(1, 301, 2000), cpg)}
    smsp = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    for name, (n_kmers, model) in batches.items():
        x = synthetic.hmm_meta_windows(rng, n_kmers, model)
        t = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()
             if isinstance(v, np.ndarray)}
        want = hmm_meta.hmm_forward_meta_plain(
            *(t[k] for k in ("meta", "packed_ref", "read_tab", "ev_pool",
                             "level_mean", "level_stdv", "level_log_stdv")),
            x["k"])
        shape = hmm_cuda.launch_shape(x["n_km"], x["n_ev"], x["n_narrow"])
        for d, lib in libs:
            torch.testing.assert_close(launch(lib, torch, t, x), want,
                                       rtol=hmm.RTOL, atol=hmm.ATOL)
        times = {d: [] for d, _ in libs}
        for d, lib in libs + libs[::-1]:
            launch(lib, torch, t, x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                launch(lib, torch, t, x)
            stop.record()
            stop.synchronize()
            times[d].append(start.elapsed_time(stop) / 50)
        for d, ms in times.items():
            print(f"[hmm_kernel_time] launch={name} source={d} "
                  f"ms={','.join(f'{m:.4f}' for m in ms)} "
                  f"windows={shape['windows']} warp_steps="
                  f"{shape['warp_steps']} ns_per_warp_step="
                  f"{1e6 * min(ms) * smsp / shape['warp_steps']:.1f}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
