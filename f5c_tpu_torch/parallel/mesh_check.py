"""Mesh parity harness: the production call-methylation path (the wave
schedule: ABEA, then the HMM of each wave against its event slab) and
eventalign's re-alignment of the same aligned batch with every lockstep
round on the Viterbi kernel (``F5C_TPU_EA_ENGINE=device``), run twice on
the same reads -- once on one device, once dealt over several -- with
the results held bit for bit: status, aligned pairs, scalings,
``b2e_start``, methylation scores and the eventalign TSV.  Counterpart
of ``f5c_tpu/parallel/mesh_check.py``, on the vendored golden set
(``tests/data/golden``) replicated with ``datasets.replicate_dataset``.

    python -m f5c_tpu_torch.parallel.mesh_check --copies 85
    python -m f5c_tpu_torch.parallel.mesh_check --devices cpu,cpu,cpu

By default the mesh is every visible card, or two slots of ``cuda:0`` on
a host with one card; it runs on the CPU only when ``--devices`` names
CPU slots, and refuses to run when there is no card.

Slots of one device (``cpu,cpu`` or ``cuda:0,cuda:0``) share that
device, so the sharded wall measures the dispatch's overhead, not a
speedup: scaling needs several cards.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import datasets
from . import mesh

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "golden")


def _pipeline(paths: dict, device, devices):
    from ..pipeline.runner import Options, Pipeline

    opt = Options(min_mapq=0, meth_out_version=1, slow5_path=paths["slow5"])
    return Pipeline(paths["bam"], paths["genome"], paths["reads"], opt,
                    device, devices=devices)


def run(paths: dict, devices) -> tuple[dict, str, float, int]:
    """call-methylation's align + meth, then device-engine eventalign
    re-alignment of the aligned reads, on ``devices`` (one device: no
    mesh).  Returns ({qname: (status, pairs, (shift, scale, var),
    b2e_start, (starts, llm, llu))}, the eventalign TSV, wall seconds,
    the re-alignment's rounds)."""
    from ..pipeline.eventalign import EventalignEngine, emit_tsv, tsv_header

    devices = [torch.device(d) for d in devices]
    t0 = time.time()
    pipe = _pipeline(paths, devices[0], devices)
    saved = os.environ.get("F5C_TPU_EA_ENGINE")
    os.environ["F5C_TPU_EA_ENGINE"] = "device"
    try:
        engine = EventalignEngine(pipe.model, device=devices[0],
                                  devices=devices)
    finally:
        if saved is None:
            os.environ.pop("F5C_TPU_EA_ENGINE")
        else:
            os.environ["F5C_TPU_EA_ENGINE"] = saved
    out, ea = {}, io.StringIO(tsv_header())
    ea.seek(0, io.SEEK_END)
    for batch in pipe.batches(load=False):
        pipe.align_batch_waved(batch, meth_inline=True)
        sites = pipe.meth_batch(batch)
        for r in batch:
            mc = sites.get(id(r))
            sc = r.scaling
            out[r.qname] = (
                int(r.status), r.pairs,
                None if sc is None else (sc.shift, sc.scale, sc.var),
                r.b2e_start,
                None if mc is None else (mc.starts, mc.llm, mc.llu))
        ok = [r for r in batch if not r.status and r.b2e_start is not None]
        recs = engine.realign_batch(
            ok, [pipe._fetch_ref_segment(r) for r in ok])
        for r in ok:
            rec = recs[id(r)]
            ea.write(emit_tsv(rec, r, pipe.model, pipe.bam.references[r.tid],
                              rec.ref_disamb, rec.ref_offset, r.read_idx))
    if devices[0].type == "cuda":
        torch.cuda.synchronize(devices[0])
    return out, ea.getvalue(), time.time() - t0, \
        engine.stats["rounds_device"]


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def compare(single: dict, sharded: dict) -> None:
    """Raise unless every read's results are the same bits."""
    if set(single) != set(sharded):
        raise AssertionError("the sharded run saw other reads")
    for q, (s0, p0, sc0, b0, m0) in single.items():
        s1, p1, sc1, b1, m1 = sharded[q]
        if s0 != s1:
            raise AssertionError(f"{q}: status {s0} != {s1}")
        if not (_same((p0,), (p1,)) and sc0 == sc1
                and _same((b0,), (b1,))):
            raise AssertionError(f"{q}: ABEA results differ under the mesh")
        if not _same(m0, m1):
            raise AssertionError(f"{q}: meth scores differ under the mesh")


def run_mesh_parity(paths: dict, devices) -> dict:
    """Single-device run, then the run dealt over ``devices``; raises on
    any difference.  Returns reads, TSV rows, walls and the sharded run's
    slot log (``mesh.SLOT_LOG``)."""
    devices = [torch.device(d) for d in devices]
    if len(devices) < 2:
        raise ValueError(f"a mesh needs two devices or more, not {devices}")
    single, ea_single, t_single, rounds = run(paths, devices[:1])
    mesh.TRANSFER_LOG.clear()
    mesh.SLOT_LOG.clear()
    sharded, ea_sharded, t_sharded, _ = run(paths, devices)
    compare(single, sharded)
    if ea_single != ea_sharded:
        raise AssertionError("eventalign TSV differs under the mesh")
    return dict(reads=len(single), ea_rows=ea_single.count("\n") - 1,
                single_s=t_single, sharded_s=t_sharded, rounds=rounds,
                slots=dict(mesh.SLOT_LOG))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m f5c_tpu_torch.parallel.mesh_check",
        description="sharded == single bit for bit on the golden set")
    ap.add_argument("--devices",
                    help="comma-separated torch devices of the mesh "
                         "(default: every visible card, or cuda:0,cuda:0 "
                         "on a host with one card; cpu,cpu,... runs the "
                         "plain versions on the host)")
    ap.add_argument("--copies", type=int, default=3,
                    help="copies of each of the 6 golden reads")
    args = ap.parse_args(argv)
    if args.devices is not None:
        devices = args.devices.split(",")
    elif torch.cuda.is_available():
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2
    else:
        ap.error("no CUDA device is available; pass --devices cpu,cpu,cpu "
                 "to run the mesh on the host")
    src = datasets.dataset(GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB)
    with tempfile.TemporaryDirectory(prefix="f5c_mesh_") as tmp:
        paths = datasets.replicate_dataset(src, tmp, args.copies)
        res = run_mesh_parity(paths, devices)
    print(f"[mesh_check] align+meth+eventalign wall: single-device "
          f"{res['single_s']:.2f}s, {len(devices)} slots "
          f"{res['sharded_s']:.2f}s [slots of one device: dispatch "
          f"overhead, not a speedup]")
    print(f"[mesh_check] eventalign sharded == single byte-for-byte "
          f"({res['ea_rows']} TSV rows, {res['rounds']} rounds)")
    print("[mesh_check] per-device H2D accounting (sharded run):")
    print(mesh.transfer_table())
    print(f"[mesh_check] parts per slot: {res['slots']}")
    print(f"[mesh_check] OK: {res['reads']} reads, sharded == single "
          f"bit-for-bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
