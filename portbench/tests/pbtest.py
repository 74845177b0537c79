"""Shared helpers of the benchmark's tests: small versions of the cells
that the CPU runs through the program's plain versions."""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small(cell_name: str, reads: int = 6, median: float = 1500.0,
          batch_reads: int = 3):
    """(bench, cell, config) of ``cell_name`` at a size the CPU holds: a
    300 kb genome or 30 transcripts, ``reads`` reads around ``median``
    bases, batches of ``batch_reads``."""
    from portbench import registry

    bench = with_pending(registry.benchmark(ROOT))
    cell = copy.deepcopy(registry.cell(bench, cell_name))
    config = copy.deepcopy(registry.config(cell["config"]))
    if "genome" in config:
        config["genome"]["bases"] = 300_000
    if "transcriptome" in config:
        config["transcriptome"]["transcripts"] = 30
    cell["pool"].update(reads=reads, median=median, sigma=0.3,
                        min=median / 2, max=median * 2)
    cell["check"].update(sample_reads=reads, sample_max_bases=10 ** 7)
    config["options"]["batch_reads"] = batch_reads
    return bench, cell, config


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of the cells in ``pending_cells.json``
    that it does not hold yet."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "pending_cells.json")) as f:
        pending = json.load(f)
    bench = copy.deepcopy(bench)
    names = {w["name"] for w in bench["workloads"]}
    for name, p in pending.items():
        if name == "about" or name in names:
            continue
        bench["workloads"].append(p["workload"])
        if p["config"]["name"] not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(p["config"])
        have = {m["name"] for m in bench["per_layer"]}
        bench["per_layer"] += [m for m in p["per_layer"]
                               if m["name"] not in have]
    return bench
