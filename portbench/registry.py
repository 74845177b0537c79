"""Everything of one cell, found by name: ``BENCHMARK.json`` at the root
of the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``generators/<generator>.py`` and ``metrics/<metric>.py``.  A cell, a
configuration, a generator or a metric is added as files and entries;
no file here names them."""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def benchmark(root: str = ".") -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def cell(bench: dict, name: str) -> dict:
    """The cell's file (its generator, pool and check) with its entry in
    BENCHMARK.json (its name, configuration, traffic, chips and why),
    each key kept in one of the two."""
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    out = _json("workloads", name)
    out.update(entry[0])
    return out


def cells() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "workloads"))
                  if f.endswith(".json"))


def generator(name: str):
    return importlib.import_module(f"portbench.generators.{name}")


def metric(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``kind`` (end_to_end or per_layer) metrics that ``cell_name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
