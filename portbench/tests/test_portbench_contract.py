"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of cells, configurations and metrics by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from pbtest import ROOT, with_pending

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    return registry.benchmark(ROOT)


@pytest.mark.parametrize("pending", [False, True])
def test_keys_names_and_units(pending):
    b = with_pending(bench()) if pending else bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("pending", [False, True])
def test_metric_files_declare_their_entries(pending):
    b = with_pending(bench()) if pending else bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            mod = registry.metric(m["name"])
            assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
                m["unit"], m["better"], m["source"])
            if kind == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
                assert m["moves"] in e2e
    for w in b["workloads"]:
        assert registry.metrics_of(b, w["name"], "per_layer")
        assert len(registry.metrics_of(b, w["name"], "end_to_end")) >= 2


@pytest.mark.parametrize("pending", [False, True])
def test_cells_and_configs_found_by_name(pending):
    b = with_pending(bench()) if pending else bench()
    # every cell has its file; a cell's files may come before its entry
    assert {w["name"] for w in b["workloads"]} <= set(registry.cells())
    for w in b["workloads"]:
        cell = registry.cell(b, w["name"])
        config = registry.config(cell["config"])
        assert config["name"] == cell["config"]
        assert registry.generator(cell["generator"]).generate
        # each key of a cell is kept in one place
        assert not set(registry._json("workloads", w["name"])) & set(w)
        assert set(cell["check"]["limits"]) <= {"site_dev_pct",
                                                "row_dev_pct"}


def test_a_cell_added_as_files_alone(tmp_path):
    """A copy of the benchmark with one more cell file and its
    BENCHMARK.json entry: the harness finds it, and every existing file
    is left as it was."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    with open(tmp_path / "portbench/workloads/meth-r9-typical.json") as f:
        src = json.load(f)
    src["pool"]["reads"] = 10
    with open(tmp_path / "portbench/workloads/meth-r9-new.json", "w") as f:
        json.dump(src, f)
    b["workloads"].append({"name": "meth-r9-new", "config": "r9-dna-cpg",
                           "traffic": "new", "chips": 1, "why": "a test"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    code = ("from portbench import registry; b = registry.benchmark(); "
            "c = registry.cell(b, 'meth-r9-new'); "
            "print(c['pool']['reads'], registry.config(c['config'])['name'],"
            " len(registry.metrics_of(b, 'meth-r9-new', 'per_layer')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    n_meth = len(registry.metrics_of(b, "meth-r9-typical", "per_layer"))
    hmm = [m for m in b["per_layer"] if "workloads" in m
           and "meth-r9-typical" in m["workloads"]]
    assert out.stdout.split() == ["10", "r9-dna-cpg",
                                  str(n_meth - len(hmm))]


def test_harness_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "meth-r9-typical", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_harness_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's
    files: no result, a nonzero exit."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "meth-r9-typical", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_no_jax_and_a_reference_apart_from_the_program():
    """The harness and the reference load no module named jax, jaxlib
    or f5c_tpu (whole top-level names); the reference loads nothing of
    f5c_tpu_torch."""
    code = ("import sys; import portbench.run, portbench.check, "
            "portbench.trace, portbench.work, portbench.driver; "
            "from portbench.reference import pipeline, eventalign; "
            "from portbench.generators import genomic_dna, transcripts_rna;"
            " top = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'f5c_tpu', "
            "'f5c_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; import f5c_tpu_torch.pipeline.runner, "
            "f5c_tpu_torch.pipeline.eventalign, f5c_tpu_torch.cli; "
            "import portbench.run as r; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
