"""The port's data-parallel mesh (f5c_tpu_torch/parallel/mesh.py): the
golden set x3 through ``Pipeline(..., devices=[cpu] * D)`` for D = 2, 3
and 8 -- the counterpart of the JAX package's virtual CPU devices
(tests/test_mesh.py) -- must give the single-device run's status, pairs,
scalings, b2e_start, methylation scores and device-engine eventalign TSV
bit for bit, through the sharded dispatches (parallel/mesh_check.py).
A dispatch of fewer than 2 * D items takes the single path, and a slot
with no items is not launched.
"""

import numpy as np
import pytest
import torch

from f5c_tpu_torch import datasets
from f5c_tpu_torch.parallel import mesh, mesh_check

CPU = torch.device("cpu")
_runs: dict = {}


@pytest.fixture(scope="module")
def golden3(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_golden3"))
    src = datasets.dataset(mesh_check.GOLDEN,
                           slow5=datasets.GOLDEN_SIGNALS_ZLIB)
    return datasets.replicate_dataset(src, tmp, 3)


def _run(paths, n_dev):
    """mesh_check.run on ``n_dev`` CPU slots, once a module, with the
    dispatch logs of that run."""
    if n_dev not in _runs:
        mesh.TRANSFER_LOG.clear()
        mesh.SLOT_LOG.clear()
        out, ea, _wall, _rounds = mesh_check.run(paths, [CPU] * n_dev)
        _runs[n_dev] = (out, ea, dict(mesh.TRANSFER_LOG),
                        dict(mesh.SLOT_LOG))
    return _runs[n_dev]


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_sharded_matches_single(golden3, n_dev):
    single, ea_single, log1, slots1 = _run(golden3, 1)
    assert not log1 and not slots1
    out, ea, log, slots = _run(golden3, n_dev)
    mesh_check.compare(single, out)
    assert ea == ea_single
    assert sum(1 for v in single.values() if v[4] is not None) == 18
    assert len(ea.splitlines()) > 1000
    # one wave of 18 reads: the ABEA and its HMM dealt over every slot,
    # and the device engine's rounds of >= 2 * D chunks
    for d in range(n_dev):
        assert slots[f"abea.slot{d}"] == 1
        assert slots[f"hmm.slot{d}"] == 1
        assert slots[f"viterbi_round.slot{d}"] >= 1
    assert log["abea.n_dispatch"] == log["hmm.n_dispatch"] == 1
    assert log["viterbi_pools.n_dispatch"] == 1


def test_per_device_bytes_shrink_with_devices(golden3):
    """The sharded bytes of a dispatch are the batch's, whatever D, so
    each device's share shrinks as 1/D; the replicated model tables stay
    the same."""
    logs = {d: _run(golden3, d)[2] for d in (2, 8)}
    for kind in ("abea", "hmm"):
        a, b = logs[2], logs[8]
        assert a[f"{kind}.replicated_bytes"] == b[f"{kind}.replicated_bytes"]
        assert a[f"{kind}.replicated_bytes"] > 0
        assert abs(a[f"{kind}.sharded_bytes"] - b[f"{kind}.sharded_bytes"]) \
            <= 0.01 * a[f"{kind}.sharded_bytes"]
        share = {d: logs[d][f"{kind}.per_device_bytes"]
                 - logs[d][f"{kind}.replicated_bytes"] for d in (2, 8)}
        assert share[8] < share[2] / 3
    for d, log in logs.items():
        rounds = log["viterbi_round.n_dispatch"]
        assert log["viterbi_round.per_device_bytes"] == pytest.approx(
            log["viterbi_round.sharded_bytes"] / d)
        assert rounds >= 1


def test_small_dispatch_takes_single_path(tmp_path):
    """Six reads over eight slots: every dispatch (6 < 16 reads, rounds
    of at most 6 chunks) runs on the first device, with the single run's
    results; only the re-alignment's pools went up to the mesh's
    devices."""
    paths = datasets.copy_dataset(datasets.dataset(
        mesh_check.GOLDEN, slow5=datasets.GOLDEN_SIGNALS_ZLIB),
        str(tmp_path / "g"))
    single, ea_single, _, _ = mesh_check.run(paths, [CPU])
    mesh.TRANSFER_LOG.clear()
    mesh.SLOT_LOG.clear()
    out, ea, _, _ = mesh_check.run(paths, [CPU] * 8)
    assert not mesh.SLOT_LOG
    assert {k.split(".")[0] for k in mesh.TRANSFER_LOG} == {"viterbi_pools"}
    mesh_check.compare(single, out)
    assert ea == ea_single


def test_slot_without_items_is_not_launched():
    mesh.TRANSFER_LOG.clear()
    mesh.SLOT_LOG.clear()
    calls = []

    def launch(dev, idx, tag):
        calls.append((dev, list(idx), tag))
        return tag, 8 * len(idx)

    slots = [(0, CPU, np.array([0, 2]), "a"), (1, CPU, np.array([], int),
                                                "b"),
             (2, CPU, np.array([1]), "c")]
    res = mesh.on_slots("hmm", slots, launch, 100)
    assert [(d, list(i), r) for d, i, r in res] == [(0, [0, 2], "a"),
                                                    (2, [1], "c")]
    assert [c[2] for c in calls] == ["a", "c"]
    assert mesh.SLOT_LOG == {"hmm.slot0": 1, "hmm.slot2": 1}
    assert mesh.TRANSFER_LOG["hmm.sharded_bytes"] == 24
    assert mesh.TRANSFER_LOG["hmm.per_device_bytes"] == 108
    assert [list(i) for i in mesh.deal(7, 3)] == [[0, 3, 6], [1, 4], [2, 5]]
    # one slot is a single-device launch: launched, and not accounted
    res = mesh.on_slots("hmm", slots[:1], launch, 100)
    assert [(d, list(i), r) for d, i, r in res] == [(0, [0, 2], "a")]
    assert mesh.SLOT_LOG == {"hmm.slot0": 1, "hmm.slot2": 1}
    assert mesh.TRANSFER_LOG["hmm.n_dispatch"] == 1
    # fewer than two items a device: the primary alone
    assert mesh.slot_devices([CPU] * 3, CPU, 5) == [CPU]
    assert mesh.slot_devices([CPU] * 3, CPU, 6) == [CPU] * 3
    assert mesh.slot_devices([], CPU, 100) == [CPU]


def test_data_devices(monkeypatch):
    assert mesh.data_devices(CPU) == []
    assert mesh.data_devices(CPU, [CPU]) == []
    assert mesh.data_devices(CPU, ["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError):
        mesh.data_devices(CPU, [torch.device("meta"), CPU])
    monkeypatch.setenv("F5C_TPU_MESH", "0")
    assert mesh.data_devices(torch.device("cuda", 0)) == []
    # an unindexed "cuda" is the current card, not a second slot of it
    monkeypatch.delenv("F5C_TPU_MESH")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda, c0, c1 = (torch.device("cuda"), torch.device("cuda", 0),
                    torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.data_devices(torch.device("cuda", 0)) == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.data_devices(cuda) == [c1, c0]
    assert mesh.data_devices(c0) == [c0, c1]
    assert mesh.data_devices(cuda, [c1, c0]) == [c1, c0]
    assert mesh.data_devices(cuda, ["cuda"]) == []
    with pytest.raises(ValueError):
        mesh.data_devices(cuda, [c0, c1])
    monkeypatch.setenv("F5C_TPU_MESH", "0")
    assert mesh.data_devices(cuda) == []


def test_mesh_check_runs_on_the_card_unless_asked(monkeypatch):
    """The harness's default mesh is the card's; without a card it
    refuses, and runs on the host only when --devices names CPU slots."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mesh_check.main([])
    assert e.value.code == 2
