"""BENCHMARK.json against the rules its files are held to, and every name
in it resolved to its file."""

import importlib
import json
import os

import pytest

from portbench import check, manifest

CELLS = ("go1_imu.mc256", "go1_kin_points.mc128", "go1_imu.mc256_c8")


@pytest.fixture
def doc(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_references(doc):
    assert manifest.problems(doc) == []
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    for w in doc["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}


def test_bad_names_are_found():
    bad = {"configs": [{"name": "a b", "reduced": ["x/y"]}],
           "workloads": [{"name": "c", "config": "nope", "traffic": "t"}],
           "end_to_end": [{"name": "m", "unit": "tokens per s", "workloads": ["zz"]}],
           "per_layer": [{"name": "m", "unit": "ms"}]}
    found = " | ".join(manifest.problems(bad))
    for what in ("bad name 'a b'", "bad unit", "used 2 times", "no config", "no cell 'zz'",
                 "bad reduced key"):
        assert what in found


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(root, cell):
    man = manifest.Manifest(root)
    w = man.cell(cell)
    cfg = man.config(w["config"])
    traffic = man.traffic(w["traffic"])
    assert {"replicas", "scans_per_call", "noise_scale", "sequence_s", "checked_calls"} <= set(traffic)
    assert set(check.load_limits(root, cell)) <= set(check.NUMBERS)
    assert cfg["reduced"] == [c for c in man.doc["configs"] if c["name"] == w["config"]][0]["reduced"]
    for m in man.metrics(cell, False) + man.metrics(cell, True):
        assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)
    names = {m["name"] for m in man.metrics(cell, False)}
    assert "setup_s" in names and len(names) >= 2 and man.metrics(cell, True)


@pytest.mark.parametrize("name,points", [("go1_imu", False), ("go1_kin_points", True)])
def test_config_is_the_bench_configuration(root, name, points):
    """A configuration file builds what runner.bench_config() builds (the
    per-point one with kinematics on) with the map of leg_fusion.yaml
    (probe 8, caps 4,096; 2^17 slots on the per-point path, 2^16 on the
    fused one) and the port's default claim rounds and refit budget, but
    the yaml's output switches."""
    import dataclasses

    from legkilo_torch.config import from_dict
    from legkilo_torch.runner import bench_config, bench_config_points

    doc = manifest.Manifest(root).config(name)
    got = dataclasses.asdict(from_dict(doc["settings"]))
    want = bench_config_points() if points else bench_config()
    want.only_imu_use = not points
    want.voxel_map.capacity_log2 = 17 if points else 16
    want.voxel_map.probe_length = 8
    want.voxel_map.insert_rounds = 6
    want.voxel_map.refit_budget = 2048
    want.tpu.insert_cap = want.tpu.match_cap = 4096
    want = dataclasses.asdict(want)
    got.pop("pub_joint_tf_enable"), want.pop("pub_joint_tf_enable")
    assert got == want
    assert doc["precision"] == {"dtype": "float32", "tf32": False}


def test_reduced_lists_every_changed_source_key(root):
    """Every key of the upstream yaml whose value the configuration changes
    is listed in ``reduced``."""
    from legkilo_torch.config import _parse_flat_yaml

    src = _parse_flat_yaml(os.path.join(root, "configs", "leg_fusion.yaml"))
    man = manifest.Manifest(root)
    for name in man.configs:
        doc = man.config(name)
        changed = {k for k, v in src.items() if doc["settings"].get(k) != v}
        assert changed == set(doc["reduced"]), name
