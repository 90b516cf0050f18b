"""Cells, configurations, mixes and metrics are files found by name, and
BENCHMARK.json keeps to the contract's shapes."""
import json
import os
import re
import time

import pytest

from conftest import ROOT, TINY
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_a_new_cell_from_files_alone(tmp_path, tiny_bench):
    """A configuration, a mix, a metric and a cell added as files and
    entries, with no edit to the harness."""
    base = tmp_path / "bench"
    for sub in ("traffic", "metrics", "limits", "configs"):
        (base / sub).mkdir(parents=True)
    with open(os.path.join(ROOT, TINY["fem2d_p2_L7"])) as fh:
        cfg = json.load(fh)
    cfg["level"] = 2
    (base / "configs" / "p2_L2.json").write_text(json.dumps(cfg))
    (base / "traffic" / "calm.json").write_text(json.dumps({
        "study": {"size": 2, "seed": 1},
        "load": {"base": 0.5, "amplitude": 0.1, "modes": 1,
                 "max_wavenumber": 1},
        "dirichlet": {"amplitude": 0.1, "modes": 1, "max_wavenumber": 1},
        "slack_start": 100.0}))
    (base / "metrics" / "answers.py").write_text(
        "def read(run):\n    return float(run.solves)\n")
    (base / "limits" / "p2_L2.calm.json").write_text(json.dumps(
        {"s_gap": 1e-3, "u_res": 1e-3, "bc": 0.0}))
    bench = {
        "configs": [{"name": "p2_L2", "file": str(base / "configs" /
                                                  "p2_L2.json")}],
        "workloads": [{"name": "p2_L2.calm", "config": "p2_L2",
                       "traffic": "calm", "chips": 1}],
        "end_to_end": [{"name": "answers", "unit": "solves"}],
        "per_layer": []}
    cell = harness.find_cell(bench, "p2_L2.calm", root=ROOT, base=str(base))
    result, _ = harness.run(cell, 3, 0.2, False, time.time(), device="cpu",
                            log=lambda *a: None)
    assert result["correct"]
    assert result["metrics"]["answers"]["value"] >= 1


def test_metric_readers_found_by_name():
    for name in ("newton.its.dev", "newton.its.host", "setup.host_s",
                 "k5a_roofline.dev", "device.idle.host"):
        assert callable(harness.reader(name))
    with pytest.raises(SystemExit):
        harness.reader("no.such.metric")


def test_benchmark_json_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["reduced"] == []
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "limits", w["name"] + ".json"))
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= cells
        harness.reader(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for w in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert w in reported
    for w in cells:
        mine = [m for m in bench["end_to_end"]
                if w in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
    assert len(json.dumps(bench)) <= 64 * 1024
