"""The run's last line on the CPU at tiny levels, and the refusals: no
result without a card, none without the program."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT


def _run(tiny_bench, workload, trace, seed=2 ** 31 + 11):
    from portbench import harness

    cell = harness.find_cell(tiny_bench, workload)
    return harness.run(cell, seed, 0.5, trace, time.time(), device="cpu",
                       log=lambda *a: None)


@pytest.mark.parametrize("workload", ["fem3d_q3_L5.solve_stream",
                                      "fem2d_p2_L7.phase1_stream"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys_and_types(tiny_bench, workload, trace):
    result, lines = _run(tiny_bench, workload, trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in result) == trace
    assert result["correct"] is True
    assert isinstance(result["attempted"], int) and result["attempted"] >= 1
    assert result["failed"] == 0
    for name, m in result["metrics"].items():
        assert isinstance(m["value"], float) and isinstance(m["unit"], str)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][part]) <= 10
        names = set(result["metrics"])
        assert {"setup.host_s", "setup.plans_s"} <= names
        assert any(n.startswith("newton.its.") for n in names)
    else:
        assert "setup_s" in result["metrics"]
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    assert len(lines) == len(result["checks"])
    json.dumps(result)


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and
    prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "fem2d_p2_L7.solve_stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a folder of BENCHMARK.json and the benchmark's paths alone the
    command fails and prints no result."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload",
         bench["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
