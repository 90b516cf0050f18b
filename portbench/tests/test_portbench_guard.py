"""The import guard: top-level names compared whole, a run that loaded
JAX or the JAX package refused, and no file of the benchmark importing
them."""
import ast
import os
import sys
import time
import types

import pytest

from conftest import ROOT
from portbench import harness


@pytest.mark.parametrize("names,found", [
    (["mgbtpu_torch", "mgbtpu_torch.ops.ndchol", "torch", "numpy"], []),
    (["jaxtyping", "flaxen", "mgbtpu_tools"], []),
    (["mgbtpu"], ["mgbtpu"]),
    (["mgbtpu.solver.mgb"], ["mgbtpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_names_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


@pytest.mark.parametrize("name", ["mgbtpu", "jax", "jaxlib"])
def test_a_run_that_loaded_them_gives_no_result(tiny_bench, monkeypatch,
                                                name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    cell = harness.find_cell(tiny_bench, "fem2d_p2_L7.solve_stream")
    with pytest.raises(harness.ForbiddenImport):
        harness.run(cell, 5, 0.1, False, time.time(), device="cpu",
                    log=lambda *a: None)


@pytest.mark.parametrize("stage", ["reader", "reference"])
def test_a_module_loaded_after_the_window_is_caught(tiny_bench, monkeypatch,
                                                   stage):
    """A metric's reader or the reference that loads JAX once the window
    has closed still leaves the run without a result."""
    from portbench.reference import certify

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if stage == "reader":
        read = harness.reader

        def reader(name, base=harness.HERE):
            inner = read(name, base)
            return lambda run: (load_jax(), inner(run))[1]

        monkeypatch.setattr(harness, "reader", reader)
    else:
        readings = certify.readings
        monkeypatch.setattr(certify, "readings",
                            lambda *a: (load_jax(), readings(*a))[1])
    cell = harness.find_cell(tiny_bench, "fem2d_p2_L7.solve_stream")
    with pytest.raises(harness.ForbiddenImport):
        harness.run(cell, 5, 0.1, False, time.time(), device="cpu",
                    log=lambda *a: None)


def test_the_program_passes(tiny_bench):
    cell = harness.find_cell(tiny_bench, "fem2d_p2_L7.solve_stream")
    result, _ = harness.run(cell, 5, 0.1, False, time.time(), device="cpu",
                            log=lambda *a: None)
    assert result["correct"]
    assert "mgbtpu_torch" in sys.modules
    assert harness.forbidden_modules() == []


def test_no_file_of_the_benchmark_imports_them():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                if harness.forbidden_modules(mods):
                    bad.append((path, mods))
    assert bad == []
