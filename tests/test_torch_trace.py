"""PyTorch port, the spans and counters of ``utils/trace.py`` on the CPU.

Two fem2d_P2 L=2 solves under ``torch.profiler`` (CPU activity): one from
a feasible start with the nested-dissection branch on its top level
(``DENSE_MAX`` low), one from an infeasible start (phase I) on dense
levels.

- every span of the port appears, and every occurrence lies inside the
  span it belongs to (``driver.prolong`` in ``driver.main`` in
  ``driver.solve``, ``linsolve.nd_factor.fronts`` in
  ``linsolve.nd_factor``, ...);
- every span name, in the traces and in the port's source, begins with a
  layer: ``driver``, ``setup``, ``newton``, ``linsolve``, ``levelfn``;
- with no profiler a solve enters no ``record_function``, keeps no record,
  and a span is the one shared no-op context; a traced solve reads on the
  host what the untraced one does (the same ``.item()``, ``bool``,
  ``float``, ``.cpu()`` calls, the same ``newton.SYNCS``);
- a solve's record holds the deltas of ``kernels.launches()`` and
  ``newton.SYNCS`` over it, and the enqueue time by kernel;
- the first solve of a problem builds its solver, panel operators and
  large-level context, and a second builds nothing.
"""
import ast
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mgbtpu_torch as mt
from mgbtpu_torch import kernels
from mgbtpu_torch.ops import ndchol
from mgbtpu_torch.solver import mgb as MGB
from mgbtpu_torch.solver import newton
from mgbtpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ("driver", "setup", "newton", "linsolve", "levelfn")

# span -> the spans one of which encloses each of its occurrences (None:
# no span of the port encloses it)
NESTING = {
    "driver.solve": None,
    "setup.assemble": None,
    "driver.main": ("driver.solve",),
    "driver.phase1": ("driver.solve",),
    "driver.apply_D": ("driver.solve",),
    "driver.to_device": ("driver.solve",),
    "driver.matched_t": ("driver.solve",),
    "setup.plans": ("driver.main", "driver.phase1", "driver.matched_t"),
    "driver.prolong": ("driver.main", "driver.phase1"),
    "driver.to_host": ("driver.main", "driver.phase1"),
    "newton": ("driver.main", "driver.phase1"),
    "newton.linesearch": ("newton",),
    "newton.sync": ("driver.solve",),
    "linsolve.precondition": ("newton", "driver.matched_t"),
    "linsolve.cg": ("newton", "driver.matched_t"),
    "linsolve.dense": ("newton", "driver.matched_t"),
    "linsolve.nd_factor": ("linsolve.precondition",),
    "linsolve.nd_factor.fronts": ("linsolve.nd_factor",),
    "linsolve.nd_solve": ("linsolve.cg",),
    "levelfn.f0": ("newton", "driver.matched_t"),
    "levelfn.f1": ("newton", "driver.matched_t"),
    "levelfn.f2": ("newton", "driver.matched_t"),
    "levelfn.f2.node_factors": ("levelfn.f2",),
}


def _mg():
    return mt.amg(mt.subdivide(mt.fem2d_P2(), 2))


def _problem(mg, infeasible):
    prob = mt.assemble(mg, p=1.0, device="cpu")
    if infeasible:
        g = prob.g_grid.copy()
        g[:, 1] = 0.0            # slack 0: the start violates the cone
        prob = mt.assemble(mg, p=1.0, device="cpu", g_grid=g)
    return prob


def _spans(prof):
    """[(name, (enclosing names, innermost first))] of the user spans."""
    ev = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()), key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for t0, t1, name in ev:
        while stack and stack[-1][1] <= t0:
            stack.pop()
        out.append((name, tuple(s[2] for s in reversed(stack))))
        stack.append((t0, t1, name))
    return out


@pytest.fixture(scope="module")
def traced():
    """The spans of the two traced solves (assembly included) and their
    records."""
    spans, records = [], []
    dense_max = MGB.ProblemKernels.DENSE_MAX
    try:
        for dm, infeasible in ((32, False), (dense_max, True)):
            MGB.ProblemKernels.DENSE_MAX = dm
            mg = _mg()
            n0 = trace.SEQ["n"]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                sol = mt.mgb_solve(_problem(mg, infeasible), device="cpu")
            assert (sol.SOL_feasibility is not None) == infeasible
            spans += _spans(prof)
            records += [r for r in trace.solves() if r["seq"] > n0]
    finally:
        MGB.ProblemKernels.DENSE_MAX = dense_max
    return spans, records


@pytest.mark.parametrize("name", sorted(NESTING))
def test_span_appears_where_it_belongs(traced, name):
    spans, _ = traced
    seen = [up for n, up in spans if n == name]
    assert seen, f"{name} never recorded"
    within = NESTING[name]
    for up in seen:
        if within is None:
            assert not [u for u in up if u.startswith(LAYERS)], up
        else:
            assert any(w in up for w in within), (name, up)
            if name != "driver.solve":
                assert "driver.solve" in up or name == "setup.assemble"


def test_traced_names_begin_with_a_layer(traced):
    spans, _ = traced
    names = {n for n, _ in spans}
    assert names == set(NESTING)
    for n in names:
        assert n.split(".")[0] in LAYERS


def _source_span_names():
    """Every name the port's source hands to ``span``/``spanned`` (string
    literals, or module constants that hold one)."""
    out = []
    for d, _, files in os.walk(os.path.join(ROOT, "mgbtpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tree = ast.parse(open(path).read(), filename=path)
            consts = {t.id: n.value.value for n in tree.body
                      if isinstance(n, ast.Assign)
                      and isinstance(n.value, ast.Constant)
                      for t in n.targets if isinstance(t, ast.Name)}
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", None)
                if fname not in ("span", "spanned", "record_function"):
                    continue
                a = node.args[0]
                if isinstance(a, ast.Constant):
                    out.append((f, a.value))
                elif isinstance(a, ast.Name) and a.id in consts:
                    out.append((f, consts[a.id]))
                elif f != "trace.py":
                    out.append((f, ast.dump(a)))
    return out


def test_source_span_names_begin_with_a_layer():
    found = _source_span_names()
    names = {n for _, n in found}
    assert set(NESTING) - {"driver.solve"} <= names
    for f, n in found:
        assert isinstance(n, str) and n.split(".")[0] in LAYERS, (f, n)


def test_untraced_solve_enters_no_span(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    for mod in (trace, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refuse)
    assert trace.span("driver.x") is trace.span("newton.y")
    before = trace.solves()
    sol = mt.mgb_solve(_problem(_mg(), False), device="cpu")
    assert np.all(np.isfinite(sol.z))
    assert trace.solves() == before


def test_tracing_reads_nothing_more_on_the_host(monkeypatch):
    """The same host reads of device values, traced or not."""
    prob = _problem(_mg(), False)
    mt.mgb_solve(prob, device="cpu")            # builds the plans
    count = {"n": 0}
    for attr in ("item", "__bool__", "__float__", "__int__", "tolist",
                 "cpu", "numpy"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, **k):
            count["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, attr, counted)
    reads = []
    for traced_run in (False, True):
        count["n"] = 0
        s0 = newton.SYNCS["n"]
        if traced_run:
            with profile(activities=[ProfilerActivity.CPU]):
                mt.mgb_solve(prob, device="cpu")
        else:
            mt.mgb_solve(prob, device="cpu")
        reads.append((count["n"], newton.SYNCS["n"] - s0))
    assert reads[0] == reads[1] and reads[0][1] > 0


def test_record_holds_the_counters_deltas(monkeypatch):
    """Launches (counted here by a stand-in for K5b's card path, which
    the CPU's plain version does not count) and syncs."""
    def counting(fn):
        def call(*a, **k):
            kernels.front_solve.launches += 1
            return fn(*a, **k)
        return call

    for name in ("front_forward", "front_backward"):
        monkeypatch.setattr(ndchol, name, counting(getattr(ndchol, name)))
    monkeypatch.setattr(MGB.ProblemKernels, "DENSE_MAX", 32)
    prob = _problem(_mg(), False)
    l0, s0 = kernels.launches(), newton.SYNCS["n"]
    with profile(activities=[ProfilerActivity.CPU]):
        mt.mgb_solve(prob, device="cpu")
    l1, s1 = kernels.launches(), newton.SYNCS["n"]
    rec = trace.solves()[-1]
    assert rec["seq"] == trace.SEQ["n"]
    assert rec["launches"] == {k: l1[k] - l0[k] for k in l1}
    assert rec["launches"]["front_solve"] > 0
    assert rec["syncs"] == s1 - s0 > 0
    assert set(rec["enqueue_ns"]) <= set(kernels.WRAPPERS)
    assert rec["enqueue_ns"]["front_solve"] > 0
    assert rec["transfers"] == {"gathers": 0, "broadcasts": 0, "bytes": 0}


@pytest.mark.parametrize("solve", ["first", "second"])
def test_builds_of_a_solve(monkeypatch, solve):
    monkeypatch.setattr(MGB.ProblemKernels, "DENSE_MAX", 32)
    prob = _problem(_mg(), False)
    if solve == "second":
        mt.mgb_solve(prob, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        mt.mgb_solve(prob, device="cpu")
    builds = trace.solves()[-1]["builds"]
    if solve == "second":
        assert not any(builds.values()), builds
    else:
        for what in ("problem_kernels", "panel_ops", "large_context"):
            assert builds[what] >= 1, builds
