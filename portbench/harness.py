"""The benchmark's run: one cell of ``BENCHMARK.json`` on the card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` builds the cell's configuration once (``subdivide``, ``amg``,
``assemble``), warms it up with one solve of the mix's warm-up load (the
study's first unless the mix names another), which builds every plan and
kernel the window uses, then sends the mix's study of loads in a closed
loop with one client: a request is made and sent when ``mgb_solve`` has
returned the last one's host arrays. The window is whole
passes over the study, each in an order drawn from the seed, and ends with
the first pass that finishes after ``--seconds`` (a traced run: its first
pass), so that every run does the same work from the same state. Once it has
closed, the run solves its probe, a request whose data come from the seed,
and the plain reference (``reference/``) judges every answer, the probe's
too.

Everything of one configuration, mix or metric lives in files of its own
that the harness finds by name: ``configs/`` (the file ``BENCHMARK.json``
names), ``traffic/<mix>.json``, ``metrics/<metric>.py`` (trailing dotted
parts dropped until a file matches: ``newton.its.dev`` reads
``newton.its.py``) and ``limits/<cell>.json``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mgbtpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each module's name compared whole up to its first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_benchmark(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    base: str = HERE        # the folder of traffic/, metrics/ and limits/


def _reported(metrics, cell_name, e2e_names=None):
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


def find_cell(bench: dict, workload: str, root=ROOT, base=HERE) -> Cell:
    """The cell ``workload`` of ``bench`` with its configuration (the file
    ``bench`` names, under ``root``), its mix and limits (under ``base``)
    and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _read_json(os.path.join(root, cfg_entry["file"]))
    mix = _read_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    path = os.path.join(base, "limits", f"{workload}.json")
    limits = _read_json(path) if os.path.exists(path) else {}
    e2e = _reported(bench["end_to_end"], workload)
    per_layer = _reported(bench["per_layer"], workload,
                          {m["name"] for m in e2e})
    return Cell(workload, int(w["chips"]), cfg, mix, limits, e2e, per_layer,
                base)


def reader(name: str, base=HERE):
    """``read(run)`` of metric ``name``, from ``base``/metrics."""
    parts = name.split(".")
    while parts:
        path = os.path.join(base, "metrics", ".".join(parts) + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + "_".join(parts), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
        parts.pop()
    raise SystemExit(f"portbench: no reader for metric {name!r} under "
                     f"{os.path.join(base, 'metrics')}")


@dataclass
class Run:
    """What a run measured, for the metric readers. Times in seconds; the
    lists hold one entry a solve completed in the window."""

    setup_s: float = 0.0
    setup_host_s: float = 0.0
    setup_plans_s: float = 0.0
    window_s: float = 0.0
    solves: int = 0
    peak_window_bytes: int | None = None
    its: list = field(default_factory=list)
    cg: list = field(default_factory=list)
    syncs: list = field(default_factory=list)
    traced: object = None        # trace.Reduced of a traced run
    factor_calls: list = field(default_factory=list)
    solve_calls: list = field(default_factory=list)

    def per_solve(self, values):
        return float(np.mean(values)) if values else None


def _element(mt, cfg):
    return getattr(mt, cfg["element"])(**cfg.get("element_args", {}))


def _card(chips):
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", log=None):
    """Run ``cell``; returns (result dict, check lines)."""
    import torch

    import mgbtpu_torch as mt
    from mgbtpu_torch.solver import newton

    from . import generator, reference
    from .reference import certify

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cfg, on_card = cell.cfg, device == "cuda"
    spans = None
    if trace:
        from . import trace as tr

        spans = tr.Spans().install()
    res = Run()

    # -- set-up: the configuration, its reference nodes, one warm-up solve
    # (the mix's warm-up load), which builds every plan. The reference's
    # discretization is the check's, not the program's: its seconds are
    # left out of setup_s.
    t0 = time.time()
    disc = reference.build(cfg)
    mix = generator.Mix(cell.mix, disc.x, seed)
    reference_s = time.time() - t0
    if on_card:
        from mgbtpu_torch import kernels

        kernels.build_all()
    t0 = time.time()
    mg = mt.amg(mt.subdivide(_element(mt, cfg), int(cfg["level"])))
    f, g = mix.request(mix.warmup)
    prob = mt.assemble(mg, p=float(cfg["p"]), f_grid=f, g_grid=g,
                       device=device)
    M, Q = prob.M, prob.Q
    res.setup_host_s = time.time() - t0
    solve_kw = dict(device=device, tol=float(cfg["tol"]))
    t0 = time.time()
    mt.mgb_solve(prob, **solve_kw)
    if on_card:
        torch.cuda.synchronize()
    res.setup_plans_s = time.time() - t0
    log(f"[setup] seed {seed}; host {res.setup_host_s:.3f} s, warm-up "
        f"solve {res.setup_plans_s:.3f} s; the reference's nodes "
        f"{reference_s:.3f} s (not set-up)")

    # -- the window: whole passes over the study, the last one ending after
    # ``seconds`` (a traced run: one pass)
    setup_peak = None
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        spans.active = True
        window_span = record_function(tr.SPAN_WINDOW)
        window_span.__enter__()
    attempted = failed = 0
    answers = []
    sol = None
    w0 = time.time()
    res.setup_s = w0 - t_start - reference_s
    n_pass = 0
    while True:
        for index in mix.order(n_pass):
            f, g = mix.request(int(index))
            prob = mt.assemble(mg, p=float(cfg["p"]), M=M, Q=Q, f_grid=f,
                               g_grid=g, device=device)
            newton.SYNCS["n"] = 0
            attempted += 1
            t0 = time.time()
            try:
                sol = mt.mgb_solve(prob, **solve_kw)
            except mt.MGBConvergenceFailure as err:
                failed += 1
                log(f"[request] {index} failed: {err}")
                continue
            S, F = sol.SOL_main, sol.SOL_feasibility
            res.its.append(int(S["its"].sum())
                           + (int(F["its"].sum()) if F else 0))
            res.cg.append(int(S["cg"].sum()) + (int(F["cg"].sum()) if F
                                                 else 0))
            res.syncs.append(int(newton.SYNCS["n"]))
            answers.append((int(index), np.array(sol.z, dtype=np.float64)))
            log(f"[request] pass {n_pass} load {index}: "
                f"{time.time() - t0:.3f} s, {res.its[-1]} its, "
                f"{res.cg[-1]} CG")
        n_pass += 1
        if trace or time.time() - w0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    res.window_s = time.time() - w0
    res.solves = len(res.its)
    if trace:
        window_span.__exit__(None, None, None)
        spans.active = False
        prof.__exit__(None, None, None)
    memory_peak = None
    if on_card:
        res.peak_window_bytes = int(torch.cuda.max_memory_allocated())
        memory_peak = max(setup_peak, res.peak_window_bytes)
    if trace:
        t0 = time.time()
        res.traced = tr.reduce(prof)
        res.factor_calls, res.solve_calls = spans.factor_calls, \
            spans.solve_calls
        log(f"[trace] reduced in {time.time() - t0:.3f} s; window "
            f"{res.traced.window_s:.6f} s, device busy "
            f"{res.traced.busy_s:.6f} s; {res.traced.ops} device ops, "
            f"{res.traced.ops_launched} with their launch found")
        del prof
        spans.uninstall()

    # -- the probe: fresh data from the seed, for the check alone
    f, g = mix.request(mix.PROBE)
    attempted += 1
    try:
        sol = mt.mgb_solve(mt.assemble(mg, p=float(cfg["p"]), M=M, Q=Q,
                                       f_grid=f, g_grid=g, device=device),
                           **solve_kw)
        answers.append((mix.PROBE, np.array(sol.z, dtype=np.float64)))
    except mt.MGBConvergenceFailure as err:
        failed += 1
        log(f"[request] probe failed: {err}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"], cell.base)(res)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- the program's state goes before the reference runs
    del prob, sol, M, Q, mg
    mt.mgb_cleanup()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    worst = {k: 0.0 for k in cell.limits}
    t = 1.0 / float(cfg["tol"])
    for index, z in answers:
        f, g = mix.request(index)
        got = certify.readings(disc, f, g, z, t)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    correct = failed == 0 and res.solves > 0 and bool(cell.limits) and all(
        worst[k] <= lim for k, lim in cell.limits.items())
    checks = {k: {"value": worst[k], "limit": lim}
              for k, lim in cell.limits.items()}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res.traced.busy_s
        dev["window_s"] = res.traced.window_s
        result["breakdown"] = {"device_ops": tr.top(res.traced.op_s),
                               "idle_gaps": tr.top(res.traced.idle_s)}
    result["checks"] = checks
    lines = [f"[check] {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    # last, once the readers and the reference have run: whatever they or
    # the program loaded is in sys.modules by now
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return result, lines


class ForbiddenImport(RuntimeError):
    pass


def main(argv, t_start):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(load_benchmark(), args.workload)
    why = _card(cell.chips)
    if why:
        print(f"portbench: no run: {why}", file=sys.stderr)
        return 3
    print(f"[card] {_power_limit()}", file=sys.stderr, flush=True)
    try:
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                            t_start)
    except ForbiddenImport as err:
        print(f"portbench: forbidden modules loaded: {list(err.args[0])}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
