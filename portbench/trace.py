"""Spans around the program's layer entries, and the reduction of a
``torch.profiler`` trace to device time by span and by kernel.

Only a traced run (``--trace 1``) calls ``install``: it wraps the entry
points of each layer in ``torch.profiler.record_function`` spans from this
file, before the set-up builds the solver's cached per-level functions, and
records the shapes of every ``nd_factor`` and ``nd_solve`` called while
``Spans.active``. ``reduce`` gives each device operation of the window to the
innermost span open on the host when it was launched.
"""
from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass, field

SPAN_WINDOW = "window"


def _span(name, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _plan_shapes(dp):
    """((nk, a, b) per tree level, n_J, separator updates) of an ND plan."""
    levels = tuple((int(L.nk), int(L.amax), int(L.bmax)) for L in dp.levels)
    updated = sum(int((L.bdofs < dp.n_J).sum()) for L in dp.levels)
    return levels, int(dp.n_J), updated


class Spans:
    """The installed spans; ``factor_calls``/``solve_calls`` list the plan
    shapes of each call made while ``active``."""

    def __init__(self):
        self.active = False
        self.factor_calls = []
        self.solve_calls = []
        self._undo = []
        self._shapes = {}

    def _shapes_of(self, dp):
        key = id(dp)
        if key not in self._shapes:
            self._shapes[key] = (dp, _plan_shapes(dp))
        return self._shapes[key][1]

    def _patch(self, module, attr, new):
        self._undo.append((module, attr, getattr(module, attr)))
        setattr(module, attr, new)

    def install(self):
        from mgbtpu_torch.ops import ndchol
        from mgbtpu_torch.solver import mgb, newton

        def level_fns(barrier, _orig=mgb.make_level_fns):
            f0, f1, f2 = _orig(barrier)
            return (_span("levelfn.f0", f0), _span("levelfn.f1", f1),
                    _span("levelfn.f2", f2))

        def newton_core(*a, _orig=mgb.make_newton_core, **k):
            return _span("newton", _orig(*a, **k))

        def core(*a, _orig=mgb.mgb_core, **k):
            phase = "driver.phase1" if isinstance(k.get("early_stop"), tuple) \
                else "driver.main"
            return _span(phase, _orig)(*a, **k)

        def nd_factor(dp, *a, _orig=ndchol.nd_factor, **k):
            if self.active:
                self.factor_calls.append(self._shapes_of(dp))
            return _span("linsolve.nd_factor", _orig)(dp, *a, **k)

        def nd_solve(dp, *a, _orig=ndchol.nd_solve, **k):
            if self.active:
                self.solve_calls.append(self._shapes_of(dp))
            return _span("linsolve.nd_solve", _orig)(dp, *a, **k)

        self._patch(mgb, "make_level_fns", level_fns)
        self._patch(mgb, "make_newton_core", newton_core)
        self._patch(mgb, "mgb_core", core)
        self._patch(ndchol, "nd_factor", nd_factor)
        self._patch(ndchol, "nd_solve", nd_solve)
        for mod in (newton, mgb):
            for attr, name in (("make_nd_pre", "linsolve.precondition"),
                               ("dense_ir_solve", "linsolve.cg"),
                               ("equilibrated_solve", "linsolve.dense")):
                if hasattr(mod, attr):
                    self._patch(mod, attr, _span(name, getattr(mod, attr)))
        for attr, name in (("make_pcg_pre", "linsolve.precondition"),
                           ("pcg_solve", "linsolve.cg"),
                           ("regularized_direction", "linsolve.dense"),
                           ("_backtracking", "newton.linesearch"),
                           ("_illinois_ls", "newton.linesearch"),
                           ("_item", "newton.sync"),
                           ("_all_finite", "newton.sync")):
            self._patch(newton, attr, _span(name, getattr(newton, attr)))
        return self

    def uninstall(self):
        while self._undo:
            module, attr, old = self._undo.pop()
            setattr(module, attr, old)


@dataclass
class Reduced:
    """A traced window: its length, the device's busy time (the union of
    its operations' intervals), device seconds by innermost span and by
    operation name, and idle seconds by the host's innermost span."""

    window_s: float
    busy_s: float
    ops: int = 0
    ops_launched: int = 0          # device ops whose launch was found
    span_s: dict = field(default_factory=dict)
    op_s: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)

    def span_total(self, prefix: str) -> float:
        return sum(v for k, v in self.span_s.items()
                   if k == prefix or k.startswith(prefix + "."))

    def op_total(self, names) -> float:
        return sum(v for k, v in self.op_s.items()
                   if any(n in k for n in names))


def _short(name: str, span: str) -> str:
    name = name.split("(")[0]
    name = name[5:] if name.startswith("void ") else name
    return name or f"(unnamed, launched in {span})"


class _Innermost:
    """The innermost span open at a time, from spans that nest."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in spans]
        self.spans = spans
        # each span's parent: the last earlier span still open at its start
        self.parent = []
        stack = []
        for i, (a, b, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else "(none)"


def _events(prof):
    """(device ops [(start, end, name, corr)], launches {corr: t},
    host spans [(start, end, name)]) in nanoseconds."""
    from torch.autograd import DeviceType

    dev, launch, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():
            if not on_device:       # the device's copy of a span is no op
                spans.append((t0, t1, e.name()))
        elif on_device:
            dev.append((t0, t1, e.name(), e.correlation_id()))
        elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
            launch[e.correlation_id()] = t0
    return dev, launch, spans


def reduce(prof) -> Reduced:
    dev, launch, spans = _events(prof)
    win = [s for s in spans if s[2] == SPAN_WINDOW]
    if not win:
        raise RuntimeError("trace: the window's span is missing")
    w0, w1 = win[0][0], win[0][1]
    host = _Innermost([s for s in spans if s[2] != SPAN_WINDOW])
    out = Reduced(window_s=(w1 - w0) * 1e-9, busy_s=0.0)
    dev = sorted(d for d in dev if d[1] > w0 and d[0] < w1)
    out.ops = len(dev)
    for t0, t1, name, corr in dev:
        secs = (min(t1, w1) - max(t0, w0)) * 1e-9
        out.ops_launched += corr in launch
        span = host.at(launch.get(corr, t0))
        out.span_s[span] = out.span_s.get(span, 0.0) + secs
        key = _short(name, span)
        out.op_s[key] = out.op_s.get(key, 0.0) + secs
    busy, cur0, cur1 = 0, None, None
    gaps = []
    last = w0
    for t0, t1, _, _ in dev:
        t0, t1 = max(t0, w0), min(t1, w1)
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                last = cur1
            if t0 > last:
                gaps.append((last, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
        last = cur1
    if w1 > last:
        gaps.append((last, w1))
    out.busy_s = busy * 1e-9
    for g0, g1 in gaps:
        name = host.at(g0 + (g1 - g0) // 2)
        out.idle_s[name] = out.idle_s.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def top(d: dict, n=10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
