"""Modeling front end: declarative convex variational problems.

Port of ``mgbtpu/frontends/model.py``: the same declarations, lowering and
duals, on the port's ``amg``/``assemble``/``mgb_solve``; the lowering is
host numpy on both sides. ``Model(mg, device=None)`` keeps the device and
hands it to ``assemble`` and ``mgb_solve`` (the card unless
``device="cpu"``; raises without a card). The one device call of the front
end is the equality duals' per-node barrier gradient (``_reactions``): F1
of ``Q.barrier`` over every node, one mode-1 call with unit weights, a K6
launch on the card (K2 for a lone cone).

The Python-native analog of the reference's JuMP extension
(``ext/MultiGridBarrierJuMPExt``): declare field variables on a MultiGrid,
write affine expressions in them and their derivatives (with spatially
varying coefficients), add epigraph power-cone and linear inequality
constraints (optionally region-restricted), minimize an integral objective,
and read back values and central-path duals.

Example
-------
    m = Model(mg)                       # Model(mg, device="cpu") on the CPU
    u = m.variable("u")                 # conforming (differentiated / BC'd)
    s = m.variable("s", kind="broken")
    m.dirichlet(u, lambda x: x[0]**2)
    m.epigraph(s, [u.dx()], p=1.5)      # s >= |grad u|^1.5
    m.minimize(s + 0.5*u)               # min int s + u/2
    sol = m.solve(tol=1e-6)
    m.value(u), m.dual(con)

Lowering (mirrors the reference ``_lower``/``_piece``,
ext/MultiGridBarrierJuMPExt:801-1007): every variable gets an :id operator
row first (the padding pool), derivatives add rows; each cone becomes a
``convex_euclidian_power``/``convex_linear`` with square-padded distinct
index rows; multiple or region-restricted cones combine via
``convex_piecewise``. Duals are recovered from the central path:
mu_i = 1/(t_end * n * w_i * slack_i) per constraint row
(ext/MultiGridBarrierJuMPExt:1195-1331).
"""
from __future__ import annotations

import numpy as np
import torch

from .._config import resolve_device
from ..convex import convex_euclidian_power, convex_linear, convex_piecewise
from ..solver.mgb import assemble, mgb_solve
from ..utils.errors import MGBConvergenceFailure

_OPS = ("dx", "dy", "dz")


def _as_fn(c):
    if callable(c):
        return c
    return lambda x, c=c: c


class Expr:
    """Affine expression: sum of coef(x) * term + const(x); terms are
    (varname, opsym) pairs."""

    def __init__(self, terms=None, const=None):
        self.terms = dict(terms or {})
        self.const = const

    @staticmethod
    def term(name, op):
        return Expr({(name, op): 1.0})

    def _cmb(self, other, sign):
        out = dict(self.terms)
        if isinstance(other, Expr):
            for k, c in other.terms.items():
                out[k] = _add_coef(out.get(k), c, sign)
            const = _add_const(self.const, other.const, sign)
        else:
            const = _add_const(self.const, other, sign)
        return Expr(out, const)

    def __add__(self, other):
        return self._cmb(other, +1)

    def __radd__(self, other):
        return self._cmb(other, +1)

    def __sub__(self, other):
        return self._cmb(other, -1)

    def __rsub__(self, other):
        return (-self)._cmb(other, +1)

    def __neg__(self):
        return self * (-1.0)

    def __mul__(self, c):
        cf = _as_fn(c) if callable(c) else None
        out = {}
        for k, coef in self.terms.items():
            if cf is None:
                out[k] = _scale_coef(coef, c)
            else:
                out[k] = _prod_coef(coef, cf)
        const = None
        if self.const is not None:
            const = (_scale_coef(self.const, c) if cf is None
                     else _prod_coef(self.const, cf))
        return Expr(out, const)

    __rmul__ = __mul__

    def __ge__(self, other):
        return ("ge", self - other)

    def __le__(self, other):
        # normalized to >=-form; the origin tag fixes the dual sign
        return ("le", _as_expr(other) - self)

    def eval_coef(self, key, x):
        c = self.terms.get(key)
        if c is None:
            return 0.0
        return c(x) if callable(c) else c

    def eval_const(self, x):
        if self.const is None:
            return 0.0
        return self.const(x) if callable(self.const) else self.const


def _as_expr(v):
    if isinstance(v, Expr):
        return v
    return Expr({}, v)


def _add_coef(a, b, sign):
    if a is None:
        return _scale_coef(b, sign)
    if not callable(a) and not callable(b):
        return a + sign * b
    fa, fb = _as_fn(a), _as_fn(b)
    return lambda x: fa(x) + sign * fb(x)


def _add_const(a, b, sign):
    if b is None:
        return a
    if a is None:
        return _scale_coef(b, sign)
    return _add_coef(a, b, sign)


def _scale_coef(c, s):
    if s == 1:
        return c
    if not callable(c):
        return c * s
    return lambda x: c(x) * s


def _prod_coef(c, fn):
    if not callable(c):
        return lambda x: c * fn(x)
    return lambda x: c(x) * fn(x)


class Variable(Expr):
    def __init__(self, model, name, kind):
        super().__init__({(name, "id"): 1.0})
        self.model = model
        self.name = name
        self.kind = kind

    def dx(self):
        return Expr.term(self.name, "dx")

    def dy(self):
        return Expr.term(self.name, "dy")

    def dz(self):
        return Expr.term(self.name, "dz")

    def grad(self):
        d = self.model.dim
        return [Expr.term(self.name, _OPS[i]) for i in range(d)]


class Constraint:
    def __init__(self, kind, data, region, origin=None):
        self.kind = kind      # "epipower" | "linear" | "eq"
        self.data = data
        self.region = region  # None | callable(x)->bool | (v, e) pairs/nodes
        self.origin = origin  # "ge" | "le" (dual sign convention)
        self.index = None     # piece index after lowering


def _pairs_to_flat(pairs, V):
    """(v, e) pairs or flat broken-node indices -> flat index array."""
    pairs = list(pairs)
    if not pairs:
        return np.zeros(0, dtype=np.int64)
    first = pairs[0]
    if isinstance(first, (tuple, list, np.ndarray)) and len(first) == 2:
        return np.array([int(e) * V + int(v) for v, e in pairs],
                        dtype=np.int64)
    return np.asarray(pairs, dtype=np.int64)


class Model:
    """Declarative convex variational model on a MultiGrid hierarchy."""

    def __init__(self, mg, device=None):
        self.mg = mg
        self.device = device
        self.dim = mg.geometry.discretization.dim
        self.variables: dict = {}
        self.constraints: list[Constraint] = []
        self.objective: Expr | None = None
        self._dirichlet: dict = {}
        self._start: dict = {}
        self.sol = None
        self._lowered = None
        self.status = "not_solved"

    # -- declaration ------------------------------------------------------
    def variable(self, name, kind="auto", start=None):
        """Field variable. kind: "auto" (conforming when differentiated or
        Dirichlet-constrained, else broken), "broken", "continuous",
        "uniform"."""
        if name in self.variables:
            raise ValueError(f"duplicate variable {name}")
        v = Variable(self, name, kind)
        self.variables[name] = v
        if start is not None:
            self._start[name] = _as_fn(start)
        return v

    def dirichlet(self, var, value, nodes=None):
        """Dirichlet boundary values for ``var`` (on all of the boundary, or
        on an explicit (v, e) pair list). Sugar for ``equal``."""
        return self.equal(var, value, pairs=nodes)

    def equal(self, var_expr, rhs, pairs=None):
        """Equality constraint a*var == rhs on ``pairs`` ((v, e) tuples or
        flat node indices; None = the whole boundary). Lowered as Dirichlet
        pinning of the variable (the reference's :eq records,
        ext/MultiGridBarrierJuMPExt:660); its dual is the assembled
        reaction (``dual``)."""
        e = _as_expr(var_expr)
        terms = [(k, c) for k, c in e.terms.items()]
        if len(terms) != 1 or terms[0][0][1] != "id" or e.const is not None:
            raise ValueError("equal() expects a*var (a single undifferentiated "
                             "variable, optionally scaled)")
        (name, _), a = terms[0]
        if callable(a):
            raise ValueError("equal(): the variable coefficient must be a "
                             "constant scalar")
        c = Constraint("eq", (name, _as_fn(rhs), float(a)), pairs,
                       origin="eq")
        self.constraints.append(c)
        return c

    def set_start(self, var, values):
        """Warm start for ``var``: nodal values array or callable x->value
        (the reference's JuMP set_start, src/jump_frontend.jl:115-132).
        Typical use: m.set_start(u, m.value(u)) before a re-solve."""
        self._start[var.name] = (np.asarray(values, dtype=float)
                                 if not callable(values) else _as_fn(values))

    def epigraph(self, s_expr, q_exprs, p=2.0, where=None):
        """Add the power cone  s_expr >= ||(q_exprs)||_2^p  (EpiPower)."""
        c = Constraint("epipower",
                       (_as_expr(s_expr), [_as_expr(q) for q in q_exprs],
                        float(p)), where, origin="power")
        self.constraints.append(c)
        return c

    def constrain(self, ineq, where=None):
        """Add a scalar linear inequality: expr >= other / expr <= other.
        ``where``: None (everywhere), a callable x -> bool, or a set of
        (v, e) pairs / flat node indices (the reference's On(pairs) regions,
        ext/MultiGridBarrierJuMPExt:950-1007)."""
        kind, expr = ineq
        assert kind in ("ge", "le")
        c = Constraint("linear", [expr], where, origin=kind)
        self.constraints.append(c)
        return c

    def minimize(self, expr):
        """Objective: Min integral(expr) with expr affine in the fields."""
        self.objective = _as_expr(expr)

    # -- lowering ---------------------------------------------------------
    def _lower(self):
        from ..discretize.spectral import Spectral1D, Spectral2D
        from ..hierarchy.amg_build import find_boundary

        if self.objective is None:
            raise ValueError("no objective; call model.minimize(expr)")
        names = list(self.variables)
        used_ops = {n: {"id"} for n in names}
        eqs = [c for c in self.constraints if c.kind == "eq"]
        cone_cons = [c for c in self.constraints if c.kind != "eq"]
        all_exprs = [self.objective]
        for c in cone_cons:
            if c.kind == "epipower":
                all_exprs += [c.data[0]] + c.data[1]
            else:
                all_exprs += c.data
        for e in all_exprs:
            for (n, op) in e.terms:
                if n not in used_ops:
                    raise ValueError(f"expression references unknown variable {n}")
                used_ops[n].add(op)
        eq_names = {c.data[0] for c in eqs}

        # variable kinds: conforming when differentiated or equality-pinned
        sv = []
        mgobj = self.mg
        dirichlet_sets = {}
        geom = mgobj.geometry
        spectral = isinstance(geom.discretization, (Spectral1D, Spectral2D))
        V = geom.x.shape[0]
        for n in names:
            v = self.variables[n]
            kind = v.kind
            if kind == "auto":
                differentiated = any(op != "id" for op in used_ops[n])
                kind = ("continuous"
                        if differentiated or n in eq_names else "broken")
            if kind == "continuous":
                if spectral:
                    # spectral fallback: whole-boundary conditions map onto
                    # the truncation :dirichlet subspace (the reference's
                    # spectral path, ext/MultiGridBarrierJuMPExt:1018-1048)
                    for c in eqs:
                        if c.data[0] == n and c.region is not None:
                            raise ValueError(
                                "spectral discretizations support only "
                                "whole-boundary equality conditions")
                    sv.append((n, "dirichlet"))
                    continue
                sym = f"dirichlet_{n}"
                node_pairs = []
                whole = False
                for c in eqs:
                    if c.data[0] != n:
                        continue
                    if c.region is None:
                        whole = True
                    else:
                        node_pairs += list(c.region)
                if whole or not node_pairs:
                    # normalize flat broken-node indices to (v, e) pairs
                    # (flat = e*V + v, see _pairs_to_flat) so they survive
                    # the union with the whole-boundary pair set
                    dirichlet_sets[sym] = find_boundary(geom) +                         [tuple(pr) if isinstance(pr, (tuple, list, np.ndarray))
                         else (int(pr) % V, int(pr) // V)
                         for pr in node_pairs]
                else:
                    dirichlet_sets[sym] = list(node_pairs)
                sv.append((n, sym))
            elif kind == "uniform":
                sv.append((n, "uniform"))
            else:
                slack = geom.discretization.default_slack_space()
                sv.append((n, slack))
        if dirichlet_sets:
            from ..hierarchy.amg_build import amg as amg_build

            mgobj = amg_build(geom, dirichlet_nodes=dirichlet_sets)
            # merge rider subspaces from the original hierarchy if any
            for k2 in self.mg.R:
                if k2 not in mgobj.R:
                    mgobj.R[k2] = self.mg.R[k2]

        # D rows: id rows first (padding pool), then derivative rows
        D = [(n, "id") for n in names]
        row_of = {(n, "id"): i for i, n in enumerate(names)}
        for n in names:
            for op in sorted(used_ops[n] - {"id"}):
                row_of[(n, op)] = len(D)
                D.append((n, op))
        nD = len(D)
        xflat = geom.xflat()
        nnodes = xflat.shape[0]
        dtype = geom.dtype

        # objective -> f_grid
        f_grid = np.zeros((nnodes, nD), dtype=dtype)
        for key, coef in self.objective.terms.items():
            r = row_of[key]
            if callable(coef):
                for i in range(nnodes):
                    f_grid[i, r] += coef(xflat[i])
            else:
                f_grid[:, r] += coef

        # initial grid: warm starts first, then equality (Dirichlet) data,
        # rejecting silent conflicts where two equality regions overlap
        # (reference ext/MultiGridBarrierJuMPExt:930-944)
        nu = len(names)
        g_grid = np.zeros((nnodes, nu), dtype=dtype)
        for k2, n in enumerate(names):
            st = self._start.get(n)
            if st is None:
                continue
            if callable(st):
                for i in range(nnodes):
                    g_grid[i, k2] = st(xflat[i])
            else:
                vals = np.asarray(st, dtype=dtype).reshape(-1)
                if len(vals) != nnodes:
                    raise ValueError(f"start values for {n} must have "
                                     f"{nnodes} entries")
                g_grid[:, k2] = vals
        written = {}
        for c in eqs:
            n, rhs_fn, a = c.data
            k2 = names.index(n)
            if c.region is None:
                flat = _pairs_to_flat(find_boundary(geom), V)
            else:
                flat = _pairs_to_flat(c.region, V)
            for i in flat:
                val = rhs_fn(xflat[i]) / a
                prev = written.get((int(i), k2))
                if prev is not None and abs(prev - val) > 1e-12 * max(
                        1.0, abs(val)):
                    raise ValueError(
                        f"conflicting equality data for variable {n}: "
                        f"{prev} vs {val} at node {int(i)}")
                written[(int(i), k2)] = val
                g_grid[i, k2] = val

        # constraints -> convex pieces
        def affine_rows(exprs, nz):
            """idx (distinct rows, square-padded to nz), A fn, b fn."""
            rows = []
            for e in exprs:
                for key in e.terms:
                    r = row_of[key]
                    if r not in rows:
                        rows.append(r)
            pad = 0
            while len(rows) < nz:
                if pad >= nD:
                    raise ValueError("not enough distinct operator rows to "
                                     "square-pad the cone (add variables)")
                if pad not in rows:
                    rows.append(pad)
                pad += 1
            rows = rows[:nz] if len(rows) <= nz else rows
            if len(rows) > nz:
                raise ValueError(
                    f"cone references {len(rows)} distinct rows but has "
                    f"dimension {nz}")
            pos = {r: i for i, r in enumerate(rows)}

            def A(x):
                M = np.zeros((nz, nz))
                for i, e in enumerate(exprs):
                    for key, c in e.terms.items():
                        M[i, pos[row_of[key]]] += c(x) if callable(c) else c
                return M

            def b(x):
                return np.array([e.eval_const(x) for e in exprs])

            return tuple(rows), A, b

        pieces = []
        selects = []
        for c in cone_cons:
            if c.kind == "epipower":
                s_e, q_es, p = c.data
                nz = len(q_es) + 1
                idx, A, b = affine_rows(q_es + [s_e], nz)
                Q = convex_euclidian_power(mgobj, idx=idx, A=A, b=b, p=p,
                                           dtype=dtype)
            else:
                exprs = c.data
                rows = []
                for e in exprs:
                    for key in e.terms:
                        r = row_of[key]
                        if r not in rows:
                            rows.append(r)
                pos = {r: i for i, r in enumerate(rows)}

                def A(x, exprs=exprs, rows=rows, pos=pos):
                    M = np.zeros((len(exprs), len(rows)))
                    for i, e in enumerate(exprs):
                        for key, cf in e.terms.items():
                            M[i, pos[row_of[key]]] += \
                                cf(x) if callable(cf) else cf
                    return M

                def b(x, exprs=exprs):
                    return np.array([e.eval_const(x) for e in exprs])

                Q = convex_linear(mgobj, idx=tuple(rows), A=A, b=b,
                                  dtype=dtype)
            c.index = len(pieces)
            pieces.append(Q)
            selects.append(c.region)

        if not pieces:
            raise ValueError("the model has no constraints; the barrier "
                             "method needs a bounded convex domain")
        if len(pieces) == 1 and selects[0] is None:
            Q_all = pieces[0]
        else:
            sel_grid = np.ones((nnodes, len(pieces)), dtype=dtype)
            for j, r in enumerate(selects):
                if r is None:
                    continue
                if callable(r):
                    for i in range(nnodes):
                        sel_grid[i, j] = 1.0 if r(xflat[i]) else 0.0
                else:
                    # (v, e) pairs / flat node indices region (On(pairs))
                    sel_grid[:, j] = 0.0
                    sel_grid[_pairs_to_flat(r, V), j] = 1.0
            Q_all = convex_piecewise(tuple(pieces), mg=mgobj,
                                     select_grid=sel_grid)

        prob = assemble(mgobj, state_variables=sv, D=D, f_grid=f_grid,
                        g_grid=g_grid, Q=Q_all, device=self.device)
        self._lowered = dict(names=names, D=D, row_of=row_of, prob=prob,
                             mgobj=mgobj, pieces=pieces, selects=selects,
                             Q_all=Q_all, V=V, geom=geom)
        return prob

    # -- solve / results --------------------------------------------------
    def solve(self, **kwargs):
        prob = self._lower()
        try:
            self.sol = mgb_solve(prob, device=self.device, **kwargs)
            self.status = "optimal"
        except MGBConvergenceFailure as e:
            self.status = {"infeasible": "infeasible",
                           "feasibility_Rmax": "infeasible_or_unbounded",
                           "stall": "slow_progress",
                           "iteration_limit": "iteration_limit"}.get(
                               e.code, "numerical_error")
            raise
        return self.sol

    def value(self, var):
        if self.sol is None:
            raise ValueError("solve first")
        k = self._lowered["names"].index(var.name)
        return np.asarray(self.sol.z[:, k])

    def mgb_solution(self):
        """The underlying MGBSOL after solve() — for plot(sol), logs,
        diagnostics pytrees (reference: mgb_solution,
        src/jump_frontend.jl:135-140)."""
        if self.sol is None:
            raise ValueError("solve first")
        return self.sol

    def solver_log(self):
        """The solver iteration log as one string (reference: solver_log,
        src/jump_frontend.jl:142-147)."""
        if self.sol is None:
            raise ValueError("solve first")
        return self.sol.log

    def objective_value(self):
        L = self._lowered
        prob = L["prob"]
        M1 = prob.M[0]
        z = np.asarray(self.sol.z).T.reshape(-1)
        Dz = M1.apply_D_full(z)
        return float(np.sum(M1.w[:, None] * prob.f_grid * Dz))

    # -- duals (reference ext/MultiGridBarrierJuMPExt:1191-1331) ----------
    def _dual_env(self):
        M1 = self._lowered["prob"].M[0]
        w = np.asarray(M1.w, dtype=np.float64)
        t = float(self.sol.SOL_main["ts"][-1])
        mcount = int(np.count_nonzero(w))
        dens = np.where(w != 0, 1.0 / (t * mcount * np.where(w != 0, w, 1.0)),
                        0.0)
        ind = np.where(w != 0, 1.0 / (t * mcount), 0.0)
        return t, w, mcount, dens, ind

    def _region_mask(self, region):
        L = self._lowered
        n = L["geom"].n_nodes
        if region is None:
            return np.ones(n)
        if callable(region):
            x = L["geom"].xflat()
            return np.array([1.0 if region(x[i]) else 0.0 for i in range(n)])
        mask = np.zeros(n)
        mask[_pairs_to_flat(region, L["V"])] = 1.0
        return mask

    def _Dz(self):
        M1 = self._lowered["prob"].M[0]
        z = np.asarray(self.sol.z, dtype=np.float64).T.reshape(-1)
        return M1.apply_D_full(z)

    def _row_vals(self, expr, Dz):
        row_of = self._lowered["row_of"]
        x = self._lowered["geom"].xflat()
        n = Dz.shape[0]
        out = np.zeros(n)
        for key, cf in expr.terms.items():
            col = Dz[:, row_of[key]]
            if callable(cf):
                out += np.array([cf(x[i]) for i in range(n)]) * col
            else:
                out += cf * col
        if expr.const is not None:
            if callable(expr.const):
                out += np.array([expr.const(x[i]) for i in range(n)])
            else:
                out += expr.const
        return out

    @staticmethod
    def _safediv(num, den):
        return np.where(num == 0, 0.0, num / np.where(den == 0, 1.0, den))

    def _reactions(self):
        """Per-broken-node reactions: the full objective gradient over t in
        component space, ~0 at free coordinates and equal to the equality
        multiplier at pinned ones (reference _reactions, :1258-1299). The
        raw per-node barrier gradient is ``Q.barrier[1]`` over every node,
        as in the reference: one mode-1 call with bw = 1 (every row kept)
        and wc = 0, on the model's device."""
        L = self._lowered
        prob = L["prob"]
        M1 = prob.M[0]
        names = L["names"]
        Dz = self._Dz()
        Q = L["Q_all"]
        dev = resolve_device(self.device)

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        gv = Q.barrier[1](*(tensor(a) for a in Q.args), tensor(Dz))
        gv = gv.cpu().numpy()
        t, w, mcount, dens, ind = self._dual_env()
        n = Dz.shape[0]
        react = np.zeros((n, len(names)))
        for j, (nme, op) in enumerate(L["D"]):
            vec = w * np.asarray(prob.f_grid[:, j], np.float64) + ind * gv[:, j]
            opd, comp = M1.D_fine[j]
            react[:, comp] += opd.rmatvec(vec)
        return react

    def dual(self, constraint):
        """Central-path dual of a constraint, per broken node.

        - linear rows: mu = dens * mask / row_value (sign per origin);
        - epigraph (power cone): mu = dens * mask * gs with
          gs = alpha s^(alpha-1)/r + mu(p)/s;
        - equality: raw per-node reactions on the pinned nodes divided by
          the variable coefficient (reference :1302-1331).
        """
        if self.sol is None:
            raise ValueError("solve first")
        c = constraint
        t, w, mcount, dens, ind = self._dual_env()
        mask = self._region_mask(c.region)
        if c.kind == "linear":
            Dz = self._Dz()
            vals = self._row_vals(c.data[0], Dz)
            mu = self._safediv(dens * mask, vals)
            return -mu if c.origin == "le" else mu
        if c.kind == "epipower":
            Dz = self._Dz()
            s_e, q_es, p = c.data
            s = self._row_vals(s_e, Dz)
            q2 = np.zeros_like(s)
            for qe in q_es:
                q2 += self._row_vals(qe, Dz) ** 2
            alpha = 2.0 / p
            r = np.power(s, alpha) - q2
            mu_p = 0.0 if p in (1.0, 2.0) else (1.0 if p < 2.0 else 2.0)
            gs = alpha * np.power(s, alpha - 1.0) / r + mu_p / s
            return dens * mask * gs
        # equality: assembled reactions
        L = self._lowered
        name, rhs_fn, a = c.data
        comp = L["names"].index(name)
        react = self._reactions()
        n = L["geom"].n_nodes
        if c.region is None:
            from ..hierarchy.amg_build import find_boundary

            flat = _pairs_to_flat(find_boundary(L["geom"]), L["V"])
        else:
            flat = _pairs_to_flat(c.region, L["V"])
        out = np.zeros(n)
        out[flat] = react[flat, comp] / a
        return out
