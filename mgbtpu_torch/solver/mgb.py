"""The multigrid barrier method: V-cycle step, t-ramp, phase I, driver
(torch port of the float64 paths of ``mgbtpu/solver/mgb.py``).

Host-side orchestration (the outer loops are O(log)-count, data-light and
dynamic) around per-level Newton solves on the device. The port always runs
the host-stepped ramp (the JAX package's fused on-device ramp is not
ported). Algorithmic parity with reference ``src/mgb.jl`` (mgb_step :16-82,
mgb_core :91-183, phase I :185-572, driver :332-584, assemble :711-727,
mgb_solve :798-843).
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from .._config import EPS, check_dtype, resolve_device
from ..convex.convex import Convex, validate_convex_inputs
from ..hierarchy.multigrid import AMGSystem, prepare_amg
from ..utils import trace
from ..utils.errors import MGBConvergenceFailure
from ..utils.log import Logger
from .barrier import make_level_fns
from .levelops import GramHessian, PCGContext, build_panel_ops
from .newton import (CONVERGED, PREDICTOR, dense_ir_solve, equilibrated_solve,
                     linesearch_backtracking, make_nd_pre, make_newton_core,
                     make_pcg_pre, pcg_solve, stopping_exact,
                     stopping_inexact)

# kappa-acceleration bonus: a step of at most max_newton/2 + this many
# Newton its counts as easy (mgbtpu/solver/ramp.py:43, same env name)
_EASY_BONUS = int(os.environ.get("MGBTPU_KAPPA_EASY_BONUS", 1))


# ---------------------------------------------------------------------------
# Defaults (reference src/mgb.jl:586-613)
# ---------------------------------------------------------------------------

def default_f(dim):
    def f(x):
        out = np.zeros(dim + 2)
        out[0] = 0.5
        out[-1] = 1.0
        return out
    return f


def default_g(dim):
    if dim == 1:
        return lambda x: np.array([x[0], 2.0])
    return lambda x: np.array([float(np.sum(np.asarray(x[:dim]) ** 2)), 100.0])


def default_D(dim):
    ops = ["dx", "dy", "dz"][:dim]
    return [("u", "id")] + [("u", o) for o in ops] + [("s", "id")]


def default_idx(dim):
    return tuple(range(1, dim + 2))


def barrier_weights(w: np.ndarray, barrier_nodes):
    """Resolve the barrier-node selection to per-node weights (mean over the
    selection). Reference ``_barrier_weights`` (``src/convex.jl:279-304``)."""
    n = len(w)
    if barrier_nodes is None:
        sel = (w != 0).astype(w.dtype)
    elif barrier_nodes is Ellipsis or (isinstance(barrier_nodes, str)
                                       and barrier_nodes == "all"):
        sel = np.ones(n, dtype=w.dtype)
    else:
        bn = np.asarray(barrier_nodes)
        if bn.dtype == bool:
            if len(bn) != n:
                raise ValueError("barrier_nodes mask length mismatch")
            sel = bn.astype(w.dtype)
        else:
            sel = np.zeros(n, dtype=w.dtype)
            sel[bn.astype(np.int64)] = 1
    m = sel.sum()
    if m == 0:
        raise ValueError("barrier_nodes selects no nodes")
    return sel / m


def flat_weights(w):
    return np.full(len(w), 1.0 / len(w), dtype=w.dtype)


# ---------------------------------------------------------------------------
# Per-problem kernels: panel plans + Newton runner, cached per AMGSystem
# ---------------------------------------------------------------------------

def nd_plan(M: AMGSystem, ops, leaf_elems, device, mesh=None):
    """The nested-dissection plan of one level's panel operators, from the
    element centroids of the fine geometry (symbolic analysis on the host,
    once per level); subtree-per-device under a ``mesh``."""
    from ..ops.ndchol import NDDevicePlan, NDPlan

    X = np.asarray(M.geometry.xflat(), np.float64)
    exy = X.reshape(ops.N, ops.p, -1).mean(axis=1)
    return NDDevicePlan(NDPlan(ops.host_cols, ops.n_J, exy,
                               leaf_elems=leaf_elems)).to_device(device,
                                                                 mesh=mesh)


class ProblemKernels:
    """Per-level solvers for one (AMGSystem, barrier family, device), over
    a mesh when one is given (``device`` is then its first device; a level
    whose elements divide by the mesh size runs per shard, see
    ``parallel/sharding.py``)."""

    # Levels above DENSE_MAX coefficients solve by CG on the matrix-free
    # Gram Hessian, preconditioned with what newton.BIG_PRE picks (the
    # nested-dissection direct factor by default); the others assemble the
    # dense Hessian and solve by LU. ND_LEAF_ELEMS is the ND leaf size
    # (elements per leaf front). The V-cycle's dense base is the largest
    # level with at most DENSE_BASE coefficients, and the cycle runs over
    # at most MAX_VCYCLE levels (transfers composed on the host to skip the
    # others). Same values and env names as the reference
    # (mgbtpu/solver/mgb.py:228-236).
    DENSE_MAX = int(os.environ.get("MGBTPU_DENSE_MAX", 1024))
    DENSE_BASE = int(os.environ.get("MGBTPU_DENSE_BASE", 2048))
    MAX_VCYCLE = int(os.environ.get("MGBTPU_MAX_VCYCLE", 3))
    ND_LEAF_ELEMS = int(os.environ.get("MGBTPU_ND_LEAF", 8))

    def __init__(self, M: AMGSystem, barrier, line_search, device,
                 mesh=None):
        self.M = M
        self.barrier = barrier
        self.device = device if mesh is None else mesh.first
        self.mesh = mesh
        self.p = M.geometry.x.shape[0]
        self._ops = {}
        self._plain = {}
        self._args = (None, None)   # the last args and their shards
        self.fns = make_level_fns(barrier)
        self._newton = make_newton_core(*self.fns, line_search=line_search)

    def tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def _plain_ops(self, l):
        """Level l's panel operators, with no large-level context."""
        if l not in self._plain:
            trace.built("panel_ops")
            self._plain[l] = build_panel_ops(
                self.M.D_fine, self.M.nu, self.M.R_fine[l], self.p,
                self.device, mesh=self.mesh)
        return self._plain[l]

    def ops(self, l):
        """Level l's panel operators as the Newton solve sees them: above
        DENSE_MAX (and with four elements or more: a level of few big
        elements has no useful partition) with the large-level context
        ``newton.BIG_PRE`` picks, built once (reference
        ``mgbtpu/solver/mgb.py:247-340``)."""
        if l not in self._ops:
            with trace.span("setup.plans"):
                ops = self._plain_ops(l)
                if ops.n_J > self.DENSE_MAX and ops.N >= 4:
                    ops.pcg_ctx = self._large_context(l, ops)
            self._ops[l] = ops
        return self._ops[l]

    def _large_context(self, l, ops):
        """The nested-dissection plan (BIG_PRE "nd"), or the V-cycle and
        FSAI data of solve level l: the dense base (the largest level of at
        most DENSE_BASE coefficients), at most MAX_VCYCLE - 1 smoothing
        levels spaced geometrically up to l, the composed ELL transfers
        between them, the FSAI plan, the composed BSR transfer dense base
        -> l, and the power iteration's start vectors (JAX's Rademacher
        draw, ``utils/threefry.py``). None, the dense path (which may be
        large), for a non-nested subspace: no coefficient transfers, so no
        V-cycle and no coarse correction, as in the reference. Under a
        mesh the chosen levels are the sharded levels (their Gram products
        run per shard); the transfers, the FSAI plan, the coarse transfer
        and the start vectors live on the first device."""
        from . import newton

        trace.built("large_context")
        if newton.BIG_PRE == "nd":
            return PCGContext(nd=nd_plan(self.M, ops, self.ND_LEAF_ELEMS,
                                         self.device, self.mesh))
        T_fine = self.M.T_fine
        if any(T_fine[j] is None for j in range(l)):
            return None
        from ..ops.bsr import build_bsr
        from ..utils.threefry import rademacher
        from .fsai import build_fsai_plan
        from .levelops import build_ell

        dense_level = 0
        for j in range(l):
            if self._plain_ops(j).n_J <= self.DENSE_BASE:
                dense_level = j
        chosen = [dense_level]
        candidates = list(range(dense_level + 1, l))
        keep = min(self.MAX_VCYCLE - 1, len(candidates))
        if keep > 0:
            pick = np.unique(np.linspace(0, len(candidates) - 1,
                                         keep).round().astype(int))
            chosen += [candidates[i] for i in pick]
        hops = chosen + [l]
        transfers = []
        for a, b in zip(hops[:-1], hops[1:]):
            T = T_fine[a]
            for j in range(a + 1, b):
                T = T_fine[j] @ T
            transfers.append(build_ell(T, self.device))
        T_all = T_fine[chosen[0]]
        for j in range(chosen[0] + 1, l):
            T_all = T_fine[j] @ T_all
        coarse_ops = tuple(self._plain_ops(j) for j in chosen)
        start = tuple(self.tensor(rademacher(1905, o.n_J))
                      for o in coarse_ops + (ops,))
        return PCGContext(coarse_ops=coarse_ops, transfers=tuple(transfers),
                          n_levels=len(chosen), dense_level=0,
                          fsai=build_fsai_plan(ops.host_cols, ops.n_J,
                                               self.device),
                          coarse_T=build_bsr(T_all, self.device),
                          start=start)

    def _shard_args(self, ops, args):
        """The per-node args grids per shard (``ops.split``), split once
        per args: every level of a mesh shards its nodes alike, since
        each level's operators span the same fine elements."""
        if self._args[0] is not args:
            self._args = (args, tuple(zip(*(ops.split(a) for a in args))))
        return self._args[1]

    def _fargs(self, l, z, wc, bw, args):
        ops = self.ops(l)
        with trace.span("driver.apply_D"):
            Dz = self.M.apply_D_full(z)
        with trace.span("driver.to_device"):
            Dz0, wc, bw = self.tensor(Dz), self.tensor(wc), self.tensor(bw)
        return (ops, ops.split(Dz0), ops.split(wc), ops.split(bw),
                self._shard_args(ops, args))

    def run_newton(self, l, z, wc, bw, args, *, maxit, stopping,
                   pred_r=None):
        """Newton in the level-l search space from s0 = 0 (or, with
        ``pred_r``, from the central-path tangent predictor)."""
        kind, theta, lambda_tol = stopping
        x0 = torch.zeros((self.ops(l).n_J,), dtype=torch.float64,
                         device=self.device)
        x, y, k, status, cg = self._newton(
            x0, self._fargs(l, z, wc, bw, args), int(maxit),
            lambda_tol if kind == "inexact" else -1.0, theta,
            pred_r=pred_r)
        with trace.span("driver.to_host"):
            x = x.cpu().numpy()
        return x, float(y), int(k), int(status), int(cg)

    def matched(self, z, wc0, wcc, bw, args):
        """(g_c' n_c, g_phi' n_c + g_c' n_phi) at the finest level, for
        ``_matched_t``: two Hessian solves at s = 0."""
        _, f1, f2 = self.fns
        l = self.M.depth - 1
        ops, Dz0, wc0, bw, args = self._fargs(l, z, wc0, bw, args)
        wcc = ops.split(self.tensor(wcc))
        s0 = torch.zeros((ops.n_J,), dtype=torch.float64, device=self.device)
        g_phi = f1(s0, ops, Dz0, wc0, bw, args)
        g_c = f1(s0, ops, Dz0, wcc, bw, args) - g_phi
        H = f2(s0, ops, Dz0, wcc, bw, args)
        if isinstance(H, GramHessian) and H.ctx.nd is not None:
            pre = make_nd_pre(H)

            def solve(g):
                from .newton import IR_RTOL

                return dense_ir_solve(H, g, pre, IR_RTOL)[0]
        elif isinstance(H, GramHessian):
            pre = make_pcg_pre(H)

            def solve(g):
                return pcg_solve(H, g, pre=pre)[0]
        else:
            def solve(g):
                return equilibrated_solve(H, g)
        n_phi = solve(g_phi)
        n_c = solve(g_c)
        return float(g_c @ n_c), float(g_phi @ n_c + g_c @ n_phi)

    def node_f0(self, args, Dz):
        """Per-node barrier values F0 (unmasked) at host Dz, for the
        initial feasibility check."""
        Dzt = self.tensor(Dz)
        parts = ((args, Dzt),)
        if self.mesh is not None:
            ops = self.ops(self.M.depth - 1)
            parts = zip(self._shard_args(ops, args), ops.split(Dzt))
        return np.concatenate([self.barrier(
            0, a, y, torch.ones_like(y[:, 0]), torch.zeros_like(y)
        ).cpu().numpy() for a, y in parts])


def _kernels_for(M: AMGSystem, Q: Convex, NC, line_search,
                 device, mesh=None) -> ProblemKernels:
    """The cached per-level solvers of Q's barrier on M (``NC`` None), or of
    its phase-I barrier with cobarrier width NC: one per (Q, form, device,
    mesh), so that repeat solves of the same problem (the parabolic steps)
    reuse the panel operators and nested-dissection plans. The entry holds
    Q (through its barrier) and the mesh, so ``id(Q)`` and ``id(mesh)``
    stay unique while it lives."""
    cache = getattr(M, "_torch_kernel_cache", None)
    if cache is None:
        cache = {}
        M._torch_kernel_cache = cache
    key = (id(Q), NC, line_search, str(device), id(mesh))
    if key not in cache:
        trace.built("problem_kernels")
        barrier = Q.barrier_terms if NC is None else make_feasibility_fs(Q, NC)
        cache[key] = ProblemKernels(M, barrier, line_search, device, mesh)
    return cache[key]


# ---------------------------------------------------------------------------
# mgb_step: one centering across the hierarchy (divide & conquer)
# ---------------------------------------------------------------------------

def divide_and_conquer(eta, j, J):
    """Try the coarse->level-J jump; on failure bisect the level interval.
    Reference ``src/mgb.jl:10-15``."""
    if eta(j, J):
        return True
    jmid = (j + J) // 2
    if jmid == j or jmid == J:
        return False
    return divide_and_conquer(eta, j, jmid) and divide_and_conquer(eta, jmid, J)


def mgb_step(kern: ProblemKernels, z, wc, bw, args, *, maxit, max_newton,
             stopping, finalize, log, initial_step=False, pred_r=None,
             first_budget=None):
    """One centering at fixed t over the hierarchy; returns
    (z, z_unfinalized, its, cg, converged). Failed attempts keep their
    (Armijo-monotone) partial progress; ``pred_r`` warm-starts the first
    attempt; ``first_budget`` caps only that first attempt (reference
    ``mgbtpu/solver/mgb.py:493``)."""
    M = kern.M
    L = M.depth
    its = np.zeros(L, dtype=np.int64)
    cg_tot = [0]
    state = {"z": z, "pred_r": pred_r, "first": first_budget}

    def eta(j, J, stop, mi):
        log("mgb_step", f"j={j} J={J}")
        pr, state["pred_r"] = state["pred_r"], None
        fb, state["first"] = state["first"], None
        # initial single-level centerings run to the global maxit (see mn);
        # the 2x first-attempt budget must not cap them
        use_fb = fb is not None and not (initial_step and J - j == 1)
        x, y, k, status, cg = kern.run_newton(J - 1, state["z"], wc, bw, args,
                                              maxit=(fb if use_fb else mi),
                                              stopping=stop, pred_r=pr)
        its[J - 1] += k
        cg_tot[0] += cg
        conv = status == CONVERGED
        if conv or np.all(np.isfinite(x)):
            with trace.span("driver.prolong"):
                state["z"] = state["z"] + M.R_fine[J - 1] @ x
        if not conv:
            log("mgb_step", f"level {J} newton status={status} k={k}")
        return conv

    def mn(j, J):
        return maxit if (initial_step and J - j == 1) else max_newton

    converged = divide_and_conquer(
        lambda j, J: eta(j, J, stopping, mn(j, J)), 0, L)
    z_unfinalized = state["z"]
    if finalize is not None:
        log("mgb_step", "finalize")
        ok = eta(L - 1, L, finalize, maxit)
        converged = converged and ok
    log("mgb_step", f"converged={converged}")
    return state["z"], z_unfinalized, its, cg_tot[0], converged


# ---------------------------------------------------------------------------
# mgb_core: the t-ramp (path following with kappa adaptation)
# ---------------------------------------------------------------------------

def _early(f, z, t):
    try:
        return f(z, t)
    except TypeError:
        return f(z)


def mgb_core(kern: ProblemKernels, z, c, args, *, w, bw, tol, t, maxit=10000,
             kappa=6.5, early_stop=None, progress=None, max_newton=None,
             stopping, finalize, log):
    """Path following from t to 1/tol with adaptive kappa (the t-step
    factor): success with few Newton its -> kappa = min(kappa0, kappa^2);
    failure -> kappa = sqrt(kappa); kappa <= 1 -> stall. The host-stepped
    loop of the reference (``mgbtpu/solver/mgb.py:722``)."""
    t_begin = time.time()
    if max_newton is None:
        max_newton = int(np.ceil(np.log2(-np.log2(EPS)))) + 4
    budget = int(np.ceil(float(os.environ.get("MGBTPU_BUDGET_FACTOR", 2.0))
                         * max_newton))
    easy_its = max_newton * 0.5 + _EASY_BONUS
    if early_stop is None:
        early_stop = lambda z_: False   # noqa: E731
    if progress is None:
        progress = lambda x: None       # noqa: E731
    tinit = t
    target = 1.0 / tol
    kappa0 = kappa
    L = kern.M.depth
    (its_hist, ts_hist, kappa_hist, time_hist, cdz_hist,
     cg_hist) = [], [], [], [], [], []

    def wc_at(tv):
        return w[:, None] * (tv * c)

    def record(tv, kv, its, zv, cg=0):
        its_hist.append(its)
        ts_hist.append(tv)
        kappa_hist.append(kv)
        time_hist.append(time.time())
        cg_hist.append(int(cg))
        with trace.span("driver.apply_D"):
            Dz = kern.M.apply_D_full(zv)
        cdz_hist.append(float(np.sum(w[:, None] * c * Dz)))

    initial_finalize = finalize if t >= target else None
    z, z_unf, its, cg0, conv = mgb_step(kern, z, wc_at(t), bw, args,
                                        maxit=maxit, max_newton=max_newton,
                                        first_budget=budget,
                                        stopping=stopping,
                                        finalize=initial_finalize, log=log,
                                        initial_step=True)
    log("mgb_core", "initial centering done")
    if not conv:
        raise MGBConvergenceFailure(
            f"Initial centering failed at t={t}, tol={tol}, maxit={maxit}.",
            "stall")
    record(t, kappa, its, z, cg0)
    k = 1
    attempts = 1  # the initial centering
    if isinstance(early_stop, tuple):
        # the structured feasibility stop of phase I: max slack < 0 over
        # the z block, held for a 2 t_first margin
        lo_b, hi_b = early_stop[1]
        t_first_box = [np.inf]

        def early_stop(zz, tv, _lo=lo_b, _hi=hi_b, _tf=t_first_box):
            if float(np.max(zz[_lo:_hi])) >= 0:
                return False
            _tf[0] = min(_tf[0], tv)
            return tv >= 2 * _tf[0]
    while t < target and kappa > 1 and k < maxit \
            and not _early(early_stop, z, t):
        k += 1
        prog = float(np.clip(np.log(t / tinit) / np.log(target / tinit), 0, 1)) \
            if tinit < target else 1.0
        progress(prog)
        its_acc = np.zeros(L, dtype=np.int64)
        cg_acc = 0
        while kappa > 1:
            # clamp the jump at the target: centering beyond 1/tol buys
            # nothing and the overshoot step is the most expensive one
            t1 = min(kappa * t, target)
            boost = kappa < 1.05   # final full-budget attempt
            log("mgb_core", f"k={k} t={t} kappa={kappa} t1={t1}"
                + (" (full budget)" if boost else ""))
            fin = finalize if t1 >= target else None
            z_try, z_unf_try, its, cg_s, conv = mgb_step(
                kern, z, wc_at(t1), bw, args, maxit=maxit,
                max_newton=(min(max(4 * max_newton, 2 * budget), maxit)
                            if boost else max_newton),
                first_budget=None if boost else budget,
                stopping=stopping, finalize=fin, log=log,
                pred_r=((t / t1) * (1.0 - t / t1)) if PREDICTOR else None)
            attempts += 1
            its_acc += its
            cg_acc += cg_s
            if conv:
                if its.max() <= easy_its:
                    log("mgb_core", "increasing t step size")
                    kappa = min(kappa0, kappa ** 2)
                z, z_unf = z_try, z_unf_try
                t = t1
                break
            if boost:
                kappa = 1.0
                break
            log("mgb_core", "t refinement failed, shrinking kappa")
            kappa = np.sqrt(kappa)
        record(t, kappa, its_acc, z, cg_acc)
    converged = (t >= target) or _early(early_stop, z, t)
    if not converged:
        code = "stall" if kappa <= 1 else "iteration_limit"
        raise MGBConvergenceFailure(
            f"Convergence failure at t={t}, k={k}, kappa={kappa}, tol={tol}, "
            f"maxit={maxit}.", code)
    progress(1.0)
    log("mgb_core", f"success. t={t} tol={tol}")
    t_end = time.time()
    return dict(z=z, z_unfinalized=z_unf, c=c,
                its=np.stack(its_hist, axis=1), ts=np.array(ts_hist),
                kappas=np.array(kappa_hist), t_begin=t_begin, t_end=t_end,
                t_elapsed=t_end - t_begin, times=np.array(time_hist),
                c_dot_Dz=np.array(cdz_hist), cg=np.array(cg_hist),
                steps_attempted=int(attempts),
                steps_accepted=len(its_hist))


# ---------------------------------------------------------------------------
# Phase I: feasibility barrier with bounding box
# ---------------------------------------------------------------------------

def make_feasibility_fs(Q: Convex, NC: int):
    """The phase-I barrier family of ``Q``: its cobarrier plus the box
    barriers, as one K6 launch per mode (``kernels/node_barrier.py``).

    Per node, with yy = (D rows..., slack u, component values v_i...) and
    box scalars (b, R) as the two trailing args:

        F0 = cobarrier(yy[:NC]) - log(b-u) - log(b+u)
             - sum_i [log(R-v_i) + log(R+v_i)]

    (reference ``src/mgb.jl:190-287``; ``mgbtpu/solver/mgb.py:928``)."""

    def barrier(mode, args, y, bw, wc):
        return Q.cobarrier_terms(mode, args[:-2], y, bw, wc, NC=NC,
                                 box=args[-2:])

    return barrier


def _matched_t(kern: ProblemKernels, z, c, t_default, args, *, w, bw, log):
    """Barrier parameter whose central point z best approximates, capped at
    t_default: minimize the quadratic lambda_t^2 = (g_phi + t g_c)' H^-1
    (g_phi + t g_c) — two Hessian solves. Reference ``src/mgb.jl:289-330``."""
    zero_wc = np.zeros((len(w), c.shape[1]))
    d, b = kern.matched(z, zero_wc, w[:, None] * c, bw, args)
    if not (np.isfinite(d) and np.isfinite(b) and d > 0):
        return t_default
    tstar = -b / (2 * d)
    if not (np.isfinite(tstar) and tstar > 0):
        return t_default
    tm = float(np.clip(tstar, np.sqrt(EPS), t_default))
    log("_matched_t", f"warm start matches t={tstar}, starting main ramp at t={tm}")
    return tm


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def mgb_driver(Mpair, f_grid, g_grid, Q: Convex, *, device, tol=None, t=0.1,
               t_feasibility=None, feasibility_Rmax=None, maxit=10000,
               kappa=6.5, early_stop=None, max_newton=None,
               stopping_criterion=None, line_search=None, finalize="default",
               barrier_nodes=None, progress=None, log=None, dtype=None,
               mesh=None):
    check_dtype(dtype)
    M1, M2 = Mpair
    tol = tol if tol is not None else float(np.sqrt(EPS))
    t_feasibility = t_feasibility if t_feasibility is not None else t
    feasibility_Rmax = feasibility_Rmax if feasibility_Rmax is not None \
        else 1.0 / np.sqrt(EPS)
    if progress is None:
        progress = lambda x: None   # noqa: E731
    if log is None:
        log = lambda *a: None       # noqa: E731
    if stopping_criterion is None:
        # flat-averaged barrier has self-concordance constant sqrt(n):
        # lambda < eta/sqrt(n) with eta = 1/4 (reference src/mgb.jl:348-360)
        lam = 0.25 / np.sqrt(len(M1.w))
        stopping_criterion = stopping_inexact(lam, 0.9)
    if line_search is None:
        line_search = linesearch_backtracking()
    if finalize == "default":
        finalize = stopping_exact(0.9)
    elif finalize is False:
        finalize = None

    w = np.asarray(M1.w, dtype=np.float64)
    bw_main = barrier_weights(w, barrier_nodes)
    bw_flat = flat_weights(w)
    m = M1.n_nodes
    nD = len(M1.D_fine)
    nu = M1.nu
    c0 = np.asarray(f_grid, dtype=np.float64)
    z0 = np.asarray(g_grid, dtype=np.float64)
    if z0.shape != (m, nu):
        raise ValueError(f"g grid must be ({m}, {nu}), got {z0.shape}")
    if c0.shape != (m, nD):
        raise ValueError(f"f grid must be ({m}, {nD}), got {c0.shape}")
    z2 = z0.T.reshape(-1).copy()            # stacked (nu*m,), component-major

    kern1 = _kernels_for(M1, Q, None, line_search, device, mesh)
    with trace.span("driver.to_device"):
        q_args = tuple(kern1.tensor(a) for a in Q.args)

    SOL_feasibility = None
    pbarfeas = 0.0
    with trace.span("driver.apply_D"):
        Dz = M1.apply_D_full(z2)
    vals = kern1.node_f0(q_args, Dz)
    if not np.all(np.isfinite(vals)):
        pbarfeas = 0.1
        log("mgb_driver", "initial point infeasible: entering phase I")
        slack_vals = Q.slack(q_args, kern1.tensor(Dz)).cpu().numpy()
        u0 = 2 * np.maximum(slack_vals, 1.0)
        b = float(2 * max(1.0, u0.max()))
        nD2 = nD + 1 + nu
        c1 = np.zeros((m, nD2))
        c1[:, nD] = 1.0
        z1 = np.concatenate([z2, u0])
        kern2 = _kernels_for(M2, Q, nD + 1, line_search, device, mesh)
        Rbox = max(10.0, 10.0 * float(np.abs(z2).max()))
        Rmax = max(float(feasibility_Rmax), Rbox)

        def feasible(zz):
            return float(zz[nu * m:(nu + 1) * m].max()) < 0

        while True:
            log("mgb_driver", f"feasibility phase with bounding box R={Rbox}")
            args_feas = q_args + (kern2.tensor(np.full((m,), b)),
                                  kern2.tensor(np.full((m,), Rbox)))
            feas_stop = ("feasibility", (nu * m, (nu + 1) * m))
            failure = None
            try:
                with trace.span("driver.phase1"):
                    SOL_feasibility = mgb_core(
                        kern2, z1, c1, args_feas, w=w, bw=bw_flat, tol=tol,
                        t=t_feasibility, maxit=maxit, kappa=kappa,
                        early_stop=feas_stop,
                        progress=lambda x: progress(pbarfeas * x),
                        max_newton=max_newton, stopping=stopping_criterion,
                        finalize=finalize, log=log)
            except MGBConvergenceFailure as e:
                failure = e
            if failure is None:
                zf = SOL_feasibility["z"]
                if feasible(zf):
                    break
                vmax = max(float(np.abs(zf[k2 * m:(k2 + 1) * m]).max())
                           for k2 in range(nu))
                smax = float(zf[nu * m:(nu + 1) * m].max())
                if vmax <= Rbox / 2:
                    raise MGBConvergenceFailure(
                        "The problem appears to be infeasible: the phase-I "
                        f"minimizer has positive violation (max slack ~ {smax}) "
                        f"strictly inside the bounding box (max nodal value "
                        f"~ {vmax} <= R/2 with R = {Rbox}).", "infeasible")
                log("mgb_driver",
                    f"phase-I minimizer presses the box (|v|max={vmax}, "
                    f"smax={smax}); growing R")
            else:
                log("mgb_driver", f"feasibility solve failed at R={Rbox}: {failure}")
            Rnext = 10 * Rbox
            if Rnext > Rmax:
                reason = ("the phase-I minimizer still presses the bounding box"
                          if failure is None else f"the last attempt failed: {failure}")
                raise MGBConvergenceFailure(
                    f"Could not find a strictly feasible point with nodal "
                    f"values bounded by R = {Rbox} (cap ~ {Rmax}); {reason}. "
                    "The problem is infeasible, or its feasible points exceed "
                    "the cap (rescale, or raise feasibility_Rmax).",
                    "feasibility_Rmax")
            Rbox = Rnext
        z2 = SOL_feasibility["z"][:nu * m].copy()
        with trace.span("driver.matched_t"):
            t = min(t, _matched_t(kern1, z2, c0, t, q_args, w=w, bw=bw_main,
                                  log=log))

    with trace.span("driver.main"):
        SOL_main = mgb_core(
            kern1, z2, c0, q_args, w=w, bw=bw_main, tol=tol, t=t,
            maxit=maxit, kappa=kappa, early_stop=early_stop,
            progress=lambda x: progress((1 - pbarfeas) * x + pbarfeas),
            max_newton=max_newton, stopping=stopping_criterion,
            finalize=finalize, log=log)
    z = SOL_main["z"].reshape(nu, m).T
    return dict(z=z, SOL_feasibility=SOL_feasibility, SOL_main=SOL_main)


# ---------------------------------------------------------------------------
# assemble / mgb_solve / solution containers
# ---------------------------------------------------------------------------

class MGBProblem:
    """Assembled, closure-free convex problem: host data + a barrier family;
    the device sees only tensors. Reference ``MGBProblem``
    (``src/mgb.jl:649-674``)."""

    def __init__(self, M, f_grid, g_grid, Q, geometry, device):
        self.M = M
        self.f_grid = f_grid
        self.g_grid = g_grid
        self.Q = Q
        self.geometry = geometry
        self.device = device


class MGBSOL:
    """Solution: z (n_nodes, n_components), phase diagnostics, log, geometry."""

    def __init__(self, z, SOL_feasibility, SOL_main, log, geometry):
        self.z = z
        self.SOL_feasibility = SOL_feasibility
        self.SOL_main = SOL_main
        self.log = log
        self.geometry = geometry


@trace.spanned("setup.assemble")
def assemble(mg, *, dim=None, state_variables=None, D=None, x=None, p=1.0,
             f=None, g=None, f_grid=None, g_grid=None, Q=None, M=None,
             device=None, dtype=None, **solver_kwargs):
    """Lower a problem specification to a closure-free MGBProblem (reference
    ``assemble``, ``src/mgb.jl:676-727``): f/g closures are sampled to
    grids, the constraint defaults to the p-Laplace power cone, and the
    (main, feasibility) AMG pair is built from the state table. ``device``
    (default cuda; raises without a card unless "cpu") is where the problem
    is meant to be solved. ``dtype``: None or float64 (``check_dtype``);
    other keyword arguments (solver controls) are ignored, as the JAX
    package ignores them."""
    from ..convex import convex_euclidian_power
    from ..utils.maps import sample_rows

    check_dtype(dtype)
    device = resolve_device(device)
    geom = mg.geometry
    if dim is None:
        dim = geom.discretization.dim
    if state_variables is None:
        state_variables = [("u", "dirichlet"),
                           ("s", geom.discretization.default_slack_space())]
    if D is None:
        D = default_D(dim)
    if x is None:
        x = geom.xflat()
    if M is None:
        M = prepare_amg(mg, state_variables=state_variables, D=D)
    nD = len(D)
    nu = len(state_variables)
    if f_grid is None:
        f_grid = sample_rows(f or default_f(dim), x, np.float64, width=nD)
    if g_grid is None:
        g_grid = sample_rows(g or default_g(dim), x, np.float64, width=nu)
    if Q is None:
        Q = convex_euclidian_power(mg, idx=default_idx(dim), p=float(p))
    validate_convex_inputs(Q, nD)
    return MGBProblem(M, np.asarray(f_grid, dtype=np.float64),
                      np.asarray(g_grid, dtype=np.float64), Q, geom, device)


def mgb_solve(prob: MGBProblem, *, verbose=False, logfile=None, device=None,
              mesh=None, profile_dir=None, **kwargs) -> MGBSOL:
    """Solve an assembled problem; returns an MGBSOL (host arrays).

    Keyword arguments mirror the reference's solver controls: tol, t,
    t_feasibility, feasibility_Rmax, maxit, kappa, early_stop, max_newton,
    stopping_criterion, line_search, finalize, barrier_nodes, progress.
    ``device``: "cuda" (the default; raises without a card) or "cpu".
    ``mesh``: a ``make_mesh`` mesh to shard the solve over; the device is
    then the mesh's first, and a ``device`` that names another raises.
    ``profile_dir``: write a ``torch.profiler`` trace of the solve there
    (a Chrome trace, ``mgb_solve.<pid>.<ns>.pt.trace.json``) and beside it
    the solve's record, ``mgb_solve.<pid>.<ns>.records.json``.

    Under a profiler (``profile_dir``, or one the caller runs) the solve
    names its layers with spans (``utils/trace.py``): ``driver.solve``,
    whose args are the solve's number, around ``driver.main`` and
    ``driver.phase1`` (the t-ramps), whose host work between Newton
    solves is ``driver.apply_D``, ``driver.prolong``, ``driver.to_device``
    and ``driver.to_host`` (``driver.matched_t`` between the phases),
    and ``setup.plans`` where a level's plans are built on first use;
    ``newton``, ``newton.linesearch``, ``newton.sync``;
    ``linsolve.precondition``, ``linsolve.cg``, ``linsolve.dense``,
    ``linsolve.nd_factor`` (``linsolve.nd_factor.fronts`` its front
    assembly), ``linsolve.nd_solve``; ``levelfn.f0``/``f1``/``f2``
    (``levelfn.f2.node_factors``). The record holds ``seq`` and the
    deltas over the solve of ``launches`` (``kernels.launches()``),
    ``syncs`` (``newton.SYNCS``), ``transfers`` (``sharding.TRANSFERS``:
    gathers, broadcasts, bytes), ``enqueue_ns`` (host nanoseconds inside
    each kernel's wrapper) and ``builds`` (what the solve had to build);
    ``trace.solves()`` keeps the records of traced solves. With no
    profiler the spans cost a flag test and nothing is recorded.
    """
    device = _solve_device(device, mesh)
    logger = Logger(stream=logfile)
    progress = kwargs.pop("progress", None)
    if verbose and progress is None:
        state = {"last": -1}

        def progress(x):  # pragma: no cover - cosmetic
            pct = int(x * 100)
            if pct > state["last"]:
                state["last"] = pct
                print(f"\rmgb_solve: {pct:3d}%", end="", flush=True)
    try:
        logger("mgb_solve", "device = ", device,
               "" if mesh is None else f", mesh of {mesh.size}")
        with _profiling(profile_dir, device), trace.solve(_counters):
            SOL = mgb_driver(prob.M, prob.f_grid, prob.g_grid, prob.Q,
                             device=device, progress=progress, log=logger,
                             mesh=mesh, **kwargs)
    finally:
        logger.close()
    if verbose:
        print()
    return MGBSOL(SOL["z"], SOL["SOL_feasibility"], SOL["SOL_main"],
                  logger.text(), prob.geometry)


def _solve_device(device, mesh):
    """The solve's device: ``device`` (default cuda), or the mesh's first
    device, which a given ``device`` must name."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != mesh.first:
            raise ValueError(f"mgb_solve: device {dev} is not the mesh's "
                             f"first device {mesh.first}")
    return mesh.first


def _counters():
    """The counters a solve's record takes the deltas of (``trace.solve``).
    """
    from .. import kernels
    from ..parallel.sharding import TRANSFERS
    from .newton import SYNCS

    return {"launches": kernels.launches(), "syncs": SYNCS["n"],
            "transfers": {k: TRANSFERS[k]
                          for k in ("gathers", "broadcasts", "bytes")},
            "enqueue_ns": dict(trace.ENQUEUE_NS),
            "builds": dict(trace.BUILDS)}


@contextlib.contextmanager
def _profiling(profile_dir, device):
    """A torch.profiler trace of the block written to ``profile_dir``, and
    beside it the record of the solve that ran in it (nothing when
    ``profile_dir`` is None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    seq0 = trace.SEQ["n"]
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    stem = os.path.join(profile_dir,
                        f"mgb_solve.{os.getpid()}.{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    mine = [r for r in trace.solves() if r["seq"] > seq0]
    if mine:
        with open(stem + ".records.json", "w") as fh:
            json.dump(mine[-1], fh, indent=1)


def mgb_cleanup(obj=None):
    """Drop cached per-problem plans (the reference's ``mgb_cleanup``,
    ``mgbtpu/solver/mgb.py:1265``).

    Given an MGBProblem or an AMGSystem, drop the per-system solver cache
    (``_torch_kernel_cache``: the per-level panel plans and large-level
    contexts, nested-dissection, V-cycle or FSAI, of every barrier solved
    on it); the next solve builds them again. With no argument, drop the loaded kernel entries the
    port keeps (``kernels.clear_caches``); the built libraries stay on disk
    and are loaded again at the next launch. There is no JAX cache here.
    """
    if obj is None:
        from .. import kernels

        kernels.clear_caches()
        return
    if isinstance(obj, MGBProblem):
        targets = list(obj.M)
    elif isinstance(obj, AMGSystem):
        targets = [obj]
    else:
        raise TypeError(f"mgb_cleanup: expected an MGBProblem or an "
                        f"AMGSystem, got {type(obj)}")
    for M in targets:
        cache = getattr(M, "_torch_kernel_cache", None)
        if cache is not None:
            cache.clear()
