"""Damped Newton with line search and stopping criteria, as a host loop
(torch port of the float64 paths of ``mgbtpu/solver/newton.py``).

The JAX package runs the whole inner solve inside ``lax.while_loop``s; here
the loops are Python ``while`` loops around device tensors, and every scalar
decision (line-search acceptance, stopping tests, CG exits) reads its value
on the host with ``.item()`` — one host sync each, counted in
``SYNCS["n"]``. The barrier's Log -> -inf convention turns every domain
escape into a non-finite value that the checks below reject. Algorithmic
parity with reference ``src/newton.jl`` (newton at :227-287, backtracking at
:139-154, Illinois at :84-103, stopping at :187-225).

Status codes: 0 running, 1 converged, 2 not converged (maxit / line-search
exhaustion), 3 non-finite initial value, 4 Hessian-solve failure at a
non-optimal point (lambda^2 <= 0 with large gradient), 5 non-finite Newton
direction.
"""
from __future__ import annotations

import math
import os as _os

import torch

from ..utils.trace import span, spanned
from .levelops import GramHessian

RUNNING, CONVERGED, DIVERGED, BAD_INIT, BAD_HESSIAN, BAD_DIRECTION = range(6)

_MAX_LS_TRIALS = 120  # s = beta^k underflows long before this for any dtype

# the reference's env-resolved defaults (mgbtpu/solver/newton.py:171-211)
IR_INNER = int(_os.environ.get("MGBTPU_IR_INNER", 200))
IR_OUTER = int(_os.environ.get("MGBTPU_IR_OUTER", 3))
IR_RTOL = float(_os.environ.get("MGBTPU_IR_RTOL", 1e-5))
IR_TAU = float(_os.environ.get("MGBTPU_IR_TAU", 4.0))
FORCING = _os.environ.get("MGBTPU_FORCING", "1") != "0"
RTOL_LOOSE = float(_os.environ.get("MGBTPU_FORCING_RTOL", 1e-2))
PREDICTOR = _os.environ.get("MGBTPU_PREDICTOR", "1") != "0"
PRE_REFRESH = _os.environ.get("MGBTPU_PRE_REFRESH", "auto")
PRE_REFRESH_AT = int(_os.environ.get("MGBTPU_PRE_REFRESH_AT", 96))
PRE_REFRESH_ND_AT = int(_os.environ.get("MGBTPU_PRE_REFRESH_ND_AT", 4))
# the large-level preconditioner (mgbtpu/solver/newton.py:281-304):
#   "nd"     (default) nested-dissection direct factors (ops/ndchol.py);
#   "vcycle" a Chebyshev-smoothed V-cycle over the barrier-Hessian
#            hierarchy with a dense shifted-Cholesky base;
#   "fsai"   a factorized sparse approximate inverse (solver/fsai.py);
#   "fsai2"  FSAI plus a two-level Galerkin coarse correction, applied
#            multiplicatively; "fsai2a" the same, applied additively.
# The reference's own record of them: fsai2 diverges at L >= 6, and the
# V-cycle's contraction collapses at deep t (the equilibrated Hessian's
# near-null eigenvalues); the port is held to the same outcomes.
# SMOOTHER: "cheby" (Chebyshev of degree CHEB_DEG on D^-1 H) or "jacobi"
# (one damped sweep, omega = 0.7) in the V-cycle.
BIG_PRE = _os.environ.get("MGBTPU_BIG_PRE", "nd")
SMOOTHER = _os.environ.get("MGBTPU_SMOOTHER", "cheby")
CHEB_DEG = int(_os.environ.get("MGBTPU_CHEB_DEG", 3))
# the V-cycle's and FSAI's CG budget when the caller gives none
PCG_RTOL = 1e-5
PCG_MAXITER = 150

# host syncs (.item() and friends) in the Newton machinery
SYNCS = {"n": 0}


def _item(t) -> float:
    SYNCS["n"] += 1
    with span("newton.sync"):
        return t.item()


def _all_finite(t) -> bool:
    SYNCS["n"] += 1
    with span("newton.sync"):
        return bool(torch.isfinite(t).all())


# ---------------------------------------------------------------------------
# linear solves
# ---------------------------------------------------------------------------

@spanned("linsolve.dense")
def equilibrated_solve(H, g):
    """Dense symmetric solve: Jacobi equilibration + LU + two iterative
    refinement sweeps (reference ``newton.py:143``)."""
    d = torch.sqrt(torch.abs(torch.diagonal(H)))
    dinv = torch.where(d > 0, 1.0 / d, torch.ones_like(d))
    Hs = H * (dinv[:, None] * dinv[None, :])
    gs = dinv * g
    LU, piv, _ = torch.linalg.lu_factor_ex(Hs)
    x = torch.linalg.lu_solve(LU, piv, gs[:, None])[:, 0]
    for _ in range(2):
        r = gs - Hs @ x
        x = x + torch.linalg.lu_solve(LU, piv, r[:, None])[:, 0]
    return dinv * x


@spanned("linsolve.dense")
def regularized_direction(H, g):
    """Fallback direction when the Newton solve fails (lambda^2 <= 0 away
    from the optimum): shifted Cholesky on the equilibrated system with a
    shift ladder; the first finite candidate wins."""
    from ..kernels import cholesky_nan

    d = torch.sqrt(torch.abs(torch.diagonal(H)))
    dinv = torch.where(d > 0, 1.0 / d, torch.ones_like(d))
    Hs = H * (dinv[:, None] * dinv[None, :])
    gs = dinv * g
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    eps0 = math.sqrt(torch.finfo(H.dtype).eps)
    for delta in (eps0, 3e-2, 5e-1):
        Lc = cholesky_nan(Hs + delta * eye)
        x = dinv * torch.cholesky_solve(gs[:, None], Lc)[:, 0]
        if _all_finite(x):
            return x
    return x


@spanned("linsolve.precondition")
def make_nd_pre(H: GramHessian):
    """Nested-dissection direct factorization of the equilibrated Gram
    Hessian, f64 branch of the reference (``newton.py:646-650``): factor with
    a 2 eps shift, and with 32 eps if that factor is not finite."""
    from ..ops.ndchol import nd_factor, nd_finite

    ops = H.ops
    d = ops.gram_diagonal(H.Lnode)
    dinv = torch.where(d > 0, torch.rsqrt(d), torch.ones_like(d))
    He = ops.gram_blocks(H.Lnode, dinv)
    eps = torch.finfo(d.dtype).eps
    fact = nd_factor(ops.nd, He, 2 * eps)
    SYNCS["n"] += 1
    if not nd_finite(fact):
        fact = nd_factor(ops.nd, He, 32 * eps)
    return fact, dinv


def _refresh_at(H):
    """The CG count above which the carried preconditioner is rebuilt:
    tight for the direct-grade ND factor (CG exits in a few its when it is
    fresh), lax for the V-cycle and FSAI (healthy at ~8 its), as the
    reference's ``_refresh_at`` (``newton.py:214``)."""
    return PRE_REFRESH_ND_AT if H.ctx.nd is not None else PRE_REFRESH_AT


@spanned("linsolve.precondition")
def make_pcg_pre(H: GramHessian):
    """Preconditioner data of one centering of a V-cycle or FSAI level
    (``BIG_PRE``; reference ``make_pcg_pre``, ``newton.py:653-716``):

    - FSAI: the factor tiles and scale (``fsai_values``), and for
      ``fsai2``/``fsai2a`` the Galerkin coarse Hessian's equilibrated
      shifted-Cholesky inverse at the dense base (``T' H T`` from the same
      node factors);
    - V-cycle: the dense base's inverses, and for each smoothing level its
      Gram diagonal and lambda_max(D^-1 H) (a float): 14 power steps on
      D^-1/2 H D^-1/2 from the level's Rademacher start vector, the norm
      ratio times 1.15.

    Every level takes the solve level's node factors through the level
    interface (``levelops``): under a mesh the Gram sums and products run
    per shard and sum once on the first device, where the preconditioner
    data live, so a mesh gives the bits of one device.

    Returns ``(kind, data)``; kind "fsai" or "vcycle"."""
    from ..ops.blockchol import shifted_spd_inverse

    ops, ctx, Ls = H.ops, H.ctx, H.Lnode

    def spd_inverse(o):
        SYNCS["n"] += 1      # the finiteness test of the shift ladder
        return shifted_spd_inverse(o.gram_dense(Ls))

    if BIG_PRE.startswith("fsai") and ctx.fsai is not None:
        from .fsai import fsai_values

        Gtiles, dpos = fsai_values(ctx.fsai, ops, Ls)
        coarse = None
        if BIG_PRE in ("fsai2", "fsai2a") and ctx.coarse_T is not None:
            coarse = spd_inverse(ctx.coarse_ops[ctx.dense_level])
        return "fsai", (Gtiles, dpos, coarse)

    dense_chos = [spd_inverse(ctx.coarse_ops[l])
                  for l in range(ctx.dense_level + 1)]

    def smooth_data(o, v):
        d = o.gram_diagonal(Ls)
        dis = torch.where(d > 0, torch.rsqrt(d), torch.zeros_like(d))
        for _ in range(14):
            v = dis * o.gram_apply(Ls, dis * v)
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
        lmax = torch.linalg.vector_norm(dis * o.gram_apply(Ls, dis * v))
        # one sync a level: the smoother's scalars become host floats (the
        # same IEEE arithmetic), not a dozen device ops every application
        return d, _item(lmax * 1.15)

    diags = {l: smooth_data(ctx.coarse_ops[l], ctx.start[l])
             for l in range(ctx.dense_level + 1, ctx.n_levels)}
    diags[ctx.n_levels] = smooth_data(ops, ctx.start[ctx.n_levels])
    return "vcycle", (dense_chos, diags)


def pcg_operators(H: GramHessian, pre, smooth_omega=0.7):
    """The equilibrated operators of ``pcg_solve`` from the preconditioner
    data ``pre`` (``make_pcg_pre``): ``(M_s, mv_s, dt)``, the
    preconditioner apply, the Hessian apply (K4) and the equilibration
    scale sqrt(diag H) (FSAI's ``dpos``, or the V-cycle top level's
    diagonal).

    The V-cycle reuses the hierarchy the barrier method searches over:
    the dense base's explicit inverses, Chebyshev (or damped-Jacobi)
    smoothing with matrix-free Gram matvecs (K4) on the other chosen
    levels and the solve level, the composed ELL transfers between them.
    The four preconditioners M_s: the V-cycle, FSAI G'G, and FSAI with the
    coarse correction applied multiplicatively (``fsai2``) or additively
    (``fsai2a``). The Hessian applies go through the level interface
    (K4's per-slot phase per shard under a mesh, K3's phase B once); the
    transfers, the dense inverses and the recurrences run on the first
    device."""
    ops, ctx = H.ops, H.ctx
    kind, data = pre
    top = ctx.n_levels

    def level_mv(l, v):
        return (ops if l == top else ctx.coarse_ops[l]).gram_apply(H.Lnode, v)

    if kind == "vcycle":
        dense_chos, diags = data
        d_top = diags[top][0]
        zero = torch.zeros((), dtype=d_top.dtype, device=d_top.device)
        dinvs = {l: torch.where(d > 0, 1.0 / d, zero)
                 for l, (d, _) in diags.items()}
        jacobi = {l: torch.where(d > 0, smooth_omega / d, zero)
                  for l, (d, _) in diags.items()}

        def smooth(l, b, x0=None):
            # Chebyshev(CHEB_DEG) on D^-1 H over [lmax/4, lmax]
            lmax = diags[l][1]
            dinv = dinvs[l]
            lmin = lmax / 4.0
            theta = (lmax + lmin) / 2.0
            delta = (lmax - lmin) / 2.0
            sigma = theta / delta
            rho = 1.0 / sigma
            if x0 is None:
                x = dinv * b / theta
            else:
                x = x0 + dinv * (b - level_mv(l, x0)) / theta
            dvec = x if x0 is None else x - x0
            for _ in range(CHEB_DEG - 1):
                r = b - level_mv(l, x)
                rho_new = 1.0 / (2.0 * sigma - rho)
                dvec = rho_new * rho * dvec + (2.0 * rho_new / delta) * (
                    dinv * r)
                x = x + dvec
                rho = rho_new
            return x

        def cycle(l, r):
            if l <= ctx.dense_level:
                Minv_l, dinv = dense_chos[l]
                return dinv * (Minv_l @ (dinv * r))
            T = ctx.transfers[l - 1]
            if SMOOTHER == "cheby":
                x = smooth(l, r)
                resid = r - level_mv(l, x)
                x = x + T.mv(cycle(l - 1, T.rmv(resid)))
                return smooth(l, r, x0=x)
            dinv = jacobi[l]
            x = dinv * r
            resid = r - level_mv(l, x)
            x = x + T.mv(cycle(l - 1, T.rmv(resid)))
            return x + dinv * (r - level_mv(l, x))

        dt = torch.sqrt(torch.where(d_top > 0, d_top, torch.ones_like(d_top)))

        def M_s(rs):
            return dt * cycle(top, dt * rs)
    else:
        from .fsai import fsai_apply

        Gtiles, dt, coarse = data

        def fsai(rs):
            return fsai_apply(ctx.fsai, Gtiles, rs)

        if coarse is None:
            M_s = fsai
        else:
            Minv_c, dinv_c = coarse
            T_c = ctx.coarse_T

            def coarse_corr(rs):
                # the raw-space residual dt*rs restricted through the
                # composed transfer, the Galerkin coarse solve, prolonged
                w = T_c.rmv(dt * rs)
                zc = dinv_c * (Minv_c @ (dinv_c * w))
                return dt * T_c.mv(zc)

            if BIG_PRE == "fsai2a":
                def M_s(rs):
                    return fsai(rs) + coarse_corr(rs)
            else:
                def M_s(rs):
                    x1 = fsai(rs)
                    x2 = x1 + coarse_corr(rs - mv_s(x1))
                    return x2 + fsai(rs - mv_s(x2))

    def mv_s(u):
        return ops.gram_apply(H.Lnode, u / dt) / dt

    return M_s, mv_s, dt


@spanned("linsolve.cg")
def pcg_solve(H: GramHessian, g, pre=None, rel_tol=None, maxiter=None,
              smooth_omega=0.7):
    """CG in equilibrated coordinates on a V-cycle or FSAI level, the
    non-dd branch of the reference ``pcg_solve`` (``newton.py:719-910``),
    with the operators of ``pcg_operators``: relative tolerance 1e-5 and
    150 iterations unless given. Returns (x, CG iterations). The dots are
    plain f64 (the reference's x64 path sends them through compensated dd
    dots). One host sync an iteration: the exit test."""
    rel_tol = PCG_RTOL if rel_tol is None else rel_tol
    maxiter = PCG_MAXITER if maxiter is None else maxiter
    M_s, mv_s, dt = pcg_operators(H, make_pcg_pre(H) if pre is None
                                  else pre, smooth_omega)
    bs = g / dt
    tol = rel_tol * torch.linalg.vector_norm(bs)
    z = M_s(bs)
    x = torch.zeros_like(bs)
    r = bs
    p2 = z
    rz = torch.dot(bs, z)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    k = 0
    while k < maxiter and _item(torch.linalg.vector_norm(r) > tol):
        Hp = mv_s(p2)
        pHp = torch.dot(p2, Hp)
        alpha = torch.where(pHp > 0, rz / pHp, zero)
        x = x + alpha * p2
        r = r - alpha * Hp
        z = M_s(r)
        rz2 = torch.dot(r, z)
        beta = torch.where(rz != 0, rz2 / rz, zero)
        p2 = z + beta * p2
        rz = rz2
        k += 1
    return x / dt, k


@spanned("linsolve.cg")
def dense_ir_solve(H: GramHessian, g, pre, rtol):
    """Preconditioned-CG iterative refinement of the Newton system (the
    ``plain64`` branch of the reference ``dense_ir_solve``, ``newton.py:
    327-506``): CG in equilibrated coordinates with the ND factor as
    preconditioner, outer refinement on the true residual. The reference
    sends the dots and the solution accumulator through compensated (dd)
    arithmetic; plain f64 gives the same Newton and CG counts on the
    parity tests (``tests/test_torch_solve.py``), so the port does not.
    Returns (x, total CG iterations)."""
    from ..ops.ndchol import nd_solve

    fact, dinv = pre
    ndp = H.ops.nd
    ops, Lnode = H.ops, H.Lnode

    def mv_s(u):
        return dinv * ops.gram_apply(Lnode, dinv * u)

    def inner(r0):
        rs = dinv * r0
        tol2 = rtol * rtol * _item(torch.dot(rs, rs))
        x = torch.zeros_like(rs)
        r = rs
        p2 = torch.zeros_like(rs)
        rz_prev = 0.0
        k = 0
        while _item(torch.dot(r, r)) > tol2 and k < IR_INNER:
            z = nd_solve(ndp, fact, r)
            rz = _item(torch.dot(r, z))
            beta = rz / rz_prev if (k > 0 and rz_prev != 0) else 0.0
            p2 = z + beta * p2
            Hp = mv_s(p2)
            pHp = _item(torch.dot(p2, Hp))
            alpha = rz / pHp if pHp > 0 else 0.0
            x = x + alpha * p2
            r = r - alpha * Hp
            rz_prev = rz
            k += 1
        return dinv * x, k

    gq = dinv * g
    gnorm = math.sqrt(_item(torch.dot(gq, gq)))
    tau = IR_TAU * rtol * max(gnorm, 1e-30)
    x = torch.zeros_like(g)
    r = g
    rnorm = math.inf
    ko = kcg = 0
    while (ko == 0 or rnorm > tau) and ko < IR_OUTER:
        delta, k_in = inner(r)
        x = x + delta
        r = g - ops.gram_apply(Lnode, x)
        rq = dinv * r
        rnorm = math.sqrt(_item(torch.dot(rq, rq)))
        ko += 1
        kcg += k_in
    return x, kcg


# ---------------------------------------------------------------------------
# stopping criteria and line searches
# ---------------------------------------------------------------------------

def stopping_exact(theta):
    """Stop when the objective AND the gradient norm both stagnate."""
    return ("exact", float(theta), -1.0)


def stopping_inexact(lambda_tol, theta):
    """Stop when the Newton decrement drops below lambda_tol, or exact."""
    return ("inexact", float(theta), float(lambda_tol))


def linesearch_backtracking(beta=0.5, c1=0.1):
    return ("backtracking", float(beta), float(c1))


def linesearch_illinois(beta=0.5):
    return ("illinois", float(beta), 0.0)


def _finite(v: float) -> bool:
    return math.isfinite(v)


@spanned("newton.linesearch")
def _backtracking(f0, f1, x, y, g, n_dir, inc, beta, c1):
    """Armijo backtracking; returns the last finite trial if the sufficient-
    decrease test never passes before s underflows. Trials evaluate the
    objective only; the gradient is computed once at the returned point."""
    s = 1.0
    xb, yb = x, y
    accepted = False
    trials = 0
    while not accepted and s > 0 and trials < _MAX_LS_TRIALS:
        xn = x - s * n_dir
        yn = _item(f0(xn))
        ok = _finite(yn)
        stalled = _item(torch.linalg.vector_norm(xn - x)) == 0
        accepted = ok and (stalled or yn <= y - c1 * inc * s)
        if ok:
            xb, yb = xn, yn
        if not accepted:
            s = s * beta
        trials += 1
    gb = f1(xb)
    # a non-finite gradient at an f0-finite point (barrier-term overflow at
    # the domain wall) falls back to the incoming iterate
    if not _all_finite(gb):
        return x, y, g
    return xb, yb, gb


def _illinois_root(phi, a, b, fa, fb, maxit=128):
    """Illinois variant of regula falsi for phi on [a, b]."""
    k = 0
    done = False
    while not done and k < maxit:
        denom = 1.0 if fb - fa == 0 else fb - fa
        x = (a * fb - b * fa) / denom
        fx = phi(x)
        out = (x <= min(a, b)) or (x >= max(a, b)) or not _finite(fx)
        done = out or (fx * fa == 0) or (fx * fb == 0)
        if fb * fx < 0:
            a, fa = b, fb
        else:
            fa = fa / 2
        b, fb = x, fx
        k += 1
    return b


@spanned("newton.linesearch")
def _illinois_ls(f0, f1, x, y, g, n_dir, inc, beta):
    """Exact line search: root of phi(s) = <grad f(x - s n), n>; falls back
    to shrinking s when the trial is rejected (non-finite)."""

    def phi(s):
        xn = x - s * n_dir
        if not _finite(_item(f0(xn))):
            return math.nan
        return _item(f1(xn) @ n_dir)

    s = 1.0
    xb, yb, gb = x, y, g
    accepted = False
    trials = 0
    while not accepted and s > 0 and trials < _MAX_LS_TRIALS:
        fb = phi(s)
        usable = _finite(fb)
        s_root = s
        if usable and not inc * fb >= 0:
            s_root = _illinois_root(phi, 0.0, s, inc, fb)
        xn = x - s_root * n_dir
        yn = _item(f0(xn))
        gn = f1(xn)
        ok = usable and _finite(yn) and _all_finite(gn)
        if ok:
            xb, yb, gb = xn, yn, gn
        else:
            s = s * beta
        accepted = ok
        trials += 1
    return xb, yb, gb


# ---------------------------------------------------------------------------
# the Newton loop
# ---------------------------------------------------------------------------

def make_newton_core(f0, f1, f2, *, line_search=("backtracking", 0.5, 0.1)):
    """Build the Newton runner.

    ``newton(x0, fargs, maxit, lambda_tol, theta, pred_r=None) ->
    (x, y, k, status, cg)`` where ``fargs = (ops, Dz0, wc, bw, args)`` are
    threaded to f0/f1/f2, ``lambda_tol < 0`` selects the exact criterion,
    and ``cg`` is the total inner-CG iteration count (0 for dense solves).
    ``pred_r`` warm-starts from the central-path tangent predictor.
    """
    ls_kind, ls_beta, ls_c1 = line_search

    def solve(H, g, pre, rtol):
        if isinstance(H, GramHessian):
            if H.ctx.nd is not None:
                return dense_ir_solve(H, g, pre, rtol)
            return pcg_solve(H, g, pre=pre, rel_tol=rtol)
        return equilibrated_solve(H, g), 0

    def make_pre(H):
        # the large level's preconditioner, carried across Newton its;
        # dense levels refactor inside their solve
        if not isinstance(H, GramHessian):
            return None
        return make_nd_pre(H) if H.ctx.nd is not None else make_pcg_pre(H)

    tight_rtol = 1e-5

    def _predict(x0, fargs, H0, pre0, pred_r):
        """Central-path tangent predictor: x(t1) ~ x0 - r H0^{-1} G'(wc)
        with r = (t/t1)(1 - t/t1), G'(wc) being f1 with the barrier weights
        masked to zero; a fraction-to-boundary halving keeps the warm start
        strictly inside the barrier domain (reference ``newton.py:1134``)."""
        if not pred_r > 0:
            return x0
        ops, Dz0, wc, bw, args = fargs
        zero_bw = tuple(map(torch.zeros_like, bw))
        g_lin = f1(x0, ops, Dz0, wc, zero_bw, args)
        d, _ = solve(H0, g_lin, pre0, RTOL_LOOSE)
        step = pred_r * d
        if not _all_finite(step):
            step = torch.zeros_like(step)
        s = 1.0
        accepted = False
        k = 0
        while not accepted and k < 8:
            accepted = _finite(_item(f0(x0 - s * step, *fargs)))
            if not accepted:
                s = 0.5 * s
            k += 1
        return x0 - (s if accepted else 0.0) * step

    @spanned("newton")
    def newton(x0, fargs, maxit, lambda_tol, theta, pred_r=None):
        epsT = torch.finfo(x0.dtype).eps
        H0 = f2(x0, *fargs)
        pre0 = make_pre(H0)
        if pred_r is not None:
            x0 = _predict(x0, fargs, H0, pre0, pred_r)
        F0 = lambda x: f0(x, *fargs)   # noqa: E731
        F1 = lambda x: f1(x, *fargs)   # noqa: E731
        y0 = _item(F0(x0))
        g0 = F1(x0)
        ok0 = _finite(y0) and _all_finite(g0)
        carry_pre = PRE_REFRESH == "auto" and pre0 is not None

        x, y, g = x0, y0, g0
        ymin = y0
        gmin = _item(torch.linalg.vector_norm(g0))
        k = 0
        status = RUNNING if ok0 else BAD_INIT
        lam_prev = math.inf
        cg = 0
        pre_prev, cg_last = pre0, 0
        while status == RUNNING and k < maxit:
            H = f2(x, *fargs)
            # inexact-Newton forcing: far from the centered point the
            # direction only steers the line search, so the corrector runs
            # at the loose tolerance; a stopping iteration re-solves tight
            use_loose = (FORCING and lambda_tol >= 0
                         and lam_prev > 8.0 * lambda_tol)
            rtol_k = RTOL_LOOSE if use_loose else tight_rtol
            if PRE_REFRESH == "1":
                pre_k = make_pre(H)
            elif carry_pre:
                pre_k = make_pre(H) if cg_last > _refresh_at(H) \
                    else pre_prev
            else:
                pre_k = pre0
            n_dir, k_cg = solve(H, g, pre_k, rtol_k)
            inc = _item(g @ n_dir)
            need_fb = False
            if not isinstance(H, GramHessian):
                # lambda^2 <= 0 away from the objective roundoff floor: the
                # Hessian solve failed; retry once with the regularized
                # fallback direction (its decrement is a different quadratic
                # form, so the inexact stop is suppressed)
                at_floor0 = abs(inc) <= epsT * max(abs(y), 1.0)
                need_fb = (inc <= 0 and not at_floor0 and _all_finite(H))
                if need_fb:
                    n_dir = regularized_direction(H, g)
                    inc = _item(g @ n_dir)
            dir_ok = _all_finite(n_dir)
            at_floor = abs(inc) <= max(
                epsT * max(abs(y), 1.0),
                (0.25 * lambda_tol) ** 2 if lambda_tol >= 0 else 0.0)
            bad_inc = inc <= 0
            if ls_kind == "illinois":
                xn, yn, gn = _illinois_ls(F0, F1, x, y, g, n_dir, inc,
                                          ls_beta)
            else:
                xn, yn, gn = _backtracking(F0, F1, x, y, g, n_dir, inc,
                                           ls_beta, ls_c1)
            sqrt_inc = math.sqrt(max(inc, 0.0))
            gn_norm = _item(torch.linalg.vector_norm(gn))
            stop_inexact = (lambda_tol >= 0 and sqrt_inc < lambda_tol
                            and not need_fb and not use_loose)
            stop_exact = ymin <= yn and gn_norm >= theta * gmin
            if not dir_ok:
                status = BAD_DIRECTION
            elif bad_inc:
                status = CONVERGED if at_floor else BAD_HESSIAN
            elif stop_inexact or stop_exact:
                status = CONVERGED
            if dir_ok and not bad_inc:
                x, y, g = xn, yn, gn
                lam_prev = sqrt_inc
                gmin = min(gmin, gn_norm)
            else:
                gmin = min(gmin, _item(torch.linalg.vector_norm(g)))
            ymin = min(ymin, y)
            k += 1
            cg += k_cg
            if carry_pre:
                pre_prev, cg_last = pre_k, k_cg
        if status == RUNNING:
            status = DIVERGED
        return x, y, k, status, cg

    return newton
