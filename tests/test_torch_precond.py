"""PyTorch port, the large-level preconditioners that ``MGBTPU_BIG_PRE``
selects (V-cycle, FSAI, FSAI with a two-level coarse correction), on the
CPU against the JAX package on the same seeded inputs:

- ``build_bsr`` + ``mv``/``rmv`` on seeded scipy matrices (1e-14
  relative to the sparse product, and to JAX's where JAX's is right: its
  ``build_bsr`` misplaces entries past one column tile, a fault the port
  does not carry over), and ``shifted_spd_inverse`` on seeded SPD matrices, one past
  the JAX package's 512-wide Cholesky block (1e-12 relative);
- the Threefry Rademacher start vector of the smoother's power iteration:
  bitwise equal to ``jax.random.rademacher(PRNGKey(1905), (n,), f64)``;
- the four checks of ``tests/test_fsai.py`` on the port at the same L=3
  setup, and ``fsai_values``' tiles and scale against JAX's (1e-10);
- ``pcg_solve`` for ``vcycle`` at fem2d_P2 L=2, 3, 4 with DENSE_MAX=50,
  DENSE_BASE=40, p=2, t=100, as ``tests/test_pcg_scaling.py``: x to 1e-8
  relative, the CG count within +-1 of JAX's, and the level-independence
  assert; the other three choices at L=3 the same way;
- the choice reaches the solve: with BIG_PRE="vcycle" the level's context
  is a V-cycle one (no ND plan) and the Newton solve goes through
  ``pcg_solve``; the refresh threshold follows the context. (Every choice
  under a mesh: ``tests/test_torch_mesh_precond*.py``.)

JAX results are computed once per module (``_JAX``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgbtpu
import mgbtpu_torch
from mgbtpu.solver import mgb as MJ
from mgbtpu.solver import newton as NJ
from mgbtpu_torch.solver import mgb as MT
from mgbtpu_torch.solver import newton as NT

torch.set_num_threads(1)
CPU = torch.device("cpu")
_JAX = {}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture()
def knobs(monkeypatch):
    """DENSE_MAX=50, DENSE_BASE=40 in both packages (the top level of L=2..4
    takes the preconditioner); returns a setter of BIG_PRE in both."""
    for M in (MJ, MT):
        monkeypatch.setattr(M.ProblemKernels, "DENSE_MAX", 50)
        monkeypatch.setattr(M.ProblemKernels, "DENSE_BASE", 40)

    def choose(choice):
        monkeypatch.setattr(NJ, "BIG_PRE", choice)
        monkeypatch.setattr(NT, "BIG_PRE", choice)
    return choose


# --- BSR tiles, the dense inverse, the start vector ------------------------

@pytest.mark.parametrize("shape", [(300, 100), (300, 410), (100, 300)])
def test_bsr_matches_jax(shape):
    """The port's tiles give A x and A' y to 1e-14 on every shape, the same
    tile pattern as the JAX package, and its products where the JAX
    package's are right (one column tile; see the next test)."""
    from mgbtpu.ops.bsr import build_bsr as build_j
    from mgbtpu_torch.ops.bsr import build_bsr as build_t

    rng = np.random.default_rng(shape[1])
    A = sp.random(*shape, density=0.03, random_state=rng, format="csr")
    x, y = rng.standard_normal(shape[1]), rng.standard_normal(shape[0])
    Aj, At = build_j(A, np.float64), build_t(A, CPU)
    Pt = At.pattern
    assert (Pt.T, Pt.nrt, Pt.nct) == (Aj.T, Aj.nrt, Aj.nct)
    assert np.array_equal(Pt.rid.numpy(), np.asarray(Aj.rid))
    assert np.array_equal(Pt.cid.numpy(), np.asarray(Aj.cid))
    mv, rmv = At.mv(torch.tensor(x)).numpy(), At.rmv(torch.tensor(y)).numpy()
    assert _rel(mv, A @ x) <= 1e-14
    assert _rel(rmv, A.T @ y) <= 1e-14
    if Pt.nct == 1:
        assert _rel(mv, np.asarray(Aj.mv(jnp.asarray(x)))) <= 1e-14
        assert _rel(rmv, np.asarray(Aj.rmv(jnp.asarray(y)))) <= 1e-14


def test_jax_build_bsr_tiling_fault():
    """The fault the port does not carry over: the JAX package's
    ``build_bsr`` pairs tile ids in sorted-key order with the entries in
    COO order, so with more than one column tile its products are wrong
    (its fsai2/fsai2a coarse transfer at a dense base past 128
    coefficients)."""
    from mgbtpu.ops.bsr import build_bsr as build_j

    rng = np.random.default_rng(410)
    A = sp.random(300, 410, density=0.03, random_state=rng, format="csr")
    x = rng.standard_normal(410)
    assert _rel(np.asarray(build_j(A, np.float64).mv(jnp.asarray(x))),
                A @ x) > 1e-2


@pytest.mark.parametrize("n", [60, 600])
def test_shifted_spd_inverse_matches_jax(n):
    from mgbtpu.ops.blockchol import shifted_spd_inverse as inv_j
    from mgbtpu_torch.ops.blockchol import shifted_spd_inverse as inv_t

    rng = np.random.default_rng(n)
    Q = rng.standard_normal((n, n))
    H = Q @ Q.T + n * np.diag(rng.uniform(0.1, 10.0, n))
    Mj, dj = inv_j(jnp.asarray(H))
    Mt, dt = inv_t(torch.tensor(H))
    assert _rel(dt.numpy(), np.asarray(dj)) <= 1e-14
    assert _rel(Mt.numpy(), np.asarray(Mj)) <= 1e-12
    # the explicit inverse of the equilibrated, shifted matrix
    Hs = H * np.outer(dj, dj) + 2 * np.finfo(np.float64).eps * np.eye(n)
    assert _rel(Mt.numpy() @ Hs, np.eye(n)) <= 1e-10


@pytest.mark.parametrize("n", [1, 7, 128, 1345, 5057])
def test_rademacher_bitwise(n):
    from mgbtpu_torch.utils.threefry import rademacher

    ref = np.asarray(jax.random.rademacher(jax.random.PRNGKey(1905), (n,),
                                           np.float64))
    out = rademacher(1905, n)
    assert out.dtype == np.float64
    assert np.array_equal(out.view(np.uint64), ref.view(np.uint64))


# --- FSAI at the L=3 setup of tests/test_fsai.py ---------------------------

def _fsai_ops(choose, L=3):
    choose("fsai2")
    prob = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.subdivide(
        mgbtpu_torch.fem2d_P2(), L)), p=1.0, device="cpu")
    M1 = prob.M[0]
    kern = MT._kernels_for(M1, prob.Q, None, NT.linesearch_backtracking(),
                           CPU)
    ops = kern.ops(M1.depth - 1)
    assert ops.pcg_ctx is not None and ops.pcg_ctx.fsai is not None
    return ops


def _identity_lnode(ops):
    Lnode = np.zeros((ops.n_nodes, ops.nD, ops.nD))
    Lnode[:, np.arange(ops.nD), np.arange(ops.nD)] = 1.0
    return torch.tensor(Lnode)


def _dense_G(plan, Gtiles):
    from mgbtpu_torch.ops.bsr import B

    n = plan.n_J
    G = np.zeros((plan.g.nrt * B, plan.g.nct * B))
    tiles, rid, cid = Gtiles.numpy(), plan.g.rid.numpy(), plan.g.cid.numpy()
    for t in range(plan.g.T):
        G[rid[t] * B:(rid[t] + 1) * B, cid[t] * B:(cid[t] + 1) * B] += tiles[t]
    return G[:n, :n]


def _fsai_system(ops):
    from mgbtpu_torch.solver.fsai import fsai_values

    plan = ops.pcg_ctx.fsai
    Lnode = _identity_lnode(ops)
    Gtiles, dpos = fsai_values(plan, ops, (Lnode,))
    H = ops.gram_dense((Lnode,)).numpy()
    d = dpos.numpy()
    return plan, Lnode, Gtiles, d, H / d[:, None] / d[None, :]


def _cg_iters(Hs, b, M_apply, tol=1e-8, maxit=500):
    x = np.zeros_like(b)
    r = b.copy()
    z = M_apply(r)
    p2 = z.copy()
    rz = r @ z
    for k in range(maxit):
        if np.linalg.norm(r) <= tol * np.linalg.norm(b):
            return k
        Hp = Hs @ p2
        alpha = rz / (p2 @ Hp)
        x += alpha * p2
        r -= alpha * Hp
        z = M_apply(r)
        rz2 = r @ z
        p2 = z + (rz2 / rz) * p2
        rz = rz2
    return maxit


def test_fsai_diag_normalization(knobs):
    """diag(G Hs G') == 1 up to the 1e-6 jitter, G lower triangular with a
    positive diagonal, and the BSR apply equals the dense G'G r."""
    from mgbtpu_torch.solver.fsai import fsai_apply

    ops = _fsai_ops(knobs)
    plan, Lnode, Gtiles, d, Hs = _fsai_system(ops)
    assert np.isfinite(Gtiles.numpy()).all()
    H = ops.gram_dense((Lnode,)).numpy()
    assert np.allclose(d, np.sqrt(np.diag(H)), rtol=1e-6)
    G = _dense_G(plan, Gtiles)
    assert abs(np.triu(G, 1)).max() == 0.0
    assert np.diag(G).min() > 0
    assert abs(np.einsum("ij,jk,ik->i", G, Hs, G) - 1.0).max() < 1e-3
    r = np.random.default_rng(0).standard_normal(plan.n_J)
    out = fsai_apply(plan, Gtiles, torch.tensor(r)).numpy()
    ref = G.T @ (G @ r)
    assert abs(out - ref).max() < 1e-10 * abs(ref).max()


def test_fsai_pattern_capped(knobs, monkeypatch):
    """The lower pattern is truncated at MGBTPU_FSAI_K entries a row, the
    diagonal kept in the last slot."""
    from mgbtpu_torch.solver.fsai import build_fsai_plan

    ops = _fsai_ops(knobs)
    monkeypatch.setenv("MGBTPU_FSAI_K", "6")
    plan = build_fsai_plan(ops.host_cols, ops.n_J, CPU)
    assert plan.k <= 6 < ops.pcg_ctx.fsai.k
    li, lm = plan.low_idx.numpy(), plan.low_mask.numpy()
    assert (li[np.arange(plan.n_J), -1] == np.arange(plan.n_J)).all()
    assert lm[:, -1].all()


def test_fsai_beats_jacobi_cg(knobs):
    from mgbtpu_torch.solver.fsai import fsai_apply

    ops = _fsai_ops(knobs)
    plan, _, Gtiles, _, Hs = _fsai_system(ops)
    b = np.random.default_rng(0).standard_normal(plan.n_J)
    k_fsai = _cg_iters(Hs, b, lambda r: fsai_apply(
        plan, Gtiles, torch.tensor(r)).numpy())
    k_jac = _cg_iters(Hs, b, lambda r: r / np.diag(Hs))
    assert k_fsai < 0.7 * k_jac, (k_fsai, k_jac)


def test_fsai2_coarse_correction_cuts_cg(knobs):
    from mgbtpu_torch.solver.fsai import fsai_apply

    ops = _fsai_ops(knobs)
    ctx = ops.pcg_ctx
    plan, Lnode, Gtiles, d, Hs = _fsai_system(ops)
    assert ctx.coarse_T is not None
    Hc = ctx.coarse_ops[ctx.dense_level].gram_dense((Lnode,)).numpy()
    Hc_inv = np.linalg.inv(Hc)

    def coarse_corr(rs):
        w = ctx.coarse_T.rmv(torch.tensor(d * rs)).numpy()
        return d * ctx.coarse_T.mv(torch.tensor(Hc_inv @ w)).numpy()

    def fsai_only(r):
        return fsai_apply(plan, Gtiles, torch.tensor(r)).numpy()

    def two_level(rs):
        x1 = fsai_only(rs)
        x2 = x1 + coarse_corr(rs - Hs @ x1)
        return x2 + fsai_only(rs - Hs @ x2)

    b = np.random.default_rng(1).standard_normal(plan.n_J)
    k2, k1 = _cg_iters(Hs, b, two_level), _cg_iters(Hs, b, fsai_only)
    assert k2 < k1, (k2, k1)


def test_fsai_values_match_jax(knobs):
    """The factor tiles and scale of the same seeded node factors, and the
    plan's tiling, equal to JAX's."""
    from mgbtpu.solver.fsai import fsai_values as values_j
    from mgbtpu_torch.solver.fsai import fsai_values as values_t

    ops = _fsai_ops(knobs)
    plan = ops.pcg_ctx.fsai
    prob = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 3)),
                           p=1.0)
    M1 = prob.M[0]
    kj = MJ._kernels_for(M1, prob.Q.barrier, NJ.linesearch_backtracking(),
                         np.float64)
    oj = kj.ops(M1.depth - 1)
    pj = oj.pcg_ctx.fsai
    assert plan.g.T == pj.g_T
    assert np.array_equal(plan.g.rid.numpy(), np.asarray(pj.g_rid))
    assert np.array_equal(plan.g.cid.numpy(), np.asarray(pj.g_cid))
    for name in ("low_idx", "low_mask", "pos_ok"):
        assert np.array_equal(getattr(plan, name).numpy(),
                              np.asarray(getattr(pj, name))), name
    rng = np.random.default_rng(3)
    Ln = np.tril(rng.standard_normal((ops.n_nodes, ops.nD, ops.nD)))
    Ln[:, np.arange(ops.nD), np.arange(ops.nD)] = 1.0 + rng.uniform(
        0, 1, (ops.n_nodes, ops.nD))
    Gj, dj = jax.jit(values_j)(pj, oj, jnp.asarray(Ln))
    Gt, dt = values_t(plan, ops, (torch.tensor(Ln),))
    assert _rel(dt.numpy(), np.asarray(dj)) <= 1e-10
    assert _rel(Gt.numpy(), np.asarray(Gj)) <= 1e-10


# --- pcg_solve against the JAX package -------------------------------------

def _pcg_pair(L, choice, knobs, p=2.0, t=100.0):
    """(x, k) of both packages' pcg_solve on the top level of fem2d_P2
    level L at p, t, s = 0 from g (``tests/test_pcg_scaling.py``'s state),
    the JAX one cached; the port's context beside them."""
    knobs(choice)
    prob_t = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.subdivide(
        mgbtpu_torch.fem2d_P2(), L)), p=p, device="cpu")
    Mt = prob_t.M[0]
    kt = MT._kernels_for(Mt, prob_t.Q, None, NT.linesearch_backtracking(),
                         CPU)
    l = Mt.depth - 1
    ops = kt.ops(l)
    w = Mt.w
    bw = MT.barrier_weights(w, None)
    wc = w[:, None] * (t * prob_t.f_grid)
    z = np.asarray(prob_t.g_grid).T.reshape(-1)
    key = (L, choice, p, t)
    if key not in _JAX:
        prob = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(
            mgbtpu.fem2d_P2(), L)), p=p)
        M1 = prob.M[0]
        kj = MJ._kernels_for(M1, prob.Q.barrier, NJ.linesearch_backtracking(),
                             np.float64)
        oj = kj.ops(l)
        assert oj.pcg_ctx is not None and oj.pcg_ctx.nd is None
        fa = kj._fargs(l, z, wc, bw, tuple(prob.Q.args))
        s0 = jnp.zeros((oj.n_J,), np.float64)
        x, k = NJ.pcg_solve(kj.fns[2](s0, *fa), kj.fns[1](s0, *fa),
                            return_stats=True)
        _JAX[key] = (np.asarray(x), int(k),
                     [o.n_J for o in oj.pcg_ctx.coarse_ops])
    fa = kt._fargs(l, z, wc, bw, tuple(kt.tensor(a) for a in prob_t.Q.args))
    s0 = torch.zeros((ops.n_J,), dtype=torch.float64)
    x, k = NT.pcg_solve(kt.fns[2](s0, *fa), kt.fns[1](s0, *fa))
    return x.numpy(), k, _JAX[key], ops


@pytest.mark.parametrize("L", [2, 3, 4])
def test_pcg_solve_vcycle_matches_jax(L, knobs):
    x, k, (xj, kj, levels), ops = _pcg_pair(L, "vcycle", knobs)
    assert [o.n_J for o in ops.pcg_ctx.coarse_ops] == levels
    assert np.isfinite(x).all()
    assert np.linalg.norm(x - xj) <= 1e-8 * np.linalg.norm(xj)
    assert abs(k - kj) <= 1, (k, kj)


def test_vcycle_cg_iterations_level_independent(knobs):
    """``tests/test_pcg_scaling.py``'s assert on the port's counts."""
    ks = [_pcg_pair(L, "vcycle", knobs)[1] for L in (2, 3, 4)]
    assert max(ks) <= 3 * max(min(ks), 1) + 10, ks
    assert max(ks) < 120, ks


@pytest.mark.parametrize("choice", ["fsai", "fsai2", "fsai2a"])
def test_pcg_solve_fsai_matches_jax(choice, knobs):
    x, k, (xj, kj, _), _ = _pcg_pair(3, choice, knobs)
    assert np.linalg.norm(x - xj) <= 1e-8 * np.linalg.norm(xj)
    assert abs(k - kj) <= 1, (k, kj)


# --- the choice reaches the solve -----------------------------------------

def _top_ops(choice, knobs, L=3):
    knobs(choice)
    prob = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.subdivide(
        mgbtpu_torch.fem2d_P2(), L)), p=1.0, device="cpu")
    M1 = prob.M[0]
    kern = MT._kernels_for(M1, prob.Q, None, NT.linesearch_backtracking(),
                           CPU)
    return prob, kern.ops(M1.depth - 1)


def test_vcycle_context_is_not_nd(knobs, monkeypatch):
    """BIG_PRE="vcycle" gives the level a V-cycle context (no ND plan), and
    the Newton solves of mgb_solve go through pcg_solve, with the V-cycle
    preconditioner and its lax refresh threshold."""
    prob, ops = _top_ops("vcycle", knobs)
    ctx = ops.pcg_ctx
    assert ctx is not None and ctx.nd is None and ops.nd is None
    assert ctx.n_levels == len(ctx.coarse_ops) == len(ctx.transfers) >= 1
    assert ctx.fsai is not None and ctx.coarse_T is not None
    assert len(ctx.start) == ctx.n_levels + 1
    seen = {"pcg": 0, "ir": 0, "kinds": set()}
    pcg, ir = NT.pcg_solve, NT.dense_ir_solve

    def spy_pcg(H, g, pre=None, **kw):
        seen["pcg"] += 1
        seen["kinds"].add(pre[0] if pre is not None else None)
        assert NT._refresh_at(H) == NT.PRE_REFRESH_AT
        return pcg(H, g, pre=pre, **kw)

    def spy_ir(*a, **kw):
        seen["ir"] += 1
        return ir(*a, **kw)

    monkeypatch.setattr(NT, "pcg_solve", spy_pcg)
    monkeypatch.setattr(NT, "dense_ir_solve", spy_ir)
    monkeypatch.setattr(MT, "dense_ir_solve", spy_ir)
    sol = mgbtpu_torch.mgb_solve(prob, device="cpu", tol=1e-1)
    assert np.isfinite(sol.z).all()
    assert seen["pcg"] > 0 and seen["ir"] == 0
    assert seen["kinds"] == {"vcycle"}


def test_nd_stays_the_default(knobs):
    _, ops = _top_ops("nd", knobs)
    assert ops.pcg_ctx.nd is not None and ops.pcg_ctx.coarse_ops == ()
