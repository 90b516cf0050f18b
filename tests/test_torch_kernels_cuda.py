"""PyTorch port, the seven CUDA kernels against their plain PyTorch versions
on the card, at small ragged shapes and in every mode the wrappers take.

Marked ``cuda``: each test skips without a card. The file imports neither
JAX nor ``mgbtpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: the kernels sum in another order than the plain versions
(per thread in registers, the adjoint's column sums over the inverse
incidence and in fixed shuffle trees, the front factorization and the
front solves in 32-wide panels and tiles where the library blocks
otherwise), so they agree to a few ulps, not bitwise; 1e-13 relative to
the largest entry. They use no atomics, so a repeat call must give the
same bits.
The per-node barrier kernels (K2, K6) follow the plain versions operation
by operation (built with --fmad=false) and are held to the plain versions'
bits (int64 views, so the sign of a zero counts).
"""
import numpy as np
import pytest
import torch

import mgbtpu_torch as mt
import mgbtpu_torch.kernels as K
from mgbtpu_torch.kernels.node_barrier import POWER
from mgbtpu_torch.ops.ndchol import boundary_incidence
from mgbtpu_torch.solver.levelops import inverse_incidence

pytestmark = pytest.mark.cuda
TOL = 1e-13


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(torch.isnan(out).cpu(), torch.isnan(ref).cpu())
    np.testing.assert_array_equal(torch.isposinf(out).cpu(),
                                  torch.isposinf(ref).cpu())
    np.testing.assert_array_equal(torch.isneginf(out).cpu(),
                                  torch.isneginf(ref).cpu())
    fin = torch.isfinite(ref)
    if not fin.any():
        return 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    return err / max(float(ref[fin].abs().max()), 1e-300)


def _panels(rng, dev, nD=4, N=37, p=7, C=13, n_J=101):
    """Sorted per-element columns padded by repeating the last one (zero
    panels on the padded slots), as ``build_panel_ops`` lays them out."""
    cols = np.zeros((N, C), np.int64)
    panels = rng.standard_normal((nD, N, p, C))
    for e in range(N):
        k = rng.integers(max(C // 2, 1), C + 1)
        c = np.sort(rng.choice(n_J, k, replace=False))
        cols[e, :k] = c
        cols[e, k:] = c[-1]
        panels[:, e, :, k:] = 0.0
    inv = inverse_incidence(cols, n_J)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(panels), t(cols), t(inv), n_J


@pytest.mark.parametrize("C", [1, 4, 9, 14, 80])
@pytest.mark.parametrize("nD", [1, 4, 9, 11, 12])
def test_panel_fwd(dev, nD, C):
    """nD = 4 on the main path, 9 and 11 the phase-I rows of parabolic_solve
    and p_harmonic, 12 the most the kernel takes; C from 1 through the
    fem2d_P2 levels' 4..14 to 80, whose element slabs need more than 48 KB
    of shared memory at nD >= 11; N*p = 259 rows, no multiple of a block's
    element group. Dz0 absent and given; a repeat call gives the same
    bits."""
    rng = np.random.default_rng(nD * 100 + C)
    panels, cols, _, n_J = _panels(rng, dev, nD=nD, C=C)
    nD, N, p, _ = panels.shape
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_fwd.launches
    for d in (None, dz0):
        out = K.panel_fwd(panels, cols, s, d)
        assert _rel(out, K.panel_fwd_plain(panels, cols, s, d)) <= TOL
        assert _same_bits(out, K.panel_fwd(panels, cols, s, d))
    assert K.panel_fwd.launches == before + 4


def _same_bits(a, b):
    return a.shape == b.shape and bool((a.view(torch.int64)
                                        == b.view(torch.int64)).all())


# (n_J, N): coarse levels, each element touching half to all of the n_J
# columns (C = n_J), so a column has ~3N/4 slots: K ~ 100, K ~ 495 as at
# L=5 level 0, K ~ 8,192 as at L=7 level 0 (one block per column)
COARSE = [(16, 130), (4, 660), (2, 11000)]


@pytest.mark.parametrize("p", [7, 3])
@pytest.mark.parametrize("nD", [4, 11])
@pytest.mark.parametrize("coarse", [None] + COARSE)
def test_panel_adj(dev, nD, coarse, p):
    """Both phase-B forms, at the fine-level and the coarse-level shapes,
    phase A for the P2 element's p = 7 and for any other p; repeat calls
    give the same bits."""
    rng = np.random.default_rng(1)
    kw = {} if coarse is None else dict(n_J=coarse[0], N=coarse[1],
                                        C=coarse[0])
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, p=p, **kw)
    nD, N, p, _ = panels.shape
    if coarse is not None:
        assert inv.shape[1] > 32 and n_J <= 16
    Y = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_adj.launches
    out = K.panel_adj(panels, cols, inv, Y, n_J)
    assert _rel(out, K.panel_adj_plain(panels, cols, inv, Y, n_J)) <= TOL
    assert _same_bits(out, K.panel_adj(panels, cols, inv, Y, n_J))
    assert K.panel_adj.launches == before + 2


@pytest.mark.parametrize("p", [7, 3])
@pytest.mark.parametrize("nD", [4, 9, 11])
@pytest.mark.parametrize("coarse", [None, COARSE[1]])
def test_gram_matvec(dev, nD, coarse, p):
    """The fused node phase and the per-slot adjoint, then phase B, at the
    main path's nD = 4, the phase-I widths 9 and 11, the P2 element's p = 7
    and any other p, top and coarse shapes; one count per wrapper call,
    repeat calls give the same bits."""
    rng = np.random.default_rng(2)
    kw = {} if coarse is None else dict(n_J=coarse[0], N=coarse[1],
                                        C=coarse[0])
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, p=p, **kw)
    nD, N, p, _ = panels.shape
    Ln = torch.as_tensor(np.tril(rng.standard_normal((N * p, nD, nD))),
                         device=dev)
    v = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    before = K.gram_matvec.launches
    out = K.gram_matvec(panels, cols, inv, Ln, v)
    assert _rel(out, K.gram_matvec_plain(panels, cols, inv, Ln, v)) <= TOL
    assert _same_bits(out, K.gram_matvec(panels, cols, inv, Ln, v))
    assert K.gram_matvec.launches == before + 2


# nz -> (nD, idx, m): the main path's cone (nz = 3 over rows 1..3 of 4),
# and the other sizes over wider, permuted rows; m no multiple of 32 or 64,
# 9,001 above the 8,448 nodes where the blocks grow to 64
CONES = {2: (5, (4, 1), 1000), 3: (4, (1, 2, 3), 1000),
         4: (9, (7, 0, 5, 2), 9001), 5: (12, (11, 3, 8, 0, 6), 9001)}


@pytest.mark.parametrize("nz", [2, 3, 4, 5])
@pytest.mark.parametrize("spec,p", [(2, 1.0), (1, 2.0), (0, 1.5), (0, 3.0)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_power_cone(dev, mode, spec, p, nz):
    """Every (nz, mode, spec) instance against the plain version, bitwise
    (both follow the reference operation by operation; the kernel is built
    with --fmad=false), with infeasible, s = 0, log-of-negative and masked
    nodes; a repeat call gives the same bits."""
    rng = np.random.default_rng(100 * nz + 10 * mode + spec)
    nD, idx, m = CONES[nz]
    q, si = list(idx[:-1]), idx[-1]
    Dz = rng.standard_normal((m, nD))
    Dz[:, si] = np.sqrt((Dz[:, q] ** 2).sum(axis=1)) ** p \
        + rng.uniform(1e-3, 1.0, m)
    Dz[:50, si] = -rng.uniform(0.0, 1.0, 50)    # s < 0
    Dz[50:60, si] = 0.0                          # s == 0
    Dz[60:80, si] *= 0.1                         # inside |q|^p: log of < 0
    bw = np.full(m, 1.0 / m)
    bw[40:45] = 0.0                              # masked infeasible nodes
    bw[100:110] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    A = t(np.tile(np.eye(nz).reshape(1, nz * nz), (m, 1))
          + 0.01 * rng.standard_normal((m, nz * nz)))
    b = t(0.01 * rng.standard_normal((m, nz)))
    pp, mu = t(np.full(m, p)), t(np.full(m, 0.0 if p <= 2 else 1.0))
    args = (t(Dz), A, b, pp, mu, t(bw), t(rng.standard_normal((m, nD))),
            idx, spec)
    before = K.power_cone_eval.launches
    by_mode = list(K.power_cone_eval.mode_launches)
    out = K.power_cone_eval(mode, *args)
    ref = K.power_cone_plain(mode, *args)
    assert _rel(out, ref) <= TOL
    assert _same_bits(out, ref)
    assert _same_bits(out, K.power_cone_eval(mode, *args))
    assert K.power_cone_eval.launches == before + 2
    by_mode[mode] += 2
    assert K.power_cone_eval.mode_launches == by_mode


def _tables(m, rng):
    """The piece tables of the zoo and parabolic_solve, and the kernel's
    widest cases, on random grids: name -> (Convex, D rows)."""
    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear

    def rand_A(n):
        return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
            + 0.01 * rng.standard_normal((m, n * n))

    return {
        "two_sided_obstacle": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=2.0),
            lin(x=x, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
                b=lambda _: np.array([0.1, 1.0]))), 4),
        "rof": (mt.intersect(
            x, cone(x=x, idx=(1, 2, 3), p=1.0),
            cone(x=x, idx=(0, 4), A_grid=rand_A(2),
                 b_grid=0.1 * rng.standard_normal((m, 2)), p=2.0)), 5),
        "p_harmonic": (cone(x=x, idx=(1, 2, 4, 5, 6), A_grid=rand_A(5),
                            p=1.5), 7),
        "parabolic": (mt.intersect(x, cone(x=x, idx=(0, 3), p=2.0),
                                   cone(x=x, idx=(1, 2, 4), p=3.0)), 5),
        # 4 pieces, nc = 4 and ni = 5, nz = 5: over 8 rows, so that the
        # phase-I form (8 + 1 + 3) has the kernel's widest 12 rows
        "four_pieces_widest": (mt.convex_piecewise(
            (lin(x=x, idx=(0, 1, 2, 3, 4),
                 A_grid=rng.standard_normal((m, 20)),
                 b_grid=rng.uniform(2.0, 4.0, (m, 4))),
             cone(x=x, idx=(1, 2, 5, 6, 7), A_grid=rand_A(5), p=1.0),
             cone(x=x, idx=(3, 7), p=2.0),
             lin(x=x, idx=(4,), A=lambda _: np.array([[1.0]]))),
            select_grid=(rng.uniform(size=(m, 4)) < 0.8).astype(float),
            x=x), 8),
    }


TABLES = ["two_sided_obstacle", "rof", "p_harmonic", "parabolic",
          "four_pieces_widest"]


@pytest.mark.parametrize("form", ["barrier", "cobarrier", "phase_one"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("table", TABLES)
def test_node_barrier(dev, table, mode, form):
    """K6 in every mode, as the barrier, the cobarrier (trailing slack) and
    the phase-I barrier (cobarrier + box over 3 component rows), with
    infeasible nodes, masked nodes and pieces switched off."""
    rng = np.random.default_rng(TABLES.index(table))
    m = 1000
    Q, nD = _tables(m, rng)[table]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    Dz[:, s_rows] = rng.uniform(1.0, 3.0, (m, len(s_rows)))  # cones' s
    Dz[:60] *= rng.choice([-4.0, 4.0], (60, nD))        # infeasible nodes
    Dz[60:70, nD - 1] = 0.0
    nu = 3
    co = box = None
    y = Dz
    if form != "barrier":
        y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (m, 1))], axis=1)
        co = nD + 1
        if form == "phase_one":
            y = np.concatenate([y, rng.uniform(-5.0, 5.0, (m, nu))], axis=1)
            y[:5, co] = 12.0                              # outside the box
            box = (t(np.full(m, 4.0)), t(np.full(m, 10.0)))
    bw = np.full(m, 1.0 / m)
    bw[10:20] = 0.0
    args = tuple(t(a) for a in Q.args)
    sel = args[0] if Q.select else None
    call = (mode, t(y), Q.pieces, args, sel, t(bw),
            t(rng.standard_normal(y.shape)), co, box)
    before = (K.node_barrier.launches, K.node_barrier.co_launches)
    out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
    assert _rel(out, ref) <= TOL
    assert _same_bits(out, ref)
    assert K.node_barrier.launches == before[0] + 1
    assert K.node_barrier.co_launches == before[1] + (co is not None)


def _phase_one_call(mode, Q, Dz, rng, t, nu=3, wc=None):
    """K6's phase-I call (cobarrier + box over nu component rows) on the
    rows Dz."""
    m, nD = Dz.shape
    y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (m, 1)),
                        rng.uniform(-5.0, 5.0, (m, nu))], axis=1)
    y[:5, nD + 1] = 12.0                                  # outside the box
    bw = np.full(m, 1.0 / m)
    bw[10:20] = 0.0
    args = tuple(t(a) for a in Q.args)
    sel = args[0] if Q.select else None
    wc = rng.standard_normal(y.shape) if wc is None else wc
    return (mode, t(y), Q.pieces, args, sel, t(bw), t(wc), nD + 1,
            (t(np.full(m, 4.0)), t(np.full(m, 10.0))))


def _instance_table(code, m, rng):
    """4 pieces of the shape of instance ``code`` over 8 rows (rows 6 and 7
    the cones' s), with a select grid: the phase-I form's 8 + 1 + 3 rows are
    the kernel's widest 12."""
    from mgbtpu_torch.kernels.node_barrier import LINEAR_SHAPES

    x = np.zeros((m, 2))
    pieces = []
    for k in range(4):
        if code < 12:
            nz, spec = code // 3 + 2, code % 3
            p = {0: 1.5, 1: 2.0, 2: 1.0}[spec]
            idx = tuple((k + j) % 6 for j in range(nz - 1)) + (6 + k % 2,)
            A = np.tile(np.eye(nz).reshape(1, -1), (m, 1)) \
                + 0.01 * rng.standard_normal((m, nz * nz))
            pieces.append(mt.convex_euclidian_power(x=x, idx=idx, A_grid=A,
                                                    p=p))
        else:
            nc, ni = (LINEAR_SHAPES + ((4, 5),))[code - 12]
            idx = tuple((k + j) % 8 for j in range(ni))
            pieces.append(mt.convex_linear(
                x=x, idx=idx, A_grid=rng.standard_normal((m, nc * ni)),
                b_grid=rng.uniform(2.0, 4.0, (m, nc))))
    return mt.convex_piecewise(
        tuple(pieces), select_grid=(rng.uniform(size=(m, 4)) < 0.8)
        .astype(float), x=x)


@pytest.mark.parametrize("code", list(range(15)))
def test_node_barrier_instance_at_its_widest(dev, code):
    """Each piece-shape instance (12 power cones by (nz, spec), the linear
    (1, 1) and (2, 1) blocks, the runtime-width linear block at nc = 4,
    ni = 5) as 4 pieces in the phase-I form over 12 rows, the kernel's
    widest shared-memory use in mode 2, and in modes 0 and 1; 9,001 nodes,
    above the 8,448 where the blocks would grow to 64 nodes. Bitwise equal
    to the plain version."""
    from mgbtpu_torch.kernels.node_barrier import instance

    rng = np.random.default_rng(700 + code)
    m = 9001
    Q = _instance_table(code, m, rng)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, 8))
    Dz[:, 6:] = rng.uniform(1.0, 3.0, (m, 2))
    Dz[:60] *= rng.choice([-4.0, 4.0], (60, 8))          # infeasible nodes
    for mode in (2, 1, 0):
        call = _phase_one_call(mode, Q, Dz, rng, t)
        inst = instance(Q.pieces, mode, 12, 9, True)
        assert inst.form == 2 and inst.codes == (code,) * 4
        out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
        assert _rel(out, ref) <= TOL
        assert _same_bits(out, ref)


@pytest.mark.parametrize("form", ["barrier", "phase_one"])
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("order", ["linear_first", "cone_first"])
def test_node_barrier_signed_zero_fold(dev, order, mode, form):
    """A linear block whose A row holds -1 and 0 gives -0.0 at its gradient
    entry 1 and Hessian entries (0, 1), (1, 0); a cone on rows 2 and 3
    leaves them alone, so the fold over the pieces adds its exact +0.0 there
    (-0.0 + 0.0 = +0.0) where the block comes first, and keeps the cone's
    +0.0 + -0.0 = +0.0 where it comes last. A select grid switches each
    piece off at some nodes (the inactive piece's +0.0). wc = -0.0, so the
    sign of a zero shows in mode 1 too. Bitwise equal to the plain
    version."""
    rng = np.random.default_rng(31 + mode)
    m, nD = 200, 4
    x = np.zeros((m, 2))
    lin = mt.convex_linear(x=x, idx=(0, 1), A=lambda _: np.array([[-1.0, 0.0]]),
                           b=lambda _: np.array([5.0]))
    cone = mt.convex_euclidian_power(x=x, idx=(2, 3), p=2.0)
    pieces = (lin, cone) if order == "linear_first" else (cone, lin)
    sel = np.ones((m, 2))
    sel[::7, 0] = 0.0
    sel[::5, 1] = 0.0
    Q = mt.convex_piecewise(pieces, select_grid=sel, x=x)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    Dz[:, 3] = rng.uniform(1.0, 3.0, m)
    if form == "barrier":
        args = tuple(t(a) for a in Q.args)
        call = (mode, t(Dz), Q.pieces, args, args[0], t(np.full(m, 0.5)),
                t(np.full((m, nD), -0.0)), None, None)
    else:
        call = _phase_one_call(mode, Q, Dz, rng, t,
                               wc=np.full((m, nD + 4), -0.0))
    out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
    assert _same_bits(out, ref)
    # the block alone leaves -0.0 there (where bw != 0): the case is live
    alone = K.node_barrier_plain(mode, call[1], lin.pieces,
                                 tuple(t(a) for a in lin.args), None,
                                 *call[5:])
    live = call[5] != 0
    entry = (live, 1) if mode == 1 else (live, 0, 1)
    assert torch.signbit(alone[entry]).all()
    assert not torch.signbit(ref[entry]).any()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_node_barrier_repeated_rows(dev, mode):
    """A piece that reads one row twice: the last occurrence's entry wins,
    as the plain version's scatter gives it; barrier and phase-I form,
    bitwise."""
    rng = np.random.default_rng(55 + mode)
    m = 300
    x = np.zeros((m, 2))
    Q = mt.intersect(
        x, mt.convex_linear(x=x, idx=(1, 0, 1),
                            A_grid=rng.standard_normal((m, 6)),
                            b_grid=rng.uniform(2.0, 4.0, (m, 2))),
        mt.convex_euclidian_power(x=x, idx=(0, 2, 3), p=1.0))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, 4))
    Dz[:, 3] = rng.uniform(1.0, 3.0, m)
    args = tuple(t(a) for a in Q.args)
    for call in ((mode, t(Dz), Q.pieces, args, args[0], t(np.full(m, 0.5)),
                  t(rng.standard_normal((m, 4))), None, None),
                 _phase_one_call(mode, Q, Dz, rng, t)):
        out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
        assert _rel(out, ref) <= TOL
        assert _same_bits(out, ref)


def test_node_barrier_has_no_local_memory(dev):
    """ptxas (-v, the committed flags) reports 0 bytes of stack and no
    spills for every function of node_barrier.cu: K6's 9 kernels, one per
    (mode, form), and any callee that was not inlined."""
    from mgbtpu_torch.kernels import _build

    _build.build_all(("node_barrier",), force=True)
    _, info = _build.PTXAS["node_barrier"]
    assert sum("node_barrier_kernel" in k for k in info) == 9
    for name, r in info.items():
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), \
            (name, r)


def test_node_barrier_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(5)
    m = 16
    Q, nD = _tables(m, rng)["rof"]
    args = tuple(torch.as_tensor(a, device=dev) for a in Q.args)
    y = torch.zeros((m, 13), dtype=torch.float64, device=dev)
    ones = torch.ones(m, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="rows exceed"):
        K.node_barrier(0, y, Q.pieces, args, args[0], ones, y)
    y = y[:, :nD]
    with pytest.raises(ValueError, match="cobarrier form"):
        K.node_barrier(0, y, Q.pieces, args, args[0], ones, y,
                       box=(ones, ones))


def _fronts(rng, nk, a, b):
    """SPD fronts (nk, f+1, f+1) with a trailing dump slot, A slightly
    asymmetric (the factor symmetrizes it)."""
    f = a + b
    X = rng.standard_normal((nk, f, 2 * f))
    F = np.zeros((nk, f + 1, f + 1))
    F[:, :f, :f] = X @ X.transpose(0, 2, 1) / f + 0.5 * np.eye(f)
    F[:, :a, :a] += 1e-14 * rng.standard_normal((nk, a, a))
    return F


# (nk, amax, bmax): fem2d_P2 L=5 and L=7 nested-dissection levels
FRONTS = [(64, 73, 16), (32, 3, 24), (1, 31, 1), (7, 1, 18), (4, 91, 190)]
# FRONTS and the widest fronts of L=7: a = 192, and f = a + b = 279
SWEEP_FRONTS = FRONTS + [(1, 192, 1), (8, 43, 236)]
# SWEEP_FRONTS, the L=7 plan's widest levels, one column past a 32-column
# panel, and no boundary block (b = 0)
FACTOR_FRONTS = SWEEP_FRONTS + [(8, 31, 159), (4, 63, 127), (1, 127, 1),
                                (3, 33, 20), (5, 40, 0)]


@pytest.mark.parametrize("nk,a,b", FACTOR_FRONTS)
def test_front_factor(dev, nk, a, b):
    """The panelled factorization against its plain version, with front 1
    not positive definite where there is one; one count per call, repeat
    calls give the same bits."""
    rng = np.random.default_rng(a + b)
    F = _fronts(rng, nk, a, b)
    if nk > 1:
        F[1, a // 2, a // 2] = -1e3               # not positive definite
    F = torch.as_tensor(F, device=dev)
    before = K.front_factor.launches
    outs = K.front_factor(F, a, b)
    for out, ref in zip(outs, K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= TOL
    for out, again in zip(outs, K.front_factor(F, a, b)):
        assert _same_bits(out, again)
    assert K.front_factor.launches == before + 2


def test_front_factor_bad_pivot_in_second_panel(dev):
    """A front whose first pivot that is not > 0 is column 40, inside the
    second 32-column panel, comes back all NaN; its neighbours in the batch
    are finite and match the plain version."""
    nk, a, b = 3, 73, 16
    rng = np.random.default_rng(40)
    F = _fronts(rng, nk, a, b)
    F[1, 40, 40] = -1e3
    F = torch.as_tensor(F, device=dev)
    outs = K.front_factor(F, a, b)
    refs = K.front_factor_plain(F, a, b)
    for out, ref in zip(outs, refs):
        assert torch.isnan(out[1]).all()
        assert torch.isfinite(out[[0, 2]]).all()
        assert _rel(out[[0, 2]], ref[[0, 2]]) <= TOL


def _sweep(rng, dev, nk, a, b):
    """One tree level's factors, dof maps and padded vectors (n_J + 1,):
    assigned dofs distinct with one dump slot (n_J); boundary dofs from a
    shared separator pool (several fronts' updates land on one dof) with a
    dump slot of zero coupling; front 1, where there is one, all NaN, as
    K5a leaves a front that is not positive definite."""
    F = _fronts(rng, nk, a, b)
    Lf = np.linalg.cholesky(F[:, :a, :a])
    U = rng.standard_normal((nk, b, a))
    n_J = nk * a + b + 4
    perm = rng.permutation(n_J)
    adofs = perm[:nk * a].reshape(nk, a)
    adofs[nk // 2, a - 1] = n_J
    bdofs = np.stack([np.sort(rng.choice(perm[nk * a:], b, replace=False))
                      for _ in range(nk)])
    bdofs[0, b - 1] = n_J
    U[0, b - 1] = 0.0
    if nk > 1:
        Lf[1] = U[1] = np.nan
    rows, inc = boundary_incidence(bdofs, n_J)
    v = np.append(rng.standard_normal(n_J), 0.0)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (t(Lf), t(U), t(adofs), t(bdofs), t(rows), t(inc), t(v),
            t(rng.standard_normal((nk, a))))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", SWEEP_FRONTS)
def test_front_solve(dev, nk, a, b, transpose):
    """The fused level sweep against its plain version, forward (y, upd and
    the separator-updated r) and backward (xA and the written x), with the
    NaN front propagating as in the plain version; repeat calls give the
    same bits."""
    rng = np.random.default_rng(a * b)
    Lf, U, adofs, bdofs, rows, inc, v, y = _sweep(rng, dev, nk, a, b)
    before = K.front_solve.launches
    outs = []
    for fwd, bwd in ((K.front_forward, K.front_backward),) * 2 \
            + ((K.front_forward_plain, K.front_backward_plain),):
        w = v.clone()
        if transpose:
            outs.append((bwd(Lf, U, adofs, bdofs, y, w), w))
        else:
            outs.append((*fwd(Lf, U, adofs, w, rows, inc), w))
    assert K.front_solve.launches == before + 2
    for out, again, ref in zip(*outs):
        assert _rel(out, ref) <= TOL
        assert _same_bits(out, again)
    if nk > 1:                                   # the NaN front's slots
        assert torch.isnan(outs[0][0][1][adofs[1] < v.shape[0] - 1]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    panels, cols, inv, n_J = _panels(rng, dev)
    s = torch.zeros(n_J, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float64"):
        K.panel_fwd(panels, cols, s)
    with pytest.raises(ValueError, match="devices"):
        K.panel_fwd(panels, cols.cpu(), s.double())
    # K3's C entry refuses an element whose p*nD values of Y exceed its stage
    cols = torch.tensor([[0, 1, 2], [0, 1, 2]], device=dev)
    inv = torch.as_tensor(inverse_incidence(cols.cpu().numpy(), 3), device=dev)
    wide = torch.zeros((4097, 2, 1, 3), dtype=torch.float64, device=dev)
    Y = torch.zeros((2, 4097), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="panel_adj launch failed"):
        K.panel_adj(wide, cols, inv, Y, 3)
