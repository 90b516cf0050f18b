"""PyTorch port, K6's wide piece tables on the CPU: the tables past the
limits K6 had before (4 pieces, 12 rows, cones nz <= 5, linear blocks
4 x 5): up to 16 pieces over 32 rows, cones nz <= 32 and linear blocks
32 x 32 in the parameter kernels, and past those in the table kernels.

- The five-piece problem that the port refused (a p = 1 cone on rows 1, 2
  and four linear bounds on row 0, on fem1d's 5 nodes) solved by the port's
  plain path and by JAX x64: z to 1e-8, the same ramp.
- K6's plain version (the kernel's stand-in on the CPU) against
  ``jax.vmap`` of the same JAX barrier, cobarrier and phase-I barrier in
  modes 0, 1 and 2, to 1e-13 relative with the same non-finite pattern: six
  pieces (phase I over 14 rows), a lone nz = 7 cone (which ``Convex``
  routes past K2 to K6), a wide linear block (nc = 6, ni = 7) and 16 pieces
  over 28 rows (32 in phase I).
- The new limits raise on every device; K2 keeps the lone cones it takes.
- The three fem1d models past the parameter kernels (``port_models``:
  17 constraints; 16 fields with gradients, 33 rows under a cone of
  nz = 17; 32 fields, 65 rows, nz = 33) solved by the port's plain path
  against their JAX x64 records (``ref_model_wide.npz``,
  ``tests/test_torch_reference_wide_models.py``): z to 1e-8, the same
  ramp, and K6's plain version on their tables against ``jax.vmap`` of the
  JAX barriers to 1e-13 in modes 0 and 1 (``jax.vmap`` of the nz = 17
  Hessian takes 88 s a call here: mode 2 at those widths is held through
  the solves and through ``at_h_a``'s bitwise equality with the scalar
  fold).
"""
import importlib
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
import port_models
from jax_references import DATA, record_of
from mgbtpu.solver.mgb import make_feasibility_fs as feas_ref
from mgbtpu_torch.convex._common import ssum
from mgbtpu_torch.kernels import power_cone as K2
from mgbtpu_torch.solver.mgb import make_feasibility_fs
from port_parity import same_ramp

# the module (the package exports the function of the same name)
K6 = importlib.import_module("mgbtpu_torch.kernels.node_barrier")

torch.set_num_threads(1)
TOL = 1e-13
N = 64


def five_pieces(pkg, dev=None):
    """The reproduction: intersect(cone p = 1 on rows (1, 2), u <= 2 + c
    for c = 0..3) on amg(fem1d(5 nodes))."""
    mg = pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, 5)))
    cone = pkg.convex_euclidian_power(mg, idx=(1, 2), p=1)
    lins = [pkg.convex_linear(mg, idx=(0,), A=lambda x: np.array([[-1.0]]),
                              b=lambda x, c=c: np.array([2.0 + c]))
            for c in range(4)]
    kw = {} if dev is None else dict(device=dev)
    return pkg.assemble(mg, p=1.0, Q=pkg.intersect(mg, cone, *lins), **kw)


def test_five_piece_problem_matches_jax():
    sj = mgbtpu.mgb_solve(five_pieces(mgbtpu))
    st = mt.mgb_solve(five_pieces(mt, "cpu"), device="cpu")
    assert len(five_pieces(mt, "cpu").Q.pieces) == 5
    assert abs(np.linalg.norm(sj.z) - 6.324555270791751) < 1e-12
    same_ramp(sj, st)


def _rand_A(rng, n):
    return np.tile(np.eye(n).reshape(1, -1), (N, 1)) \
        + 0.01 * rng.standard_normal((N, n * n))


def _cases(pkg, rng):
    """name -> (Convex, D rows), built from the same seeded grids in both
    packages."""
    x = np.zeros((N, 2))
    kw = dict(x=x, dtype=np.float64)
    cone, lin = pkg.convex_euclidian_power, pkg.convex_linear
    out = {}
    six = (cone(idx=(1, 2, 9), p=1.0, **kw),
           cone(idx=(3, 8), p=2.0, **kw),
           cone(idx=(4, 5, 6, 9), A_grid=_rand_A(rng, 4), p=1.5, **kw),
           lin(idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
               b=lambda _: np.array([2.0, 2.0]), **kw),
           lin(idx=(0, 7), A_grid=rng.standard_normal((N, 6)),
               b_grid=rng.uniform(2.0, 4.0, (N, 3)), **kw),
           lin(idx=(7,), A=lambda _: np.array([[1.0]]),
               b=lambda _: np.array([3.0]), **kw))
    sel = (rng.uniform(size=(N, 6)) < 0.8).astype(float)
    out["six_pieces"] = (pkg.convex_piecewise(six, select_grid=sel, **kw), 10)
    out["cone_nz7"] = (cone(idx=(0, 1, 2, 3, 4, 5, 8), A_grid=_rand_A(rng, 7),
                            p=1.5, **kw), 9)
    out["cone_nz7_p1"] = (cone(idx=(2, 1, 0, 4, 5, 6, 3), p=1.0, **kw), 7)
    out["wide_linear"] = (lin(idx=(0, 1, 2, 3, 4, 5, 6),
                              A_grid=rng.standard_normal((N, 42)),
                              b_grid=rng.uniform(6.0, 9.0, (N, 6)), **kw), 8)
    sixteen = []
    for k in range(16):
        if k % 2:
            sixteen.append(lin(idx=(k, (k + 5) % 27),
                               A_grid=rng.standard_normal((N, 2)),
                               b_grid=rng.uniform(2.0, 4.0, (N, 1)), **kw))
        else:
            sixteen.append(cone(idx=(k, 27), p=2.0, **kw))
    out["sixteen_pieces"] = (pkg.intersect(x, *sixteen), 28)
    seventeen = [cone(idx=(1, 2), p=1.0, **kw)] + [
        lin(idx=(0,), A=lambda _: np.array([[-1.0]]),
            b=lambda _, c=c: np.array([2.0 + c]), **kw) for c in range(16)]
    out["seventeen_pieces"] = (pkg.intersect(x, *seventeen), 3)
    out["cone_nz17"] = (cone(idx=tuple(range(1, 32, 2)) + (32,),
                             A_grid=_rand_A(rng, 17), p=2.0, **kw), 33)
    out["cone_nz33"] = (cone(idx=tuple(range(1, 64, 2)) + (64,), p=2.0,
                             **kw), 65)
    return out


NAMES = ["six_pieces", "cone_nz7", "cone_nz7_p1", "wide_linear",
         "sixteen_pieces"]
TABLES = ["seventeen_pieces", "cone_nz17", "cone_nz33"]


def _pair(name):
    Qj, nD = _cases(mgbtpu, np.random.default_rng(3))[name]
    Qt, _ = _cases(mt, np.random.default_rng(3))[name]
    return Qj, Qt, nD


def _points(rng, Q, nD, extra=0):
    """Rows inside the sets but for a quarter of the nodes pushed across a
    wall (the cones' s rows large, the rest small)."""
    Y = rng.uniform(-0.3, 0.3, (N, nD + extra))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == K6.POWER})
    Y[:, s_rows] = rng.uniform(2.0, 4.0, (N, len(s_rows)))
    k = N // 4
    Y[:k, :nD] *= rng.choice([-6.0, 6.0], (k, nD))
    return Y


def _same(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    err = np.abs(got[fin] - ref[fin]).max()
    assert err <= TOL * max(np.abs(ref[fin]).max(), 1.0)


def _t(args):
    return tuple(torch.tensor(np.asarray(a)) for a in args)


def _ones_zeros(Y):
    return (torch.ones(Y.shape[0], dtype=torch.float64),
            torch.zeros(Y.shape, dtype=torch.float64))


# every table in every form, but the 16 pieces (whose JAX Hessian alone
# takes ~7 s to trace here) in the phase-I form only, its 32 rows; past the
# parameter kernels, the 17 pieces in every form, the wide cones in modes 0
# and 1 (their JAX Hessians, eager, take minutes)
CALLS = [(n, m, f) for n in NAMES[:-1] for m in (0, 1, 2)
         for f in ("barrier", "cobarrier", "phase_one")] + [
    ("sixteen_pieces", m, "phase_one") for m in (0, 1, 2)] + [
    ("seventeen_pieces", m, f) for m in (0, 1, 2)
    for f in ("barrier", "phase_one")] + [
    ("cone_nz17", 0, "barrier"), ("cone_nz17", 1, "phase_one"),
    ("cone_nz33", 0, "phase_one"), ("cone_nz33", 1, "cobarrier")]


@pytest.mark.parametrize("name,mode,form", CALLS)
def test_wide_table_matches_jax(name, mode, form):
    Qj, Qt, nD = _pair(name)
    rng = np.random.default_rng(50 + mode)
    nu = 3
    if form == "barrier":
        Y = _points(rng, Qt, nD)
        ref = jax.vmap(Qj.barrier[mode])(*Qj.args, jnp.asarray(Y))
        got = Qt.barrier(mode, _t(Qt.args), torch.tensor(Y), *_ones_zeros(Y))
        ny = nD
    elif form == "cobarrier":
        Y = _points(rng, Qt, nD, extra=1)
        Y[:, nD] = rng.uniform(-0.5, 0.5, N)
        ref = jax.vmap(Qj.cobarrier[mode])(*Qj.args, jnp.asarray(Y))
        got = Qt.cobarrier(mode, _t(Qt.args), torch.tensor(Y),
                           *_ones_zeros(Y))
        ny = nD + 1
    else:
        Y = _points(rng, Qt, nD, extra=1 + nu)
        Y[:, nD] = rng.uniform(-0.5, 0.5, N)
        Y[:, nD + 1:] = rng.uniform(-5.0, 5.0, (N, nu))
        Y[:3, nD + 1] = 12.0                            # outside the box
        b, R = np.full(N, 4.0), np.full(N, 10.0)
        Fj = feas_ref(Qj.cobarrier, nD + 1)[mode]
        ref = jax.vmap(Fj)(*Qj.args, b, R, jnp.asarray(Y))
        got = make_feasibility_fs(Qt, nD + 1)(
            mode, _t(Qt.args) + _t((b, R)), torch.tensor(Y), *_ones_zeros(Y))
        ny = nD + 1 + nu
    _same(got.numpy(), np.asarray(ref))
    co = None if form == "barrier" else nD + 1
    inst = K6.instance(Qt.pieces, mode, ny, co, form == "phase_one")
    assert len(inst.codes) == len(Qt.pieces)
    assert inst.table == (name in TABLES) == (ny > K6.MAX_ROWS
                                              or len(Qt.pieces) > 16)


def test_at_h_a_is_the_scalar_fold():
    """K2's A' Hz A, folded over all entries at once, gives the bits of
    the scalar left fold over (k, l) pairs that the JAX package writes
    (``_AtHA``)."""
    rng = np.random.default_rng(11)
    nz = 9
    A = torch.tensor(rng.standard_normal((N, nz * nz)))
    Hz = [[torch.tensor(rng.standard_normal(N)) for _ in range(nz)]
          for _ in range(nz)]
    got = K2.at_h_a(A, Hz, nz)
    for i in range(nz):
        for j in range(nz):
            ref = ssum([A[:, k * nz + i] * Hz[k][l] * A[:, l * nz + j]
                        for k in range(nz) for l in range(nz)])
            assert torch.equal(got[i][j], ref)


WIDE = os.path.join(DATA, "ref_model_wide.npz")
TABLE_OF = {"seventeen_constraints": (17, 3), "sixteen_fields": (1, 33),
            "thirty_two_fields": (1, 65)}


@pytest.mark.parametrize("name", port_models.WIDE_MODELS)
def test_wide_model_matches_x64(name):
    """The models past the parameter kernels solve on the port's CPU path
    to their JAX x64 records: z to 1e-8 of x64, the same steps, and the
    same Newton its on the first three ramp steps; from the fourth the
    decrement on these 8 nodes sits at the objective's roundoff floor
    (ROADMAP Queue 3, fem1d), each step within +-1 and all within +-4."""
    mg = mt.amg(mt.fem1d(nodes=np.linspace(-1.0, 1.0, 5)))
    m, _ = port_models.MODELS[name](mt, mg, device="cpu")
    sol = m.solve(**port_models.SOLVE)
    Q, M = m._lowered["prob"].Q, m._lowered["prob"].M[0]
    assert (len(Q.pieces), len(M.D_fine)) == TABLE_OF[name]
    assert K6.instance(Q.pieces, 2, len(M.D_fine)).table
    rec = record_of(np.load(WIDE), name)
    ref = SimpleNamespace(z=rec["z"], SOL_main=dict(
        its=rec["its"], steps_accepted=int(rec["steps"][0]),
        steps_attempted=int(rec["steps"][1])))
    same_ramp(ref, sol, floor_from=3)


def test_instances_of_the_wide_shapes():
    names = {K6.instance_name(K6.instance_code(K6.POWER, nz, nz, s))
             for nz in range(6, 33) for s in range(3)}
    assert names == {"power<runtime, 0>", "power<runtime, 1>",
                     "power<runtime, 2>"}
    assert K6.instance_code(K6.POWER, 5, 5, 2) == 11     # registers still
    assert K6.instance_code(K6.LINEAR, 4, 5, 0) == K6.LINEAR_ANY
    for nc, ni in ((5, 1), (1, 6), (32, 32), (6, 7)):
        assert K6.instance_name(K6.instance_code(K6.LINEAR, nc, ni, 0)) \
            == "linear<wide>"
    # a table with a wide piece runs every piece in the wide kernels
    mixed = (K6.Piece(K6.POWER, tuple(range(7)), 7, 2),
             K6.Piece(K6.POWER, (0, 1, 2), 3, 1), K6.Piece(K6.LINEAR, (0,), 1))
    inst = K6.instance(mixed, 2, 11, 8, True)
    assert inst.wide and str(inst) == (
        "node_barrier_wide_kernel<mode 2, cobarrier + box> "
        "[power<runtime, 2>, power<runtime, 1>, linear<wide>]")
    assert not K6.instance(mixed[1:], 2, 8).wide
    Qt = _pair("six_pieces")[1]
    assert [K6.instance_name(c) for c in
            K6.instance(Qt.pieces, 2, 14, 11, True).codes] == [
        "power<3, 2>", "power<2, 1>", "power<4, 0>", "linear<2, 1>",
        "linear<runtime>", "linear<1, 1>"]


def _cone(nz, rows=None):
    return K6.Piece(K6.POWER, tuple(range(nz)) if rows is None else rows,
                    nz, 0)


@pytest.mark.parametrize("pieces,ny,what", [
    ((_cone(2),) * 17 + (_cone(2, (0, 4)),), 4, "idx"),
    ((_cone(2),), 0, "0 rows"),
    ((_cone(33, (0, 1) * 16),), 4, "is no piece"),
    ((K6.Piece(K6.LINEAR, (0,), 0),), 4, "is no piece"),
    ((K6.Piece(K6.LINEAR, (0, 1, 2) * 11 + (4,), 1),), 4, "idx"),
])
def test_the_new_limits_raise(pieces, ny, what):
    """On every device: the host check runs before the device is looked
    at, and the plain version refuses what the kernel refuses. Past 16
    pieces, 32 rows and widths of 32 only what is no table raises: the
    table kernels take the rest."""
    with pytest.raises(ValueError, match=what):
        K6.instance(pieces, 0, ny)
    m = 4
    one = torch.ones(m, dtype=torch.float64)
    y = torch.ones((m, ny), dtype=torch.float64)
    grids = [torch.ones((m, w), dtype=torch.float64) for w in (1, 1, 0, 0)]
    args = (grids[0], grids[1], one, one)
    with pytest.raises(ValueError, match=what):
        K6.node_barrier(0, y, pieces, args, None, one, y)


def test_lone_cones_route_by_shape(monkeypatch):
    """A lone cone K2 takes goes to K2; one past it (nz > 5, or more than
    12 rows) to K6 on every device, so the CPU runs the same function as
    the card."""
    calls = []
    real = K2.power_cone_eval

    def spy(*a, **k):
        calls.append(len(a[8]))
        return real(*a, **k)

    monkeypatch.setattr(K2, "power_cone_eval", spy)
    x = np.zeros((N, 1))
    for nz, nD, k2 in ((5, 7, True), (7, 9, False), (3, 13, False)):
        Q = mt.convex_euclidian_power(x=x, idx=tuple(range(nz)), p=2.0)
        Y = torch.ones((N, nD), dtype=torch.float64)
        Y[:, nz - 1] = 3.0
        before = len(calls)
        out = Q.barrier(1, _t(Q.args), Y, *_ones_zeros(Y))
        assert out.shape == (N, nD)
        assert (len(calls) > before) == k2
