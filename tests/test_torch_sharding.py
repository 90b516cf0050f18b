"""PyTorch port, multi-device solves on the CPU: meshes of CPU shards
(``make_mesh(devices=["cpu"] * n)``) go through the code a mesh of cards
runs, as the JAX package's sharding tests run on XLA's virtual 8-device
CPU mesh (``tests/test_sharding.py``, ``tests/test_ndchol.py``). No test
here runs a sharded JAX solve.

- The sharding rule gives JAX's ``node_sharding`` split for the same
  shapes (panels, cols, node grids, an element count that does not divide).
- The level operators of the fem2d_P2 L=3 top level (N = 32 elements)
  over 8 and 4 shards: the bits of the unsharded ones, and within 1e-12
  of the JAX x64 level functions.
- One Gram matvec on an ND level moves one piece a shard, its (N/n * C,)
  per-slot contributions, and one broadcast of v, nothing of (n_J, n_J)
  (``test_fine_pcg_matvec_collectives``).
- The subtree-per-device ND factor (``test_nd_factor_subtree_sharding``):
  per-device factor bytes total/n on every divisible level, < 0.55 of the
  total in all, the solve within 1e-10 of the dense one, and
  ``nd_memory_report``'s bytes those of the tensors.
- Solves: fem2d_P2 L=2 p=1.5 over 8 shards within 2e-7 of JAX x64's
  unsharded solve and of the port's; the ND-CG branch under a mesh (L=3,
  ``DENSE_MAX`` low) within 5e-12 of the unsharded solve; ``parabolic_solve``
  and ``Model.solve`` pass ``mesh`` on; ``make_mesh()`` raises without a
  card; ``profile_dir`` writes a trace and the solve's record; L=5 over 8 shards against the x64
  record (``slow``).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
import port_models
from mgbtpu.ops.ndchol import _assemble_dense
from mgbtpu.parallel.sharding import make_mesh as make_mesh_ref
from mgbtpu.parallel.sharding import node_sharding as node_sharding_ref
from mgbtpu.solver.barrier import make_level_fns as level_ref
from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu.solver.levelops import gram_diag as gram_diag_ref
from mgbtpu.solver.levelops import gram_matvec as gram_matvec_ref
from mgbtpu_torch.ops import ndchol as NT
from mgbtpu_torch.parallel.sharding import (TRANSFERS, node_sharding,
                                            reset_transfers, shard_ranges)
from mgbtpu_torch.solver import mgb as MT
from mgbtpu_torch.solver.levelops import (ShardedOps, build_panel_ops,
                                          gram_diag, gram_element_blocks,
                                          gram_matvec)
from mgbtpu_torch.solver.newton import linesearch_backtracking
from test_ndchol import _grid_case

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mgbtpu_torch", "data")


def cpu_mesh(n):
    return mt.make_mesh(devices=["cpu"] * n)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("n", [8, 4])
def test_sharding_rule_matches_jax(n):
    """The same axis and the same contiguous ranges as JAX's sharding of
    the same shapes on the virtual mesh (N = 32 elements, p = 6, nD = 4,
    C = 13; an element count of 36 that does not divide by 8)."""
    N, p, nD, C = 32, 6, 4, 13
    mesh_j, mesh_t = make_mesh_ref(n), cpu_mesh(n)
    cases = [((nD, N, p, C), {N * p, N}), ((N, C), {N * p, N}),
             ((N * p, nD), {N * p, N}), ((N * p,), {N * p, N}),
             ((36, C), {36 * p, 36}), ((7, 5), {36 * p, 36})]
    for shape, sizes in cases:
        sh = node_sharding_ref(mesh_j, np.zeros(shape), sizes)
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        ax = node_sharding(mesh_t, shape, sizes)
        assert ax == (spec.index("nodes") if "nodes" in spec else None)
        ranges = None if ax is None else shard_ranges(mesh_t, shape[ax])
        dmap = sh.devices_indices_map(shape)
        for d, dev in enumerate(mesh_j.devices.flat):
            sl = dmap[dev]
            for a in range(len(shape)):
                got = (sl[a].start or 0, sl[a].stop or shape[a])
                want = ranges[d] if a == ax else (0, shape[a])
                assert got == want, (shape, d, a)
    assert shard_ranges(cpu_mesh(8), 36) is None


def _level():
    """The top level of fem2d_P2 L=3 (N = 32) in both packages, with
    seeded s, rows and weights."""
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 3)),
                         p=1.0)
    pt = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 3)), p=1.0,
                     device="cpu")
    M = pt.M[0]
    rng = np.random.default_rng(21)
    z = pt.g_grid.T.reshape(-1)
    w = M.w
    wc = w[:, None] * (50.0 * pt.f_grid)
    bw = np.where(w != 0, 1.0 / np.count_nonzero(w), 0.0)
    return pj, pt, M, z, wc, bw, rng


@pytest.mark.parametrize("n", [8, 4])
def test_level_operators_sharded_match(n):
    pj, pt, M, z, wc, bw, rng = _level()
    ls = linesearch_backtracking()
    k0 = MT._kernels_for(M, pt.Q, None, ls, torch.device("cpu"))
    kn = MT._kernels_for(M, pt.Q, None, ls, torch.device("cpu"),
                         cpu_mesh(n))
    l = M.depth - 1
    args = tuple(k0.tensor(a) for a in pt.Q.args)
    fa0 = k0._fargs(l, z, wc, bw, args)
    fan = kn._fargs(l, z, wc, bw, args)
    o0, on = fa0[0], fan[0]
    assert isinstance(on, ShardedOps) and len(on.shards) == n
    assert on.nodes[1] == (o0.n_nodes // n, 2 * o0.n_nodes // n)
    s = torch.tensor(1e-3 * rng.standard_normal(o0.n_J))
    (dz0,) = fa0[1]                     # one device: one shard
    Dz0 = o0.apply_G(s, dz0)
    assert _rel(torch.cat(on.shard_G(s, fan[1])), Dz0) == 0.0
    Y = torch.tensor(rng.standard_normal((o0.n_nodes, o0.nD)))
    assert _rel(on.adjoint(on.split(Y)), o0.apply_Gt(Y)) == 0.0
    fj = level_ref(pj.Q.barrier)
    oj = build_ref(pj.M[0].D_fine, pj.M[0].nu, pj.M[0].R_fine[l], 7,
                   np.float64)
    fa_j = (oj, jax.numpy.asarray(dz0.numpy()), jax.numpy.asarray(wc),
            jax.numpy.asarray(bw)) + tuple(pj.Q.args)
    for k, (f0, fn) in enumerate(zip(k0.fns, kn.fns)):
        got, ref = fn(s, *fan), f0(s, *fa0)
        assert _rel(got, ref) == 0.0, k
        assert _rel(got, fj[k](jax.numpy.asarray(s.numpy()), *fa_j)) \
            <= 1e-12, k
    B = rng.standard_normal((o0.n_nodes, o0.nD, o0.nD))
    Ln = torch.tensor(np.tril(B))
    v = torch.tensor(rng.standard_normal(o0.n_J))
    Lsh = on.split(Ln)
    assert _rel(on.gram_apply(Lsh, v), gram_matvec(o0, Ln, v)) == 0.0
    assert _rel(on.gram_apply(Lsh, v), gram_matvec_ref(
        oj, jax.numpy.asarray(Ln.numpy()), jax.numpy.asarray(v.numpy()))
    ) <= 1e-12
    assert _rel(on.gram_diagonal(Lsh), gram_diag(o0, Ln)) == 0.0
    assert _rel(on.gram_diagonal(Lsh), gram_diag_ref(
        oj, jax.numpy.asarray(Ln.numpy()))) <= 1e-12
    He = on.gram_blocks(Lsh, v)
    assert _rel(torch.cat(He), gram_element_blocks(o0, Ln, v)) == 0.0
    assert _rel(on.gram_blocks_first(Lsh), gram_element_blocks(o0, Ln)) \
        == 0.0
    assert _rel(on.gram_dense(Lsh), o0.gram_dense((Ln,))) == 0.0
    Yb = torch.tensor(B @ np.swapaxes(B, 1, 2))
    assert _rel(on.dense_hessian(on.split(Yb)), o0.assemble_dense(Yb)) \
        == 0.0


def test_gram_matvec_transfers(monkeypatch):
    """One Gram matvec on an ND level over 8 shards: v broadcast once, each
    shard's per-slot contributions (N/8 * C doubles) gathered once, nothing
    of (n_J, n_J) moved."""
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_MAX", 50)
    pt = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 3)), p=1.0,
                     device="cpu")
    M = pt.M[0]
    kern = MT._kernels_for(M, pt.Q, None, linesearch_backtracking(),
                           torch.device("cpu"), cpu_mesh(8))
    ops = kern.ops(M.depth - 1)
    assert isinstance(ops, ShardedOps) and ops.nd is not None
    Ln = ops.split(torch.eye(ops.nD, dtype=torch.float64).expand(
        ops.n_nodes, ops.nD, ops.nD).contiguous())
    v = torch.ones(ops.n_J, dtype=torch.float64)
    reset_transfers()
    ops.gram_apply(Ln, v)
    nv, ns = 8 * ops.n_J, 8 * ops.N // 8 * ops.C
    assert TRANSFERS == dict(gathers=8, broadcasts=1, bytes=nv + 8 * ns,
                             largest=max(nv, ns))


def test_nd_subtree_per_device():
    """``test_nd_factor_subtree_sharding`` on the port: a 20 x 20 grid of
    triangles, leaves of 6 elements, 8 devices, the element blocks in 8
    element shards."""
    cols, n, xy, He = _grid_case(20, 20, seed=3)
    plan = NT.NDPlan(cols, n, xy, leaf_elems=6)
    mesh = cpu_mesh(8)
    dp = NT.NDDevicePlan(plan).to_device(mesh=mesh)
    Het = torch.tensor(He)
    fact = NT.nd_factor(dp, tuple(Het.chunk(8)), 1e-12)
    rhs = np.random.default_rng(7).standard_normal(n)
    x = NT.nd_solve(dp, fact, torch.tensor(rhs)).numpy()
    x0 = np.linalg.solve(_assemble_dense(plan, He, 1e-12), rhs)
    assert np.abs(x - x0).max() <= 1e-10 * np.abs(x0).max()
    whole = NT.nd_factor(NT.NDDevicePlan(plan).to_device("cpu"), Het, 1e-12)
    rep = NT.nd_memory_report(dp)
    total = shard_max = 0
    assert 0 < len(dp.parts) < len(dp.levels)
    for li, (lvl, ref) in enumerate(zip(fact, whole)):
        nbytes = sum(a.nbytes for a in ref)
        total += nbytes
        assert rep["levels"][li]["factor_bytes"] == nbytes
        if li < len(dp.parts):
            per = [sum(a.nbytes for a in part) for part in lvl]
            assert all(b * 8 == nbytes for b in per)
            assert rep["levels"][li]["device_bytes"] == per[0]
            shard_max += per[0]
        else:
            assert dp.levels[li].nk < 8 and lvl[0].device == mesh.first
            shard_max += nbytes
    assert rep["factor_bytes"] == total
    assert rep["device_factor_bytes"][0] == shard_max
    assert shard_max < 0.55 * total


def _l2(p=1.5):
    return mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 2)), p=p,
                       device="cpu")


def test_sharded_solve_matches_jax_and_unsharded():
    """fem2d_P2 L=2 (8 elements) p=1.5 over 8 shards: within 2e-7 of the
    JAX x64 unsharded solve (the bar of ``test_sharded_solve_matches_unsharded``)
    and of the port's unsharded solve."""
    zj = mgbtpu.mgb_solve(mgbtpu.assemble(
        mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 2)), p=1.5)).z
    prob = _l2()
    z0 = mt.mgb_solve(prob, device="cpu").z
    reset_transfers()
    z1 = mt.mgb_solve(prob, mesh=cpu_mesh(8)).z
    assert TRANSFERS["gathers"] > 0
    assert np.abs(z1 - zj).max() < 2e-7
    assert np.abs(z1 - z0).max() < 2e-7
    np.testing.assert_array_equal(z1, z0)       # the bits of one device


def test_sharded_nd_branch_matches_unsharded(monkeypatch):
    """L=3 p=1 with DENSE_MAX forced to 50, so that the levels above it
    solve by ND-preconditioned CG under the mesh (element-sharded Gram
    operators; ND leaves of 2 elements, so that the trees' 16 and 8 front
    levels split over the 8 devices): within 5e-12 of the unsharded solve
    (``test_sharded_solve_L5_default_config``'s bar), its Newton its within
    5 % (PERF.md section 2)."""
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(MT.ProblemKernels, "ND_LEAF_ELEMS", 2)
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 3)), p=1.0,
                       device="cpu")
    s0 = mt.mgb_solve(prob, device="cpu")
    mesh = cpu_mesh(8)
    s1 = mt.mgb_solve(prob, mesh=mesh, device="cpu")
    kern = MT._kernels_for(prob.M[0], prob.Q, None,
                           linesearch_backtracking(), torch.device("cpu"),
                           mesh)
    ops = kern.ops(prob.M[0].depth - 1)
    assert isinstance(ops, ShardedOps) and len(ops.nd.parts) > 0
    assert np.abs(s1.z - s0.z).max() < 5e-12
    its0, its1 = s0.SOL_main["its"].sum(), s1.SOL_main["its"].sum()
    assert abs(int(its1) - int(its0)) <= 0.05 * its0
    np.testing.assert_array_equal(s1.z, s0.z)   # the bits of one device
    np.testing.assert_array_equal(s1.SOL_main["cg"], s0.SOL_main["cg"])


def test_parabolic_and_model_pass_the_mesh_on():
    mg = mt.amg(mt.subdivide(mt.fem2d_P2(), 1))      # 2 elements
    mesh = cpu_mesh(2)
    calls = []
    real = MT.mgb_driver

    def spy(*a, **k):
        calls.append(k.get("mesh"))
        return real(*a, **k)

    MT.mgb_driver = spy
    try:
        p1 = mt.parabolic_solve(mg, h=0.5, p=1.0, device="cpu", mesh=mesh)
        m1, _ = port_models.torsion(mt, mg, device="cpu")
        z1 = m1.solve(mesh=mesh, **port_models.SOLVE).z
    finally:
        MT.mgb_driver = real
    assert calls and all(c is mesh for c in calls)
    p0 = mt.parabolic_solve(mg, h=0.5, p=1.0, device="cpu")
    for a, b in zip(p1.u, p0.u):
        assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1.0)
    m0, _ = port_models.torsion(mt, mg, device="cpu")
    z0 = m0.solve(**port_models.SOLVE).z
    assert np.abs(z1 - z0).max() <= 1e-8 * np.abs(z0).max()


def test_make_mesh_needs_a_card_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.make_mesh()
    assert cpu_mesh(3).size == 3 and cpu_mesh(3).first.type == "cpu"
    assert mt.make_mesh(2, devices=["cpu"] * 8).size == 2


def test_profile_dir_writes_a_trace(tmp_path):
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 1)), p=1.0,
                       device="cpu")
    sol = mt.mgb_solve(prob, device="cpu", profile_dir=str(tmp_path))
    assert np.all(np.isfinite(sol.z))
    trace, records = sorted(os.listdir(tmp_path))
    assert trace.endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / trace) > 0
    # beside it, the solve's record (utils/trace.py)
    assert records == trace.replace(".pt.trace.json", ".records.json")
    with open(tmp_path / records) as fh:
        rec = json.load(fh)
    assert {"seq", "launches", "syncs", "transfers", "enqueue_ns",
            "builds"} <= set(rec) and rec["syncs"] > 0


@pytest.mark.slow
def test_sharded_l5_matches_the_x64_record():
    """fem2d_P2 p=1 L=5 over 8 CPU shards (the ND branch at its default
    DENSE_MAX) against the stored x64 record: z to 1e-6, Newton its within
    5 %."""
    ref = np.load(os.path.join(DATA, "ref_fem2d_p2_L5.npz"))
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), 5)), p=1.0,
                       device="cpu")
    sol = mt.mgb_solve(prob, mesh=cpu_mesh(8))
    z = ref["z"]
    assert np.linalg.norm(sol.z - z) <= 1e-6 * np.linalg.norm(z)
    its, its_ref = sol.SOL_main["its"].sum(), ref["its"].sum()
    assert abs(int(its) - int(its_ref)) <= 0.05 * its_ref
