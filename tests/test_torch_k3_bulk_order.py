"""PyTorch port: K3's phase-A row order (its staged and bulk forms) and the
bulk form's rule by shape, on the CPU against the JAX package in float64.

``panel_adj_contrib_rows_plain`` folds each slot's rows i = k*p + q in
that order from 0.0, each product and sum rounded apart: the bits of K3's
staged and bulk forms on the card (built with --fmad=false; the card tests
hold both kernels to it). Here it is held to the per-slot contributions of
JAX's x64 ``PanelOps.apply_Gt`` (the einsum at
``mgbtpu/solver/levelops.py:104-107``) and, scattered by phase B's order
(``adjoint_sum_ordered_plain``), to ``apply_Gt`` itself, to 1e-13 relative
to the largest entry (two orders of the same sums of at most 512
products), at a real fem3d k=3 L=2 level carried over by
``from_reference_arrays``, at seeded panels of the fem3d shapes and at
ragged shapes; and bitwise to a sequential numpy fold in the same order.

``bulk_form_takes`` mirrors the C entry's rule (``adjoint_form`` in
``csrc/adjoint.cuh``; the card tests hold the two to each other): the
bulk form runs the fem3d levels (of 320 or 512 rows, at least 8
elements) with an even C, and no fem2d_P2 or spectral level. The level shapes
are ``chip_smoke.FEM3D_K3_C`` (L = 2 and 3 rebuilt here from the problem,
L = 4 and 5 checked on the card by ``chip_smoke.py``).
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch as mt
from chip_smoke import FEM3D_K3_C, fem3d_k3_shapes
from mgbtpu.solver.levelops import PanelOps
from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.kernels import panel_adj_contrib_rows_plain
from mgbtpu_torch.solver.levelops import build_panel_ops, inverse_incidence

torch.set_num_threads(1)
PA = sys.modules["mgbtpu_torch.kernels.panel_adj"]   # the module
TOL = 1e-13


def _seeded(rng, nD, C, N=3, p=64, n_J=400):
    """N elements of p nodes over n_J columns, as ``build_panel_ops`` lays
    them out (sorted slots, the last repeated with zero panels)."""
    cols = np.zeros((N, C), np.int64)
    panels = rng.standard_normal((nD, N, p, C))
    for e in range(N):
        k = rng.integers(C - C // 4, C + 1)
        c = np.sort(rng.choice(n_J, k, replace=False))
        cols[e, :k] = c
        cols[e, k:] = c[-1]
        panels[:, e, :, k:] = 0.0
    return panels, cols, n_J


def _ref_ops(panels, cols, n_J):
    nD, N, p, C = panels.shape
    return PanelOps(cols=jnp.asarray(cols), panels=jnp.asarray(panels),
                    n_nodes=N * p, nD=nD, n_J=n_J, p=p, N=N, C=C)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _hold(panels, cols, n_J, ref_ops, rng):
    """The rows order against JAX's einsum per slot and its apply_Gt."""
    nD, N, p, C = panels.shape
    Y = rng.standard_normal((N * p, nD))
    rows = panel_adj_contrib_rows_plain(torch.as_tensor(panels),
                                        torch.as_tensor(Y))
    einsum = np.asarray(jnp.einsum("kNpc,Npk->Nc", ref_ops.panels,
                                   jnp.asarray(Y).reshape(N, p, nD)))
    assert _rel(rows.numpy().reshape(N, C), einsum) <= TOL
    inv = torch.as_tensor(inverse_incidence(cols, n_J))
    out = PA.adjoint_sum_ordered_plain(inv, rows).numpy()
    assert _rel(out, np.asarray(ref_ops.apply_Gt(jnp.asarray(Y)))) <= TOL


@pytest.mark.parametrize("system", [0, 1])
def test_rows_order_at_fem3d_level(system):
    """subdivide(fem3d(k=3), 2)'s top level, main (nD = 5, C = 91) and
    phase-I (nD = 8, C = 155) systems: JAX's panel plan carried into the
    port; its shape is the stored one (odd C: the staged form's)."""
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem3d(k=3), 2)),
                         p=1.0)
    M = pj.M[system]
    oj = build_ref(M.D_fine, M.nu, M.R_fine[-1], 64, np.float64)
    ot = from_reference_arrays(device="cpu", panel_ops=dict(
        cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
        n_J=oj.n_J))["panel_ops"]
    nD, N, p, C = ot.panels.shape
    assert (nD, N, p, C) == ((5, 8)[system], 8, 64, FEM3D_K3_C[2][system][-1])
    assert not PA.bulk_form_takes(nD, N, p, C)
    _hold(ot.panels.numpy(), ot.cols.numpy(), ot.n_J, oj,
          np.random.default_rng(17 + system))


@pytest.mark.parametrize("nD,C", [(5, 128), (8, 192)])
def test_rows_order_at_fem3d_shapes(nD, C):
    """The fem3d top levels' element shapes: p = 64 with (nD, C) = (5, 128)
    (320 rows) and (8, 192) (512 rows), a few elements."""
    rng = np.random.default_rng(nD * 1000 + C)
    panels, cols, n_J = _seeded(rng, nD, C)
    _hold(panels, cols, n_J, _ref_ops(panels, cols, n_J), rng)


@pytest.mark.parametrize("p,nD,C", [(7, 4, 13), (3, 11, 14), (64, 13, 10)])
def test_rows_order_at_ragged_shapes(p, nD, C):
    """The P2 element at an odd C, wide phase-I rows, 832 rows of 10."""
    rng = np.random.default_rng(p + nD + C)
    panels, cols, n_J = _seeded(rng, nD, C, N=5, p=p, n_J=60)
    _hold(panels, cols, n_J, _ref_ops(panels, cols, n_J), rng)


@pytest.mark.parametrize("p,nD,C,N", [(64, 5, 128, 2), (7, 4, 13, 5),
                                      (3, 11, 14, 4), (1, 1, 3, 2)])
def test_rows_order_bitwise_to_numpy(p, nD, C, N):
    """The same fold written out in numpy, k outer, q inner, from 0.0:
    the same bits, signed zeros, a NaN and an infinity included."""
    rng = np.random.default_rng(p * 100 + nD * 10 + C)
    panels = rng.standard_normal((nD, N, p, C))
    Y = rng.standard_normal((N * p, nD))
    panels[0, 0, 0, 0] = -0.0
    Y[0, :] = -0.0
    panels[nD - 1, N - 1, p - 1, C - 1] = np.nan
    panels[0, N - 1, 0, 0] = np.inf
    acc = np.zeros((N, C))
    y = Y.reshape(N, p, nD)
    for k in range(nD):
        for q in range(p):
            acc = acc + panels[k, :, q, :] * y[:, q, k, None]
    got = panel_adj_contrib_rows_plain(torch.as_tensor(panels),
                                       torch.as_tensor(Y)).numpy()
    assert np.array_equal(got.view(np.int64), acc.reshape(-1).view(np.int64))


def test_rows_order_is_its_own():
    """At the fem3d main shape the rows order is not the einsum's bits (so
    the card tests' bitwise checks hold the order, not only the sums), nor
    the spread form's split order."""
    rng = np.random.default_rng(5)
    P = torch.as_tensor(rng.standard_normal((5, 4, 64, 128)))
    Y = torch.as_tensor(rng.standard_normal((4 * 64, 5)))
    rows = panel_adj_contrib_rows_plain(P, Y)
    assert not torch.equal(rows, PA.panel_adj_contrib_plain(P, Y))
    assert not torch.equal(rows, PA.panel_adj_contrib_split_plain(P, Y))


@pytest.mark.parametrize("L", [2, 3])
def test_stored_fem3d_level_shapes(L):
    """``FEM3D_K3_C`` at L = 2 and 3: the port's own levels of both
    systems (coarsest .. top), built here."""
    prob = mt.assemble(mt.amg(mt.subdivide(mt.fem3d(k=3), L)), p=1.0,
                       device="cpu")
    got = [tuple(build_panel_ops(M.D_fine, M.nu, R, 64, "cpu").panels.shape)
           for M in prob.M[:2] for R in M.R_fine]
    assert got == fem3d_k3_shapes(L)


# problem -> (its level shapes (nD, N, p, C), those that take the bulk form)
P2_L5 = [(4, 512, 7, c) for c in (4, 9, 12, 12, 6, 14)] + \
    [(7, 512, 7, c) for c in (6, 14, 18, 18, 9, 21)]
SPECTRAL2D_N32 = [(4, 1, 1024, c) for c in (4, 20, 100, 452, 1924)] + \
    [(7, 1, 1024, c) for c in (8, 36, 164, 708, 2948)]
LEVELS = {
    "fem2d_P2 L=5": (P2_L5, []),
    "fem3d L=2": (fem3d_k3_shapes(2), [(5, 8, 64, 2), (5, 8, 64, 4)]),
    "fem3d L=3": (fem3d_k3_shapes(3), [(5, 64, 64, c) for c in
                                       (2, 24, 72, 128)]
                  + [(8, 64, 64, c) for c in (40, 80, 192)]),
    "fem3d L=4": (fem3d_k3_shapes(4), [(5, 512, 64, c) for c in
                                       (46, 32, 16, 128)]
                  + [(8, 512, 64, c) for c in (4, 48, 24, 192)]),
    "fem3d L=5": (fem3d_k3_shapes(5), [(5, 4096, 64, c) for c in
                                       (12, 68, 32, 16, 128)]
                  + [(8, 4096, 64, c) for c in (4, 20, 48, 24, 192)]),
    "spectral2d n=32": (SPECTRAL2D_N32, []),
}


@pytest.mark.parametrize("problem", list(LEVELS))
def test_bulk_form_by_level(problem):
    shapes, bulk = LEVELS[problem]
    assert [s for s in shapes if PA.bulk_form_takes(*s)] == bulk


@pytest.mark.parametrize("shape", [
    (5, 512, 64, 91), (8, 4096, 64, 111), (5, 4096, 64, 65),  # odd C
    (5, 512, 64, 514),          # past ADJ_BULK_MAX_C
    (65, 512, 64, 128),         # p*nD past the staged Y
    (5, 7, 64, 62),             # fewer elements than ADJ_BULK_MIN_N
    (3, 512, 64, 128),          # fewer rows than ADJ_BULK_MIN_ROWS
    (4, 512, 7, 14),            # ... the P2 element's 28
    (5, 4, 64, 128)])           # a spread level
def test_bulk_form_refuses(shape):
    assert not PA.bulk_form_takes(*shape)
