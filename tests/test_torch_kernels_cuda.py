"""PyTorch port, the seven CUDA kernels against their plain PyTorch versions
on the card, at small ragged shapes and in every mode the wrappers take,
K1 and K4 at the fem3d Q3 shapes that take their wide forms, K5a and K5b
at every level of the fem3d L=4 and L=5 plans, which take their large
forms (1e-12 relative: they sum in other orders and over up to 2,210
products), and K1 and K3 at the one-element spectral shapes that take
their spread forms.

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
import sys

import numpy as np
import pytest
import torch

import mgbtpu_torch as mt
import mgbtpu_torch.kernels as K
from chip_smoke import FEM3D_L4, FEM3D_L5
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


STAGED, WIDE, SPREAD = 1, 2, 3   # the C entries' forced forms


def _in_form(kernel, form, *args):
    """``kernel(*args)`` with its C entry forced to ``form`` (STAGED: the
    element- or panel-staged form; WIDE: the wide form; SPREAD: K1's and
    K3's spread form) through the wrapper module's private ``_FORM``."""
    mod = sys.modules[kernel.__module__]
    mod._FORM = form
    try:
        return kernel(*args)
    finally:
        mod._FORM = 0


def _same_bits(a, b):
    return a.shape == b.shape and bool((a.view(torch.int64)
                                        == b.view(torch.int64)).all())


# (nD, C) at p = 64, the fem3d Q3 element: the main system's top level
# (5, 128) and the phase-I system's (8, 192), which one element's slabs
# cannot hold in shared memory together (the wide forms); and at nD = 5
# the last C each element-staged form takes and the first it does not:
# K1's element-group form holds 5 slabs of 64 x C and C gathered values
# up to C = 90, K4's fused form its panels, factors and work up to C = 82
FEM3D = [(5, 128), (8, 192)]
K1_EDGE = [(5, 90), (5, 91)]
K4_EDGE = [(5, 82), (5, 83)]


@pytest.mark.parametrize("nD,C", FEM3D + K1_EDGE)
def test_panel_fwd_fem3d_shapes(dev, nD, C):
    """K1 at the Q3 element's p = 64 against its plain version, by shape
    (one count a call, repeat calls bitwise); where the element-group form
    takes the shape, the wide form gives its bits, and where it does not,
    it refuses the launch."""
    rng = np.random.default_rng(nD * 1000 + C)
    panels, cols, _, n_J = _panels(rng, dev, nD=nD, N=9, p=64, C=C, n_J=700)
    N, p = panels.shape[1], panels.shape[2]
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_fwd.launches
    out = K.panel_fwd(panels, cols, s, dz0)
    assert _rel(out, K.panel_fwd_plain(panels, cols, s, dz0)) <= TOL
    assert _same_bits(out, K.panel_fwd(panels, cols, s, dz0))
    assert K.panel_fwd.launches == before + 2
    args = (panels, cols, s, dz0)
    wide = _in_form(K.panel_fwd, WIDE, *args)
    if C <= 90:
        assert _same_bits(wide, _in_form(K.panel_fwd, STAGED, *args))
    else:
        assert _same_bits(wide, out)
        with pytest.raises(RuntimeError, match="panel_fwd launch failed"):
            _in_form(K.panel_fwd, STAGED, *args)


@pytest.mark.parametrize("nD", [33, 65])
def test_panel_fwd_model_rows(dev, nD):
    """K1 at the 16- and 32-field models' rows (nD = 33 and 65) on fem1d's
    2-node elements, past the 12 rows K1 took before, against its plain
    version, Dz0 given, repeat calls bitwise."""
    rng = np.random.default_rng(nD)
    panels, cols, _, n_J = _panels(rng, dev, nD=nD, N=4, p=2, C=6, n_J=40)
    N, p = panels.shape[1], panels.shape[2]
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    out = K.panel_fwd(panels, cols, s, dz0)
    assert _rel(out, K.panel_fwd_plain(panels, cols, s, dz0)) <= TOL
    assert _same_bits(out, K.panel_fwd(panels, cols, s, dz0))


@pytest.mark.parametrize("p,nD,C", [(7, 4, 13), (3, 11, 14), (64, 12, 30)])
def test_panel_fwd_forms_agree(dev, p, nD, C):
    """The wide form gives the element-group form's bits wherever both
    take the shape: the P2 element's, the widest phase-I rows, and
    p*nD = 768 threads, Dz0 absent and given."""
    rng = np.random.default_rng(p * nD + C)
    panels, cols, _, n_J = _panels(rng, dev, nD=nD, N=11, p=p, C=C)
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((11 * p, nD)), device=dev)
    for d in (None, dz0):
        assert _same_bits(_in_form(K.panel_fwd, WIDE, panels, cols, s, d),
                          _in_form(K.panel_fwd, STAGED, panels, cols, s, d))


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


def _gram_inputs(rng, dev, nD, C, N=9, p=64, n_J=700):
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, N=N, p=p, C=C,
                                     n_J=n_J)
    Ln = torch.as_tensor(np.tril(rng.standard_normal((N * p, nD, nD))),
                         device=dev)
    v = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    return panels, cols, inv, Ln, v


@pytest.mark.parametrize("nD,C", FEM3D + K4_EDGE)
def test_gram_matvec_fem3d_shapes(dev, nD, C):
    """K4 at the Q3 element's p = 64 against its plain version, by shape
    (one count a call, repeat calls bitwise); where the fused form takes
    the shape, the wide form gives its bits, and where it does not, it
    refuses the launch."""
    rng = np.random.default_rng(nD * 1000 + C + 1)
    args = _gram_inputs(rng, dev, nD, C)
    before = K.gram_matvec.launches
    out = K.gram_matvec(*args)
    assert _rel(out, K.gram_matvec_plain(*args)) <= TOL
    assert _same_bits(out, K.gram_matvec(*args))
    assert K.gram_matvec.launches == before + 2
    wide = _in_form(K.gram_matvec, WIDE, *args)
    if C <= 82:
        assert _same_bits(wide, _in_form(K.gram_matvec, STAGED, *args))
    else:
        assert _same_bits(wide, out)
        with pytest.raises(RuntimeError, match="gram_matvec launch failed"):
            _in_form(K.gram_matvec, STAGED, *args)


@pytest.mark.parametrize("p,nD,C", [(7, 4, 13), (3, 11, 14), (64, 12, 20),
                                    (64, 13, 10)])
def test_gram_matvec_forms_agree(dev, p, nD, C):
    """The wide form gives the fused form's bits wherever both take the
    shape: the P2 element (the fused form's p = 7 instance), the widest
    phase-I rows, and at p = 64 with nD = 12 and 13 (three and four Pv
    sums a thread, the node factors too large for the wide form's usual
    budget)."""
    rng = np.random.default_rng(p * nD + C + 2)
    args = _gram_inputs(rng, dev, nD, C, N=11, p=p, n_J=101)
    assert _same_bits(_in_form(K.gram_matvec, WIDE, *args),
                      _in_form(K.gram_matvec, STAGED, *args))


# (nD, C) at one element of p = 1,024 nodes (spectral2d n = 32): p*nD =
# 1,024, 4,096 (the top level's 4 rows), 7,168 and 9,216 (parabolic's
# phase-I rows); C = 1,924 (the top level's slots) and an odd 1,001
SPECTRAL = [(nD, C) for nD in (1, 4, 7, 9) for C in (1924, 1001)]


def _spectral_inputs(rng, dev, nD, C, nan=True):
    """One element of 1,024 rows and C slots over n_J = C + 37 columns,
    with one NaN panel entry (``nan``)."""
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, N=1, p=1024, C=C,
                                     n_J=C + 37)
    if nan:
        panels[nD - 1, 0, 517, 3] = float("nan")
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((1024, nD)), device=dev)
    Y = torch.as_tensor(rng.standard_normal((1024, nD)), device=dev)
    return panels, cols, inv, n_J, s, dz0, Y


def _form_of(kernel):
    return sys.modules[kernel.__module__].form


@pytest.mark.parametrize("nD,C", SPECTRAL)
def test_spread_forms_at_spectral_shapes(dev, nD, C):
    """K1 and K3 at one element of 1,024 rows take their spread forms by
    shape and hold to their plain versions (the NaN entry's row or column
    NaN in both, the rest to TOL); one count a call, repeat calls
    bitwise; where the other forms take the shape (K1's wide form up to
    p*nD = 1,024, K3's staged phase A up to 4,096) they give the same bits,
    and where they do not, they refuse the launch."""
    rng = np.random.default_rng(nD * 10000 + C)
    panels, cols, inv, n_J, s, dz0, Y = _spectral_inputs(rng, dev, nD, C)
    assert _form_of(K.panel_fwd)(nD, 1, 1024, C) == SPREAD
    assert _form_of(K.panel_adj)(nD, 1, 1024, C) == SPREAD
    f0, a0 = K.panel_fwd.launches, K.panel_adj.launches
    fwd = K.panel_fwd(panels, cols, s, dz0)
    assert _rel(fwd, K.panel_fwd_plain(panels, cols, s, dz0)) <= TOL
    assert torch.isnan(fwd[517, nD - 1]) and torch.isnan(fwd).sum() == 1
    assert _same_bits(fwd, K.panel_fwd(panels, cols, s, dz0))
    adj = K.panel_adj(panels, cols, inv, Y, n_J)
    assert _rel(adj, K.panel_adj_plain(panels, cols, inv, Y, n_J)) <= TOL
    assert torch.isnan(adj).sum() == 1
    assert _same_bits(adj, K.panel_adj(panels, cols, inv, Y, n_J))
    assert (K.panel_fwd.launches, K.panel_adj.launches) == (f0 + 2, a0 + 2)
    if nD == 1:
        assert _same_bits(fwd, _in_form(K.panel_fwd, WIDE, panels, cols, s,
                                        dz0))
    else:
        with pytest.raises(RuntimeError, match="panel_fwd launch failed"):
            _in_form(K.panel_fwd, WIDE, panels, cols, s, dz0)
    with pytest.raises(RuntimeError, match="panel_fwd launch failed"):
        _in_form(K.panel_fwd, STAGED, panels, cols, s, dz0)
    if nD <= 4:
        assert _same_bits(adj, _in_form(K.panel_adj, STAGED, panels, cols,
                                        inv, Y, n_J))
    else:
        with pytest.raises(RuntimeError, match="panel_adj launch failed"):
            _in_form(K.panel_adj, STAGED, panels, cols, inv, Y, n_J)


@pytest.mark.parametrize("p,nD,C,N", [(7, 4, 13, 37), (3, 11, 14, 37),
                                      (64, 12, 30, 11), (64, 5, 128, 9),
                                      (128, 3, 254, 1), (25, 4, 40, 1),
                                      (1024, 1, 77, 2)])
def test_spread_forms_agree(dev, p, nD, C, N):
    """K1's spread form gives the element-group and the wide forms' bits,
    and K3's spread phase A the staged one's, wherever they take the shape:
    the P2 element, the widest phase-I rows, the Q3 element, spectral1d
    n = 128's top level, spectral2d n = 5's, and two elements of 1,024
    rows; Dz0 absent and given."""
    rng = np.random.default_rng(p * nD + C + N)
    panels, cols, inv, n_J = _panels(rng, dev, nD=nD, N=N, p=p, C=C,
                                     n_J=C + 40)
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    Y = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    fwd_form = _form_of(K.panel_fwd)
    for d in (None, dz0):
        spread = _in_form(K.panel_fwd, SPREAD, panels, cols, s, d)
        for other in (STAGED, WIDE):
            if fwd_form(nD, N, p, C, other):
                assert _same_bits(spread, _in_form(K.panel_fwd, other,
                                                   panels, cols, s, d))
    assert _same_bits(_in_form(K.panel_adj, SPREAD, panels, cols, inv, Y, n_J),
                      _in_form(K.panel_adj, STAGED, panels, cols, inv, Y, n_J))


# (nD, N, p, C) -> K1's and K3's forms, by shape: every fem level the card
# runs keeps its form (K1 element-group 1 or wide 2, K3 staged 1) --
# fem2d_P2 L=5 and L=3 top levels with their phase-I rows, a coarse level
# (C = n_J), fem2d_P1 L=5, fem3d k=3 L=4 and L=3 with phase I, the fem1d
# golden mesh -- and the spectral levels from spectral1d n = 128 and
# spectral2d n = 16 up take the spread forms (3); the golden spectral1d
# n = 5 and spectral2d n = 5 levels are small enough to keep the others
FORMS = [((4, 512, 7, 14), 1, 1), ((9, 512, 7, 14), 1, 1),
         ((11, 32, 7, 14), 1, 1), ((4, 512, 7, 4), 1, 1),
         ((4, 512, 3, 6), 1, 1), ((5, 512, 64, 128), 2, 1),
         ((8, 512, 64, 192), 2, 1), ((5, 64, 64, 128), 2, 1),
         ((8, 64, 64, 192), 2, 1), ((3, 2, 2, 3), 1, 1),
         ((4, 1, 1024, 1924), 3, 3), ((9, 1, 1024, 3000), 3, 3),
         ((3, 1, 128, 254), 3, 3), ((4, 1, 256, 452), 3, 3),
         ((3, 1, 5, 8), 1, 1), ((4, 1, 25, 34), 1, 1)]


@pytest.mark.parametrize("shape,k1,k3", FORMS)
def test_forms_by_shape(dev, shape, k1, k3):
    assert _form_of(K.panel_fwd)(*shape) == k1
    assert _form_of(K.panel_adj)(*shape) == k3


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


def _wide_tables(m, rng, table, room):
    """Tables past K6's first limits (4 pieces, 12 rows, cones nz <= 5,
    linear 4 x 5): (Convex, D rows) of ``table``. The cobarrier form adds a
    row and the phase-I form 1 + 3 (six pieces: 14; sixteen pieces: 32, the
    kernel's widest). The widest cone and linear block fill the ``room``
    rows the form leaves of the 32: a cone of nz = 32 (31 in the
    cobarrier form, 28 in phase I) and a block of 32 x 32 (32 x 31,
    32 x 28). The mixed table puts pieces the register kernels take (cones
    of nz = 2 and 3, linear<1, 1>, linear<2, 1> and a runtime-width
    3 x 2 block) beside an nz = 7 cone, so each of them runs in its wide
    instance."""
    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear

    def rand_A(n):
        return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
            + 0.01 * rng.standard_normal((m, n * n))

    six = (cone(x=x, idx=(1, 2, 9), p=1.0), cone(x=x, idx=(3, 8), p=2.0),
           cone(x=x, idx=(4, 5, 6, 9), A_grid=rand_A(4), p=1.5),
           lin(x=x, idx=(0,), A=lambda _: np.array([[1.0], [-1.0]]),
               b=lambda _: np.array([2.0, 2.0])),
           lin(x=x, idx=(0, 7), A_grid=rng.standard_normal((m, 6)),
               b_grid=rng.uniform(2.0, 4.0, (m, 3))),
           lin(x=x, idx=(7,), A=lambda _: np.array([[1.0]]),
               b=lambda _: np.array([3.0])))
    sixteen = [lin(x=x, idx=(k, (k + 5) % 27),
                   A_grid=rng.standard_normal((m, 2)),
                   b_grid=rng.uniform(2.0, 4.0, (m, 1))) if k % 2 else
               cone(x=x, idx=(k, k + 1, 27), p=(1.0, 2.0, 1.5)[k % 3])
               for k in range(16)]
    if table == "cone_widest":
        return cone(x=x, idx=tuple(range(room)), A_grid=rand_A(room),
                    p=1.5), room
    if table == "linear_widest":
        return lin(x=x, idx=tuple(range(room))[::-1],
                   A_grid=rng.standard_normal((m, 32 * room)),
                   b_grid=rng.uniform(6.0, 9.0, (m, 32))), room
    if table == "mixed":
        mixed = (cone(x=x, idx=(0, 1, 11), p=1.0),
                 lin(x=x, idx=(2,), A=lambda _: np.array([[1.0]]),
                     b=lambda _: np.array([3.0])),
                 lin(x=x, idx=(3,), A=lambda _: np.array([[1.0], [-1.0]]),
                     b=lambda _: np.array([2.0, 2.0])),
                 cone(x=x, idx=(4, 10), p=2.0),
                 lin(x=x, idx=(1, 2), A_grid=rng.standard_normal((m, 6)),
                     b_grid=rng.uniform(2.0, 4.0, (m, 3))),
                 cone(x=x, idx=(5, 6, 7, 8, 9, 0, 10), A_grid=rand_A(7),
                      p=1.5))
        sel = (rng.uniform(size=(m, 6)) < 0.8).astype(float)
        return mt.convex_piecewise(mixed, select_grid=sel, x=x), 12
    return {
        "six_pieces": (mt.convex_piecewise(
            six, select_grid=(rng.uniform(size=(m, 6)) < 0.8).astype(float),
            x=x), 10),
        "cone_nz7_p15": (cone(x=x, idx=(0, 1, 2, 3, 4, 5, 8),
                              A_grid=rand_A(7), p=1.5), 9),
        "cone_nz7_p1": (cone(x=x, idx=(2, 1, 0, 4, 5, 6, 3), p=1.0), 7),
        "cone_nz9_p2": (cone(x=x, idx=(8, 0, 1, 2, 3, 4, 5, 6, 7),
                             A_grid=rand_A(9), p=2.0), 9),
        "wide_linear": (lin(x=x, idx=(0, 1, 2, 3, 4, 5, 6),
                            A_grid=rng.standard_normal((m, 42)),
                            b_grid=rng.uniform(6.0, 9.0, (m, 6))), 8),
        "sixteen_pieces": (mt.intersect(x, *sixteen), 28),
    }[table]


WIDE_TABLES = ["six_pieces", "cone_nz7_p15", "cone_nz7_p1", "cone_nz9_p2",
        "wide_linear", "sixteen_pieces", "cone_widest", "linear_widest",
        "mixed"]
ROOM = {"barrier": 32, "cobarrier": 31, "phase_one": 28}


@pytest.mark.parametrize("form", ["barrier", "cobarrier", "phase_one"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("table", WIDE_TABLES)
def test_node_barrier_wide_tables(dev, table, mode, form):
    """K6's wide tables (more than 4 pieces, up to 32 rows, the
    runtime-width cone, the wide linear block, narrow pieces in their wide
    instances) in every mode and form, with infeasible and masked nodes,
    bitwise equal to the plain version; 3,001 nodes (blocks of 32, or
    fewer where a block's rows pass 48 KB: the widest cone and block run
    their Hessians at 8 nodes a block, where 16 would pass the opt-in
    227 KB, and their other modes at 16)."""
    from mgbtpu_torch.kernels.node_barrier import instance, last_block

    rng = np.random.default_rng(900 + WIDE_TABLES.index(table))
    m = 3001
    Q, nD = _wide_tables(m, rng, table, ROOM[form])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    Dz[:, s_rows] = rng.uniform(2.0, 4.0, (m, len(s_rows)))
    Dz[:60] *= rng.choice([-6.0, 6.0], (60, nD))        # infeasible nodes
    if form == "phase_one":
        call = _phase_one_call(mode, Q, Dz, rng, t)
    else:
        y, co = Dz, None
        if form == "cobarrier":
            y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (m, 1))], axis=1)
            co = nD + 1
        bw = np.full(m, 1.0 / m)
        bw[10:20] = 0.0
        args = tuple(t(a) for a in Q.args)
        call = (mode, t(y), Q.pieces, args, args[0] if Q.select else None,
                t(bw), t(rng.standard_normal(y.shape)), co, None)
    before = K.node_barrier.launches
    out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
    assert _rel(out, ref) <= TOL
    assert _same_bits(out, ref)
    assert _same_bits(out, K.node_barrier(*call))
    assert K.node_barrier.launches == before + 2
    inst = instance(Q.pieces, mode, call[1].shape[1], call[7],
                    call[8] is not None)
    if table == "mixed":
        assert inst.wide and len(set(inst.codes)) == 4
    if table in ("cone_widest", "linear_widest"):
        assert call[1].shape[1] == 32
        assert last_block() == (8 if mode == 2 else 16)


def _table_tables(m, rng, table):
    """Tables past the parameter kernels (16 pieces, 32 rows, widths 32):
    (Convex, D rows). 17 pieces (cones of nz 2 and 3 and linear blocks,
    with a select grid) over 20 rows; the 16-field model's cone (nz = 17
    over 33 rows, a full A); the 32-field model's (nz = 33 over 65 rows,
    its Hessian's rows too wide for shared memory: built in global
    memory); a linear block of 40 x 34 with repeated rows beside a narrow
    cone, over 36 rows."""
    x = np.zeros((m, 2))
    cone, lin = mt.convex_euclidian_power, mt.convex_linear

    def rand_A(n):
        return np.tile(np.eye(n).reshape(1, -1), (m, 1)) \
            + 0.01 * rng.standard_normal((m, n * n))

    if table == "seventeen_pieces":
        pieces = [cone(x=x, idx=(k, k + 1, 19), p=(1.0, 2.0, 1.5)[k % 3])
                  if k % 2 == 0 else
                  lin(x=x, idx=(k, (k + 4) % 18),
                      A_grid=rng.standard_normal((m, 2)),
                      b_grid=rng.uniform(2.0, 4.0, (m, 1)))
                  for k in range(16)]
        pieces.append(cone(x=x, idx=(18, 19), p=2.0))
        sel = (rng.uniform(size=(m, 17)) < 0.8).astype(float)
        return mt.convex_piecewise(tuple(pieces), select_grid=sel, x=x), 20
    if table == "cone_nz17":
        return cone(x=x, idx=tuple(range(1, 32, 2)) + (32,),
                    A_grid=rand_A(17), p=2.0), 33
    if table == "cone_nz33":
        return cone(x=x, idx=tuple(range(1, 64, 2)) + (64,), p=2.0), 65
    wide = lin(x=x, idx=tuple(range(33)) + (5,),
               A_grid=rng.standard_normal((m, 40 * 34)),
               b_grid=rng.uniform(30.0, 40.0, (m, 40)))
    return mt.intersect(x, wide, cone(x=x, idx=(33, 34, 35), p=1.0)), 36


TABLE_KERNEL = ["seventeen_pieces", "cone_nz17", "cone_nz33",
                "linear_40x34"]


@pytest.mark.parametrize("form", ["barrier", "cobarrier", "phase_one"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("table", TABLE_KERNEL)
def test_node_barrier_table_kernels(dev, table, mode, form):
    """The table kernels (a table past 16 pieces, 32 rows or a width of
    32, read from a device buffer) in every mode and form, with infeasible
    and masked nodes, bitwise equal to the plain version and to a repeat
    call; the nz = 33 cone's Hessian builds its rows in global memory."""
    from mgbtpu_torch.kernels.node_barrier import instance, last_in_global

    rng = np.random.default_rng(950 + TABLE_KERNEL.index(table))
    m = 1001
    Q, nD = _table_tables(m, rng, table)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    s_rows = sorted({pc.idx[-1] for pc in Q.pieces if pc.kind == POWER})
    Dz[:, s_rows] = rng.uniform(2.0, 4.0, (m, len(s_rows)))
    Dz[:20] *= rng.choice([-6.0, 6.0], (20, nD))        # infeasible nodes
    if form == "phase_one":
        call = _phase_one_call(mode, Q, Dz, rng, t)
    else:
        y, co = Dz, None
        if form == "cobarrier":
            y = np.concatenate([Dz, rng.uniform(-0.5, 0.5, (m, 1))], axis=1)
            co = nD + 1
        bw = np.full(m, 1.0 / m)
        bw[10:20] = 0.0
        args = tuple(t(a) for a in Q.args)
        call = (mode, t(y), Q.pieces, args, args[0] if Q.select else None,
                t(bw), t(rng.standard_normal(y.shape)), co, None)
    inst = instance(Q.pieces, mode, call[1].shape[1], call[7],
                    call[8] is not None)
    assert inst.table
    before = K.node_barrier.table_launches
    out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
    assert _rel(out, ref) <= TOL
    assert _same_bits(out, ref)
    assert _same_bits(out, K.node_barrier(*call))
    assert K.node_barrier.table_launches == before + 2
    if table == "cone_nz33" and mode == 2:
        assert last_in_global()


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("order", ["linear_first", "cone_first"])
def test_node_barrier_signed_zero_fold_wide(dev, order, mode):
    """test_node_barrier_signed_zero_fold on the wide instances: a wide
    linear block (nc = 5) whose A rows hold -1 and 0 gives -0.0 at its
    gradient entry 1 and Hessian entries (0, 1), (1, 0); a runtime-width
    cone (nz = 6) on rows 2..7 leaves them alone. Phase-I form, wc = -0.0,
    bitwise equal to the plain version."""
    rng = np.random.default_rng(77 + mode)
    m, nD = 200, 8
    x = np.zeros((m, 2))
    A = np.zeros((5, 2))
    A[:, 0] = -1.0
    lin = mt.convex_linear(x=x, idx=(0, 1), A=lambda _: A,
                           b=lambda _: np.full(5, 5.0))
    cone = mt.convex_euclidian_power(x=x, idx=(2, 3, 4, 5, 6, 7), p=2.0)
    pieces = (lin, cone) if order == "linear_first" else (cone, lin)
    sel = np.ones((m, 2))
    sel[::7, 0] = 0.0
    sel[::5, 1] = 0.0
    Q = mt.convex_piecewise(pieces, select_grid=sel, x=x)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    Dz = rng.uniform(-0.3, 0.3, (m, nD))
    Dz[:, 7] = rng.uniform(2.0, 3.0, m)
    call = _phase_one_call(mode, Q, Dz, rng, t, wc=np.full((m, nD + 4), -0.0))
    out, ref = K.node_barrier(*call), K.node_barrier_plain(*call)
    assert _same_bits(out, ref)


def test_node_barrier_has_no_local_memory(dev):
    """ptxas (-v, the committed flags) reports 0 bytes of stack and no
    spills for every function of node_barrier.cu: K6's 27 kernels, one per
    (mode, form) with register instances, one with runtime-width ones
    (which keep their vectors in shared memory, not in local memory) and
    one reading its table from a device buffer, and any callee that was
    not inlined."""
    from mgbtpu_torch.kernels import _build

    _build.build_all(("node_barrier",), force=True)
    _, info = _build.PTXAS["node_barrier"]
    assert sum("node_barrier_kernel" in k for k in info) == 9
    assert sum("node_barrier_wide_kernel" in k for k in info) == 9
    assert sum("node_barrier_table_kernel" in k for k in info) == 9
    for name, r in info.items():
        assert (r["stack"], r["spill_stores"], r["spill_loads"]) == (0, 0, 0), \
            (name, r)


def test_node_barrier_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(5)
    m = 16
    Q, nD = _tables(m, rng)["rof"]
    args = tuple(torch.as_tensor(a, device=dev) for a in Q.args)
    y = torch.zeros((m, 2), dtype=torch.float64, device=dev)
    ones = torch.ones(m, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="idx"):
        K.node_barrier(0, y, Q.pieces, args, args[0], ones, y)
    y = torch.zeros((m, nD), dtype=torch.float64, device=dev)
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


# (nk, amax, bmax): the seven tree levels of the fem3d Q3 L=4 plan, leaf
# (f = 855, past the one-panel form's 790) to root, nk cut to 4 (the
# shapes matter, not the batch); a front at the one-panel form's last f
# and one past it; f = 2,400, as wide as the L=5 plan's fronts
FEM3D_FRONTS = [(4, 637, 218), (4, 55, 403), (4, 25, 313), (4, 121, 397),
                (4, 121, 529), (2, 253, 529), (1, 529, 0), (2, 700, 90),
                (2, 700, 91), (2, 1600, 800)]
ONE_BLOCK = 1                                   # K5a's and K5b's forms
LARGE = 2


@pytest.mark.parametrize("nk,a,b", FEM3D_FRONTS)
def test_front_factor_wide_fronts(dev, nk, a, b):
    """K5a on the fem3d fronts (the large form, by shape) against its plain
    version (1e-12 relative: at f = 2,400 each entry sums up to 2,400
    products), front 1 not positive definite where there is one (all NaN),
    repeat calls bitwise; the one-panel form agrees with it (1e-12: they
    sum in other orders) where it takes the front, and refuses the
    others."""
    rng = np.random.default_rng(a * 7 + b)
    F = _fronts(rng, nk, a, b)
    if nk > 1:
        F[1, a - 3, a - 3] = -1e3                 # in the last panel
    F = torch.as_tensor(F, device=dev)
    outs = K.front_factor(F, a, b)
    for out, ref in zip(outs, K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= 1e-12
        if nk > 1:
            assert torch.isnan(out[1]).all()
    for out, again in zip(outs, K.front_factor(F, a, b)):
        assert _same_bits(out, again)
    if a + b <= 790:
        for x, y in zip(outs, _in_form(K.front_factor, STAGED, F, a, b)):
            assert _rel(x, y) <= 1e-12
    else:
        with pytest.raises(RuntimeError, match="front_factor launch failed"):
            _in_form(K.front_factor, STAGED, F, a, b)


@pytest.mark.parametrize("nk,a,b", [(64, 73, 16), (3, 33, 20), (5, 40, 0),
                                    (4, 91, 190)])
def test_front_factor_forms_agree(dev, nk, a, b):
    """The large form, forced, agrees with the one-panel form that takes
    the fem2d_P2 fronts by shape (1e-12: they sum in other orders), a bad
    front in the batch all NaN in both."""
    rng = np.random.default_rng(a + 2 * b)
    F = _fronts(rng, nk, a, b)
    F[nk // 2, a // 2, a // 2] = -1e3
    F = torch.as_tensor(F, device=dev)
    for x, y in zip(_in_form(K.front_factor, LARGE, F, a, b),
                    _in_form(K.front_factor, STAGED, F, a, b)):
        assert _rel(x, y) <= 1e-12
        assert torch.isnan(x[nk // 2]).all()


# the fem3d k=3 L=4 and L=5 plans' levels (chip_smoke.py, which checks them
# against the plans its solves build), the L=5 leaves and the next two
# levels cut to 64 fronts
LARGE_FRONTS = FEM3D_L4 + [(min(nk, 64), a, b) for nk, a, b in FEM3D_L5]


def _card_fronts(nk, a, b, seed):
    """SPD fronts (nk, f+1, f+1) made on the card (a generator seeded
    there), A slightly asymmetric; the host would take minutes at f =
    2,210."""
    f = a + b
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((nk, f, 2 * f), generator=g, dtype=torch.float64,
                    device="cuda")
    F = torch.zeros((nk, f + 1, f + 1), dtype=torch.float64, device="cuda")
    F[:, :f, :f] = X @ X.mT / f + 0.5 * torch.eye(f, device="cuda")
    F[:, :a, :a] += 1e-14 * torch.randn((nk, a, a), generator=g,
                                        dtype=torch.float64, device="cuda")
    return F


@pytest.mark.parametrize("code", [-1, 3])
def test_front_entries_refuse_other_forms(dev, code):
    """The C entries take form 1 or 2 only (the wrappers pick it by shape,
    ``form_of``): any other code raises, in K5a and in both K5b sweeps,
    and counts no launch."""
    rng = np.random.default_rng(11)
    nk, a, b = 3, 33, 20
    F = torch.as_tensor(_fronts(rng, nk, a, b), device=dev)
    Lf, U, adofs, bdofs, rows, inc, v, y = _sweep(rng, dev, nk, a, b)
    before = (K.front_factor.launches, K.front_solve.launches)
    with pytest.raises(RuntimeError, match="front_factor launch failed"):
        _in_form(K.front_factor, code, F, a, b)
    with pytest.raises(RuntimeError, match="front_solve launch failed"):
        _in_form(K.front_forward, code, Lf, U, adofs, v, rows, inc)
    with pytest.raises(RuntimeError, match="front_solve launch failed"):
        _in_form(K.front_backward, code, Lf, U, adofs, bdofs, y, v)
    assert (K.front_factor.launches, K.front_solve.launches) == before


@pytest.mark.parametrize("nk,a,b", FRONTS + [(8, 31, 159), (4, 63, 127)])
def test_fem2d_fronts_keep_their_forms_and_bits(dev, nk, a, b):
    """On the fem2d fronts the wrappers take the forms they took before
    the large forms existed, with their bits: K5a by shape equals the
    forced one-panel form, K5b the forced one-block form, bitwise, and
    neither counts a large launch."""
    rng = np.random.default_rng(a + 3 * b)
    F = torch.as_tensor(_fronts(rng, nk, a, b), device=dev)
    before = (K.front_factor.large_launches, K.front_solve.large_launches)
    for x, y in zip(K.front_factor(F, a, b),
                    _in_form(K.front_factor, STAGED, F, a, b)):
        assert _same_bits(x, y)
    Lf, U, adofs, bdofs, rows, inc, v, yv = _sweep(rng, dev, nk, a, b)
    w1, w2 = v.clone(), v.clone()
    got = (*K.front_forward(Lf, U, adofs, w1, rows, inc), w1)
    ref = (*_in_form(K.front_forward, ONE_BLOCK, Lf, U, adofs, w2, rows,
                     inc), w2)
    got += (K.front_backward(Lf, U, adofs, bdofs, yv, w1), w1)
    ref += (_in_form(K.front_backward, ONE_BLOCK, Lf, U, adofs, bdofs, yv,
                     w2), w2)
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    assert (K.front_factor.large_launches,
            K.front_solve.large_launches) == before


@pytest.mark.parametrize("nk,a,b", LARGE_FRONTS)
def test_front_factor_large_form(dev, nk, a, b):
    """K5a's large form (by shape) at every level of the fem3d L=4 and L=5
    plans against its plain version, 1e-12 relative; a repeat call gives
    the same bits; one count and one large count a call."""
    F = _card_fronts(nk, a, b, seed=a + b)
    before = (K.front_factor.launches, K.front_factor.large_launches)
    outs = K.front_factor(F, a, b)
    for out, ref in zip(outs, K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= 1e-12
    assert torch.equal(torch.triu(outs[0], 1), torch.zeros_like(outs[0]))
    for out, again in zip(outs, K.front_factor(F, a, b)):
        assert _same_bits(out, again)
    assert (K.front_factor.launches, K.front_factor.large_launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("nk,a,b", [(3, 637, 218), (3, 253, 529),
                                    (3, 1081, 300)])
def test_front_factor_large_form_bad_pivots(dev, nk, a, b):
    """A front whose first pivot that is not > 0 lies in the second
    64-column panel (column 70) and one whose lies in a late panel (column
    a - 3) come back all NaN in Lf, U and S; the other front is finite and
    matches the plain version."""
    F = _card_fronts(nk, a, b, seed=a)
    F[1, 70, 70] = -1e3
    F[2, a - 3, a - 3] = -1e3
    outs = K.front_factor(F, a, b)
    for out, ref in zip(outs, K.front_factor_plain(F, a, b)):
        assert torch.isnan(out[1:]).all()
        assert torch.isfinite(out[0]).all()
        assert _rel(out, ref) <= 1e-12


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


@pytest.mark.parametrize("nk,a,b", [(4, 121, 397), (3, 253, 529),
                                    (1, 529, 100), (1, 300, 200)])
def test_front_factor_large_form_asymmetric_c(dev, nk, a, b):
    """C enters S = C - U U' entry by entry, its upper triangle too: with
    C's upper triangle perturbed by 1e-3 (far past the tolerance) the
    large form (left-looking for several fronts, right-looking for one)
    matches the plain version to 1e-12, and S comes back as asymmetric as
    the plain version's."""
    F = _card_fronts(nk, a, b, seed=7 * a + b)
    g = torch.Generator(device="cuda").manual_seed(b)
    E = torch.randn((nk, b, b), generator=g, dtype=torch.float64,
                    device="cuda")
    F[:, a:a + b, a:a + b] += 1e-3 * torch.triu(E, 1)
    outs = K.front_factor(F, a, b)
    for out, ref in zip(outs, K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= 1e-12
    S = outs[2]
    assert float((S - S.mT).abs().max()) > 1e-5


@pytest.mark.parametrize("col", [70, 526])
def test_front_factor_large_form_one_bad_front(dev, col):
    """A level of one front (the right-looking order) whose first pivot
    that is not > 0 lies in the second panel or the last comes back all
    NaN, as the plain version does."""
    F = _card_fronts(1, 529, 1, seed=col)
    F[0, col, col] = -1e3
    for out, ref in zip(K.front_factor(F, 529, 1),
                        K.front_factor_plain(F, 529, 1)):
        assert torch.isnan(out).all() and torch.isnan(ref).all()


def _card_sweep(rng, dev, nk, a, b, seed):
    """``_sweep``'s level at a large front: Lf the factor of SPD fronts
    made on the card, U seeded there; front 1, where there is one, all
    NaN."""
    Lf = torch.linalg.cholesky(_card_fronts(nk, a, b, seed)[:, :a, :a])
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    U = torch.randn((nk, b, a), generator=g, dtype=torch.float64,
                    device="cuda")
    n_J = nk * a + b + 4
    perm = rng.permutation(n_J)
    adofs = perm[:nk * a].reshape(nk, a)
    adofs[nk // 2, a - 1] = n_J
    bdofs = np.stack([np.sort(rng.choice(perm[nk * a:], b, replace=False))
                      for _ in range(nk)])
    bdofs[0, b - 1] = n_J
    U[0, b - 1] = 0.0
    if nk > 1:
        Lf[1] = U[1] = float("nan")
    rows, inc = boundary_incidence(bdofs, n_J)
    v = np.append(rng.standard_normal(n_J), 0.0)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (Lf.contiguous(), U, t(adofs), t(bdofs), t(rows), t(inc), t(v),
            t(rng.standard_normal((nk, a))))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", LARGE_FRONTS)
def test_front_solve_large_form(dev, nk, a, b, transpose):
    """K5b's large form (by shape) at every level of the fem3d L=4 and L=5
    plans against its plain version, forward (y, upd and the separator-
    updated r) and backward (xA and the written x), 1e-12 relative, the NaN
    front propagating as in the plain version; repeat calls give the same
    bits; one count and one large count a call."""
    rng = np.random.default_rng(a * 5 + b)
    Lf, U, adofs, bdofs, rows, inc, v, y = _card_sweep(rng, dev, nk, a, b,
                                                       seed=a + 2 * b)
    before = (K.front_solve.launches, K.front_solve.large_launches)
    outs = []
    for fwd, bwd in ((K.front_forward, K.front_backward),) * 2 \
            + ((K.front_forward_plain, K.front_backward_plain),):
        w = v.clone()
        if transpose:
            outs.append((bwd(Lf, U, adofs, bdofs, y, w), w))
        else:
            outs.append((*fwd(Lf, U, adofs, w, rows, inc), w))
    assert (K.front_solve.launches, K.front_solve.large_launches) == \
        (before[0] + 2, before[1] + 2)
    for out, again, ref in zip(*outs):
        assert _rel(out, ref) <= 1e-12
        assert _same_bits(out, again)


def test_front_solve_large_form_counter_ring(dev, monkeypatch):
    """K5b's large form takes its counters from a ring kept for the stream
    and zeroes the ring again when it is used up: with a ring of 64
    counters (4 a call at nk = 3) the calls wrap it several times, each
    with the first call's bits."""
    fs = sys.modules[K.front_forward.__module__]
    monkeypatch.setattr(fs, "_RING", 64)
    monkeypatch.setattr(fs, "_RINGS", {})
    rng = np.random.default_rng(17)
    Lf, U, adofs, bdofs, rows, inc, v, y = _card_sweep(rng, dev, 3, 253, 529,
                                                       seed=5)
    outs = []
    for _ in range(40):
        w = v.clone()
        yv, upd = K.front_forward(Lf, U, adofs, w, rows, inc)
        outs.append((yv, upd, w, K.front_backward(Lf, U, adofs, bdofs, y, w),
                     w))
    for got in outs[1:]:
        for x, first in zip(got, outs[0]):
            assert _same_bits(x, first)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    panels, cols, inv, n_J = _panels(rng, dev)
    s = torch.zeros(n_J, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float64"):
        K.panel_fwd(panels, cols, s)
    with pytest.raises(ValueError, match="devices"):
        K.panel_fwd(panels, cols.cpu(), s.double())
    with pytest.raises(RuntimeError, match="panel_fwd launch failed"):
        _in_form(K.panel_fwd, 4, panels, cols, s.double())   # no form 4
    # K3's staged phase A refuses an element whose p*nD values of Y exceed
    # its stage; by shape such an element takes the spread form
    cols = torch.tensor([[0, 1, 2], [0, 1, 2]], device=dev)
    inv = torch.as_tensor(inverse_incidence(cols.cpu().numpy(), 3), device=dev)
    wide = torch.ones((4097, 2, 1, 3), dtype=torch.float64, device=dev)
    Y = torch.ones((2, 4097), dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="panel_adj launch failed"):
        _in_form(K.panel_adj, STAGED, wide, cols, inv, Y, 3)
    assert _same_bits(K.panel_adj(wide, cols, inv, Y, 3),
                      K.panel_adj_plain(wide, cols, inv, Y, 3))
    with pytest.raises(RuntimeError, match="panel_adj launch failed"):
        _in_form(K.panel_adj, WIDE, wide, cols, inv, Y, 3)   # K3 has none


# --- the large-level preconditioners (MGBTPU_BIG_PRE) on the card ----------
# K4 at the shapes of the levels the V-cycle chooses, the BSR apply of the
# composed coarse transfer and the FSAI values, each on the card against
# the same computation on the CPU (library calls and K4's plain version).

PRECOND_LEVELS = [(3, dict(DENSE_MAX=50, DENSE_BASE=40)),
                  (4, dict(DENSE_MAX=50, DENSE_BASE=40)), (4, {}), (5, {})]


def _precond_ctx(L, knobs, device, choice="vcycle"):
    """The top level's operators under ``choice`` for fem2d_P2 p=1 level L
    with ``knobs`` (DENSE_MAX, DENSE_BASE) on ``device``."""
    from mgbtpu_torch.solver import mgb as MT
    from mgbtpu_torch.solver import newton as NT

    old = NT.BIG_PRE, {k: getattr(MT.ProblemKernels, k) for k in knobs}
    NT.BIG_PRE = choice
    for k, v in knobs.items():
        setattr(MT.ProblemKernels, k, v)
    try:
        prob = mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P2(), L)), p=1.0,
                           device=device)
        M1 = prob.M[0]
        kern = MT._kernels_for(M1, prob.Q, None,
                               NT.linesearch_backtracking(),
                               torch.device(device))
        return kern.ops(M1.depth - 1)
    finally:
        NT.BIG_PRE = old[0]
        for k, v in old[1].items():
            setattr(MT.ProblemKernels, k, v)


@pytest.mark.parametrize("L,knobs", PRECOND_LEVELS)
def test_gram_matvec_at_vcycle_levels(dev, L, knobs):
    """K4 on the solve level and every level the V-cycle chooses (the
    smoothing levels and the dense base), against its plain version; a
    repeat call bitwise."""
    ops = _precond_ctx(L, knobs, "cuda")
    ctx = ops.pcg_ctx
    assert ctx is not None and ctx.nd is None
    rng = np.random.default_rng(L)
    for o in (ops,) + tuple(ctx.coarse_ops):
        m = o.N * o.p
        Ln = torch.as_tensor(np.tril(rng.standard_normal((m, o.nD, o.nD))),
                             device=dev)
        v = torch.as_tensor(rng.standard_normal(o.n_J), device=dev)
        args = (o.panels, o.cols, o.inv, Ln, v)
        out = K.gram_matvec(*args)
        assert _rel(out, K.gram_matvec_plain(*args)) <= TOL, o.n_J
        assert _same_bits(out, K.gram_matvec(*args))


@pytest.mark.parametrize("L,knobs", PRECOND_LEVELS)
def test_bsr_coarse_transfer_on_the_card(dev, L, knobs):
    """The composed coarse transfer's BSR products on the card equal the
    CPU's (the tile products' sums in another order: 1e-13); the segment
    sums are fixed-order (a repeat call gives the same bits)."""
    T_dev = _precond_ctx(L, knobs, "cuda").pcg_ctx.coarse_T
    T_cpu = _precond_ctx(L, knobs, "cpu").pcg_ctx.coarse_T
    rng = np.random.default_rng(10 + L)
    x = rng.standard_normal(T_cpu.pattern.n_cols)
    y = rng.standard_normal(T_cpu.pattern.n_rows)
    for f in ("mv", "rmv"):
        a = x if f == "mv" else y
        out = getattr(T_dev, f)(torch.as_tensor(a, device=dev))
        ref = getattr(T_cpu, f)(torch.as_tensor(a))
        assert _rel(out, ref.to(dev)) <= TOL
        assert _same_bits(out, getattr(T_dev, f)(torch.as_tensor(a,
                                                                device=dev)))


@pytest.mark.parametrize("L,knobs", PRECOND_LEVELS)
def test_fsai_values_on_the_card(dev, L, knobs):
    """FSAI's factor tiles and scale on the card against the CPU's from the
    same seeded node factors: the element Gram blocks sum in another order
    on the card, and the jittered k x k Gauss-Jordan solves (condition up
    to ~1e6) carry that into the tiles: 1e-10 relative, the bar the CPU
    tests hold the port's values to against JAX's; the scale 1e-13."""
    from mgbtpu_torch.solver.fsai import fsai_apply, fsai_values

    o_dev = _precond_ctx(L, knobs, "cuda", "fsai2")
    o_cpu = _precond_ctx(L, knobs, "cpu", "fsai2")
    rng = np.random.default_rng(20 + L)
    Ln = np.tril(rng.standard_normal((o_cpu.n_nodes, o_cpu.nD, o_cpu.nD)))
    Ln[:, np.arange(o_cpu.nD), np.arange(o_cpu.nD)] = 1.0 + rng.uniform(
        0, 1, (o_cpu.n_nodes, o_cpu.nD))
    Gd, dd = fsai_values(o_dev.pcg_ctx.fsai, o_dev,
                         (torch.as_tensor(Ln, device=dev),))
    Gc, dc = fsai_values(o_cpu.pcg_ctx.fsai, o_cpu, (torch.as_tensor(Ln),))
    assert _rel(dd, dc.to(dev)) <= TOL
    assert _rel(Gd, Gc.to(dev)) <= 1e-10
    r = rng.standard_normal(o_cpu.n_J)
    out = fsai_apply(o_dev.pcg_ctx.fsai, Gd, torch.as_tensor(r, device=dev))
    ref = fsai_apply(o_cpu.pcg_ctx.fsai, Gc, torch.as_tensor(r))
    assert _rel(out, ref.to(dev)) <= 1e-10
