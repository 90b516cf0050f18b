"""PyTorch port, level operators: at the fem2d_P2 L=3 levels, the port's
apply_G / apply_Gt / gram_matvec / gram_diag / gram_element_blocks /
assemble_dense match the JAX x64 operators to 1e-13 relative on identical
(seeded) inputs. On the CPU the kernel wrappers run their plain versions,
so their launch counters stay 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch.kernels as K
from mgbtpu.solver import levelops as LJ
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.solver import levelops as LT

torch.set_num_threads(1)
TOL = 1e-13
_OPS = {}


def _ops(l):
    if not _OPS:
        M = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 3)),
                            p=1.0).M[0]
        for j in range(M.depth):
            oj = LJ.build_panel_ops(M.D_fine, M.nu, M.R_fine[j], 7, np.float64)
            ot = from_reference_arrays(device="cpu", panel_ops=dict(
                cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
                n_J=oj.n_J))["panel_ops"]
            _OPS[j] = (oj, ot)
    return _OPS[l]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _node_factors(rng, m, nD):
    L = np.tril(rng.standard_normal((m, nD, nD)))
    L[:, np.arange(nD), np.arange(nD)] = np.abs(L[:, np.arange(nD),
                                                  np.arange(nD)]) + 0.5
    return L


LEVELS = [1, 2, 3, 4]


@pytest.mark.parametrize("l", LEVELS)
def test_forward_and_adjoint(l):
    oj, ot = _ops(l)
    rng = np.random.default_rng(10 + l)
    K.reset_launches()
    s = rng.standard_normal(oj.n_J)
    dz0 = rng.standard_normal((oj.n_nodes, oj.nD))
    ref = np.asarray(oj.apply_G(jnp.asarray(s)))
    assert _rel(ot.apply_G(torch.tensor(s)).numpy(), ref) <= TOL
    # with the Dz0 add fused (barrier._Dz of the reference)
    assert _rel(ot.apply_G(torch.tensor(s), torch.tensor(dz0)).numpy(),
                dz0 + ref) <= TOL
    Y = rng.standard_normal((oj.n_nodes, oj.nD))
    assert _rel(ot.apply_Gt(torch.tensor(Y)).numpy(),
                np.asarray(oj.apply_Gt(jnp.asarray(Y)))) <= TOL
    assert all(c == 0 for c in K.launches().values())


@pytest.mark.parametrize("l", LEVELS)
def test_gram_operators(l):
    oj, ot = _ops(l)
    rng = np.random.default_rng(20 + l)
    K.reset_launches()
    Ln = _node_factors(rng, oj.n_nodes, oj.nD)
    v = rng.standard_normal(oj.n_J)
    dinv = rng.uniform(0.5, 2.0, oj.n_J)
    Lj, Lt = jnp.asarray(Ln), torch.tensor(Ln)
    assert _rel(LT.gram_matvec(ot, Lt, torch.tensor(v)).numpy(),
                np.asarray(LJ.gram_matvec(oj, Lj, jnp.asarray(v)))) <= TOL
    assert _rel(LT.gram_diag(ot, Lt).numpy(),
                np.asarray(LJ.gram_diag(oj, Lj))) <= TOL
    assert _rel(LT.gram_element_blocks(ot, Lt, torch.tensor(dinv)).numpy(),
                np.asarray(LJ.gram_element_blocks(oj, Lj,
                                                  jnp.asarray(dinv)))) <= TOL
    assert _rel(ot.gram_dense((Lt,)).numpy(),
                np.asarray(oj.assemble_gram(Lj))) <= TOL
    assert all(c == 0 for c in K.launches().values())


@pytest.mark.parametrize("l", LEVELS)
def test_assemble_dense(l):
    oj, ot = _ops(l)
    rng = np.random.default_rng(30 + l)
    B = rng.standard_normal((oj.n_nodes, oj.nD, oj.nD))
    Y = B @ np.swapaxes(B, 1, 2)
    assert _rel(ot.assemble_dense(torch.tensor(Y)).numpy(),
                np.asarray(oj.assemble_dense(jnp.asarray(Y)))) <= TOL
