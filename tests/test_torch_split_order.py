"""PyTorch port, the sum orders of K1's and K3's spread forms on the CPU.

On the card, K1 ``panel_fwd`` and K3's phase A take their spread forms at
levels of few elements with many rows (the spectral levels). There each
sum runs in a split order of its own: K1 a row's columns over 32 lanes
(lane l the column pairs l, l + 32, ...) joined by a fixed pairwise tree,
K3 a slot's rows in slabs (``split_slab``: 128 rows, 32 in an element
of at most 2,048) folded apart, then the slabs in order.
``panel_fwd_split_plain`` and ``panel_adj_contrib_split_plain`` compute
those orders in plain PyTorch; the card tests hold the kernels to their
bits (``tests/test_torch_kernels_cuda.py``). Here, on seeded inputs:

- the split plain versions follow a scalar transcription of the kernels'
  loops bit for bit (odd C, a ragged last slab, two elements);
- they agree with the einsum plain versions (what the CPU runs) to 1e-13
  relative to the largest entry at spectral2d n = 32's top level (4, 1,
  1,024, 1,924), its parabolic phase-I rows (9, 1, 1,024, 3,972: p*nD =
  9,216), and two elements of 1,024 rows;
- with the scatter, they give JAX x64's ``PanelOps.apply_G`` and
  ``apply_Gt`` to 1e-13 relative at the top levels of spectral1d n = 128
  and spectral2d n = 16, main and phase-I systems;
- a NaN panel entry gives NaN in exactly its row (K1) or its slot (K3);
- their constants are the CUDA sources' own.
"""
import functools
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch.kernels as K
from mgbtpu.solver import levelops as LJ
from mgbtpu_torch.interop import from_reference_arrays

# the wrapper modules (the package's names panel_fwd, panel_adj are the
# wrapper functions)
KF = importlib.import_module("mgbtpu_torch.kernels.panel_fwd")
KA = importlib.import_module("mgbtpu_torch.kernels.panel_adj")

torch.set_num_threads(1)
TOL = 1e-13
CSRC = os.path.join(os.path.dirname(K.__file__), "csrc")


@functools.lru_cache(maxsize=1)
def _inputs(nD, N, p, C):
    """Seeded panels (nD, N, p, C), cols (N, C) over n_J = C + 37 columns,
    s, dz0 and Y, as CPU tensors."""
    rng = np.random.default_rng(nD * 7 + N * 5 + p * 3 + C)
    n_J = C + 37
    cols = np.sort(np.stack([rng.choice(n_J, C, replace=False)
                             for _ in range(N)]), axis=1)
    t = torch.as_tensor
    return (t(rng.standard_normal((nD, N, p, C))), t(cols),
            t(rng.standard_normal(n_J)), t(rng.standard_normal((N * p, nD))),
            t(rng.standard_normal((N * p, nD))))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _fwd_loops(panels, cols, s, dz0):
    """K1's spread form as its loops run: a row a warp, lane l folding the
    pairs j = l, l + 32, ... (columns 2j, 2j + 1 below C), then the shuffle
    tree's offsets 16 .. 1, then dz0 + sum."""
    nD, N, p, C = panels.shape
    P, sv, d = panels.numpy(), s.numpy()[cols.numpy()], dz0.numpy()
    out = np.empty((N * p, nD))
    for e in range(N):
        for q in range(p):
            for k in range(nD):
                lane = [0.0] * 32
                for j in range((C + 1) // 2):
                    for c in (2 * j, 2 * j + 1):
                        if c < C:
                            lane[j % 32] = lane[j % 32] + P[k, e, q, c] \
                                * sv[e, c]
                for o in (16, 8, 4, 2, 1):
                    lane = [lane[i] + lane[i ^ o] for i in range(32)]
                out[e * p + q, k] = d[e * p + q, k] + lane[0]
    return torch.as_tensor(out)


def _adj_loops(panels, Y):
    """K3's spread phase A as its loops run: rows i = k*p + q in slabs of
    ``split_slab(p*nD)`` rows, each slab's fold from 0.0, then the slabs'
    partials in order."""
    nD, N, p, C = panels.shape
    P, y, slab = panels.numpy(), Y.numpy(), KA.split_slab(p * nD)
    out = np.empty((N, C))
    for e in range(N):
        for c in range(C):
            acc = 0.0
            for i0 in range(0, p * nD, slab):
                part = 0.0
                for i in range(i0, min(i0 + slab, p * nD)):
                    k, q = divmod(i, p)
                    part = part + P[k, e, q, c] * y[e * p + q, k]
                acc = acc + part
            out[e, c] = acc
    return torch.as_tensor(out.reshape(-1))


LOOPS = [(3, 2, 50, 70), (1, 1, 300, 9), (2, 2, 33, 129), (9, 1, 240, 5)]


@pytest.mark.parametrize("shape", LOOPS)
def test_split_plain_follows_the_kernel_loops(shape):
    """Odd and even C, a C past one 64-column span, p*nD past one slab
    with a ragged last one (slabs of 32 rows, and of 128 past 2,048 rows),
    two elements: the same bits."""
    panels, cols, s, dz0, Y = _inputs(*shape)
    fwd = K.panel_fwd_split_plain(panels, cols, s, dz0)
    assert torch.equal(fwd.view(torch.int64),
                       _fwd_loops(panels, cols, s, dz0).view(torch.int64))
    adj = K.panel_adj_contrib_split_plain(panels, Y)
    assert torch.equal(adj.view(torch.int64),
                       _adj_loops(panels, Y).view(torch.int64))


# spectral2d n = 32's top level, its parabolic phase-I rows (p*nD =
# 9,216), and two elements of 1,024 rows (with 9,216 rows each, too)
SHAPES = [(4, 1, 1024, 1924), (9, 1, 1024, 3972), (1, 2, 1024, 77),
          (9, 2, 1024, 301)]


@pytest.mark.parametrize("shape", SHAPES)
def test_panel_fwd_split_plain_matches_einsum(shape):
    panels, cols, s, dz0, _ = _inputs(*shape)
    for d in (None, dz0):
        got = K.panel_fwd_split_plain(panels, cols, s, d)
        assert _rel(got, K.panel_fwd_plain(panels, cols, s, d)) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_panel_adj_split_plain_matches_einsum(shape):
    panels, _, _, _, Y = _inputs(*shape)
    got = K.panel_adj_contrib_split_plain(panels, Y)
    assert _rel(got, KA.panel_adj_contrib_plain(panels, Y)) <= TOL


@pytest.mark.parametrize("kind,n", [("spectral1d", 128), ("spectral2d", 16)])
def test_split_plain_matches_jax(kind, n):
    """At the top level of both prepared systems (main and phase I), the
    split plain versions (K3's with its scatter) against JAX x64's
    ``apply_G`` (+ Dz0) and ``apply_Gt`` on the same seeded inputs."""
    prob = mgbtpu.assemble(mgbtpu.amg(getattr(mgbtpu, kind)(n=n)), p=1.0)
    rng = np.random.default_rng(n + 1)
    assert len(prob.M) == 2
    for M in prob.M:
        l = M.depth - 1
        oj = LJ.build_panel_ops(M.D_fine, M.nu, M.R_fine[l], M.x.shape[0],
                                np.float64)
        ot = from_reference_arrays(device="cpu", panel_ops=dict(
            cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
            n_J=oj.n_J))["panel_ops"]
        assert ot.N == 1 and ot.p * ot.nD >= 384
        s = rng.standard_normal(oj.n_J)
        dz0 = rng.standard_normal((oj.n_nodes, oj.nD))
        ref = dz0 + np.asarray(oj.apply_G(jnp.asarray(s)))
        got = K.panel_fwd_split_plain(ot.panels, ot.cols, torch.tensor(s),
                                      torch.tensor(dz0)).numpy()
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
        Y = rng.standard_normal((oj.n_nodes, oj.nD))
        ref = np.asarray(oj.apply_Gt(jnp.asarray(Y)))
        contrib = K.panel_adj_contrib_split_plain(ot.panels, torch.tensor(Y))
        got = ot.scatter_flat(contrib.reshape(ot.N, ot.C)).numpy()
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_panel_fwd_split_plain_nan_row():
    panels, cols, s, dz0, _ = _inputs(4, 2, 25, 70)
    panels = panels.clone()
    panels[2, 1, 7, 66] = float("nan")
    out = K.panel_fwd_split_plain(panels, cols, s, dz0)
    nan = torch.isnan(out)
    assert nan[25 + 7, 2] and int(nan.sum()) == 1


def test_panel_adj_split_plain_nan_slot():
    panels, _, _, _, Y = _inputs(4, 2, 25, 70)
    panels = panels.clone()
    panels[3, 1, 24, 5] = float("nan")
    out = K.panel_adj_contrib_split_plain(panels, Y)
    nan = torch.isnan(out)
    assert nan[70 + 5] and int(nan.sum()) == 1


def _define(path, name):
    text = open(os.path.join(CSRC, path)).read()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def test_split_constants_are_the_sources():
    assert KF.SPLIT_LANES == _define("panel_fwd.cu", "SPLIT_LANES")
    assert KF.SPLIT_VEC == _define("panel_fwd.cu", "SPLIT_VEC")
    assert KA.SPLIT_SLAB == _define("adjoint.cuh", "ADJ_SPLIT_SLAB")
    assert KA.SPLIT_SLAB_SMALL == _define("adjoint.cuh",
                                          "ADJ_SPLIT_SLAB_SMALL")
    assert KA.SPLIT_SMALL == _define("adjoint.cuh", "ADJ_SPLIT_SMALL")
