"""amg(geom) / geometric_mg(geom, L) per discretization.

Host numpy/scipy, a copy of ``mgbtpu/hierarchy/amg_build.py`` for the
tensor-product (fem1d/fem2d/fem3d), fem2d_P1, fem2d_P2 and spectral
(spectral1d/spectral2d) discretizations (the reference's ``amg``:
``src/TensorFEM.jl:727-796``, ``src/fem2d_P1.jl:83-126``,
``src/fem2d_P2.jl:400-455``):

1. corner labels from the cached connectivity t;
2. an auxiliary all-corners Neumann P1/Q1 stiffness (Galerkin restriction of
   the true broken operator for tensor elements, direct P1 assembly for
   triangles);
3. a pluggable prolongator coarsens it;
4. a "bridge" level lifts interior corners into the broken basis via
   multilinear / P1 weights;
5. the fine cap is the subspace embedding itself (identity for :full, the
   continuous zero-trace embedding for Dirichlet classes); bridge rows are
   masked at every Dirichlet node so coarse spaces stay nested in the
   constrained fine space.

The spectral discretizations (``discretize/spectral.py``) bring their own
hierarchy of polynomial degrees, which ``amg`` and ``geometric_mg`` return
as they are. Everything here is one-time host-side setup; only the resulting level
operators reach the device (``solver/levelops.py``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..discretize.geometry import Geometry
from ..discretize.spectral import (Spectral1D, Spectral2D,
                                   find_boundary_spectral1d,
                                   find_boundary_spectral2d,
                                   spectral1d_multigrid, spectral2d_multigrid)
from ..discretize.tensorfem import (TensorFEM, build_geometry, corner_local,
                                    find_boundary_tensorfem, q1_lift,
                                    refine_connectivity, refine_local,
                                    tf_reference)
from .multigrid import MultiGrid
from .prolongators import amg_ruge_stuben

AXIS_SYMS = ("dx", "dy", "dz")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def pairs_to_linear(pairs, V: int) -> np.ndarray:
    """(v, e) pairs -> linear indices v + e*V into the flat broken layout."""
    return np.asarray([v + e * V for v, e in pairs], dtype=np.int64)


def continuous_subspace(labels: np.ndarray, n_unique: int, dirichlet_set,
                        dtype=np.float64) -> sp.csr_matrix:
    """0/1 embedding of the continuous zero-trace subspace into the broken
    basis: broken node i maps to the interior-id column of its label."""
    interior = [c for c in range(n_unique) if c not in dirichlet_set]
    pos = -np.ones(n_unique, dtype=np.int64)
    pos[interior] = np.arange(len(interior))
    p = pos[labels]
    keep = p >= 0
    rows = np.nonzero(keep)[0]
    return sp.csr_matrix((np.ones(len(rows), dtype=dtype), (rows, p[keep])),
                         shape=(len(labels), len(interior)))


def mask_dirichlet_rows(B: sp.spmatrix, labels: np.ndarray,
                        dd_set) -> sp.csr_matrix:
    """Zero every row of the bridge whose label is Dirichlet, so the coarse
    search space vanishes at *all* Dirichlet DOFs (reference
    ``src/multigrid.jl:98-102``: the multilinear lift otherwise leaks onto
    Dirichlet edge/face nodes on facets with a free corner)."""
    keep = np.array([0.0 if labels[i] in dd_set else 1.0
                     for i in range(B.shape[0])])
    out = sp.diags(keep) @ B
    out = sp.csr_matrix(out)
    out.eliminate_zeros()
    return out


def corner_labels_from_t(t: np.ndarray, corner_locals) -> tuple[np.ndarray, int]:
    """Compact corner ids from full-node connectivity: out[e*nc + ci] in
    0..n_v-1, first-occurrence order."""
    N = t.shape[1]
    nc = len(corner_locals)
    remap: dict = {}
    out = np.empty(nc * N, dtype=np.int64)
    for e in range(N):
        for ci, cl in enumerate(corner_locals):
            fid = int(t[cl, e])
            if fid not in remap:
                remap[fid] = len(remap)
            out[e * nc + ci] = remap[fid]
    return out, len(remap)


def assemble_ladder(P_amg, bridge: sp.csr_matrix, n_broken: int):
    """Level layout (coarsest..finest): [AMG coarse chain..., bridge, identity].

    Returns (refine list, sizes list). refine[l] maps level-l coefficient
    space into level-(l+1)'s; the last entry is the identity cap on the
    broken space. Reference ``_assemble_amg_ladder``
    (``src/amg_prolongators.jl:48-66``).
    """
    K_amg = len(P_amg) + 1
    L = K_amg + 1
    refine = [None] * L
    for i, P in enumerate(P_amg):
        refine[K_amg - 2 - i] = sp.csr_matrix(P)
    refine[K_amg - 1] = sp.csr_matrix(bridge)
    refine[L - 1] = sp.identity(n_broken, format="csr")
    sizes = [0] * L
    sizes[K_amg - 1] = bridge.shape[1]
    for l in range(K_amg - 2, -1, -1):
        sizes[l] = refine[l].shape[1]
    sizes[L - 1] = n_broken
    return refine, sizes


def run_prolongator(K: sp.spmatrix, prolongator):
    if K.shape[0] == 0:
        return []
    return [sp.csr_matrix(P) for P in prolongator(sp.csr_matrix(K, dtype=np.float64))]


def assemble_amg_dicts(geom: Geometry, n_broken: int, dirichlet_nodes: dict,
                       refine_full, sizes_full, build_dirichlet,
                       full_riders: dict | None = None) -> MultiGrid:
    """Assemble the MultiGrid subspace/refine dicts shared by every FEM amg.

    ``:full`` is always built; ``:uniform`` (global constants) rides
    ``:full``'s chain (the AMG chain on the Neumann stiffness preserves
    constants exactly, so the composed column is the fine constant).
    ``full_riders`` adds subspaces riding :full with a custom fine embedding
    (e.g. P2's :broken_P1). Reference ``_assemble_amg_dicts``
    (``src/multigrid.jl:372-412``).
    """
    dtype = geom.dtype
    L = len(refine_full)
    K_amg = L - 1

    def ident_chain(fine_embedding):
        sub = [sp.identity(sizes_full[l], format="csr", dtype=dtype)
               for l in range(K_amg)]
        sub.append(sp.csr_matrix(fine_embedding, dtype=dtype))
        return sub

    subspaces = {"full": ident_chain(sp.identity(n_broken, format="csr")),
                 "uniform": ident_chain(
                     sp.csr_matrix(np.ones((n_broken, 1), dtype=dtype)))}
    # :uniform coarse levels are the constant column at each AMG size
    subspaces["uniform"] = [
        sp.csr_matrix(np.ones((sizes_full[l], 1), dtype=dtype))
        for l in range(K_amg)] + [
        sp.csr_matrix(np.ones((n_broken, 1), dtype=dtype))]
    refine = {"full": refine_full, "uniform": refine_full}
    for sym, E in (full_riders or {}).items():
        subspaces[sym] = ident_chain(E)
        refine[sym] = refine_full
    for sym, nodes in dirichlet_nodes.items():
        if sym in subspaces:
            raise ValueError(f"dirichlet_nodes key :{sym} is reserved")
        r, s = build_dirichlet(list(nodes))
        subspaces[sym] = s
        refine[sym] = r
    return MultiGrid.from_subspaces(geom, subspaces, refine)


# ---------------------------------------------------------------------------
# find_boundary dispatch
# ---------------------------------------------------------------------------

def find_boundary(geom: Geometry):
    """(v, e) pairs (0-based) of the mesh nodes on the domain boundary."""
    disc = geom.discretization
    if isinstance(disc, TensorFEM):
        return find_boundary_tensorfem(geom)
    if isinstance(disc, Spectral1D):
        return find_boundary_spectral1d(geom)
    if isinstance(disc, Spectral2D):
        return find_boundary_spectral2d(geom)
    from ..discretize.fem2d_p1 import FEM2DP1, find_boundary_p1
    from ..discretize.fem2d_p2 import FEM2DP2, find_boundary_p2

    if isinstance(disc, FEM2DP1):
        return find_boundary_p1(geom)
    if isinstance(disc, FEM2DP2):
        return find_boundary_p2(geom)
    raise TypeError(f"find_boundary: unsupported discretization {type(disc)}")


# ---------------------------------------------------------------------------
# amg() dispatch
# ---------------------------------------------------------------------------

def amg(geom: Geometry, *, prolongator=None, dirichlet_nodes=None,
        auxiliary_postprocess=None) -> MultiGrid:
    """Attach an algebraic-multigrid hierarchy to a single-level Geometry."""
    disc = geom.discretization
    if isinstance(disc, Spectral1D):
        return spectral1d_multigrid(disc.n, geom.dtype)
    if isinstance(disc, Spectral2D):
        return spectral2d_multigrid(disc.n, geom.dtype)
    if prolongator is None:
        prolongator = amg_ruge_stuben(max_coarse=2)
    if dirichlet_nodes is None:
        dirichlet_nodes = {"dirichlet": find_boundary(geom)}
    if isinstance(disc, TensorFEM):
        return _amg_tensorfem(geom, prolongator, dirichlet_nodes,
                              auxiliary_postprocess)
    from ..discretize.fem2d_p1 import FEM2DP1, amg_p1
    from ..discretize.fem2d_p2 import FEM2DP2, amg_p2

    if isinstance(disc, FEM2DP1):
        return amg_p1(geom, prolongator, dirichlet_nodes, auxiliary_postprocess)
    if isinstance(disc, FEM2DP2):
        return amg_p2(geom, prolongator, dirichlet_nodes)
    raise TypeError(f"amg: unsupported discretization {type(disc)}")


def _interior_q1_lift(node_map_q1: np.ndarray, k: int, d: int, n_v: int,
                      interior: np.ndarray, dtype) -> sp.csr_matrix:
    """Lift interior Q1 corners -> broken Q_k basis via the per-element
    multilinear corner weights (boundary-corner pushes dropped)."""
    s = k + 1
    ref = tf_reference(d, k)
    n = ref.n
    nc = 1 << d
    L = q1_lift(ref, d)                         # (n, nc)
    N = len(node_map_q1) // nc
    interior_idx = -np.ones(n_v, dtype=np.int64)
    interior_idx[np.asarray(interior, dtype=np.int64)] = np.arange(len(interior))
    rows, cols, vals = [], [], []
    nzr, nzc = np.nonzero(L)
    for e in range(N):
        cui = interior_idx[node_map_q1[e * nc:(e + 1) * nc]]
        ok = cui[nzc] >= 0
        rows.append(e * n + nzr[ok])
        cols.append(cui[nzc[ok]])
        vals.append(L[nzr[ok], nzc[ok]])
    rows = np.concatenate(rows) if rows else np.empty(0, dtype=np.int64)
    cols = np.concatenate(cols) if cols else np.empty(0, dtype=np.int64)
    vals = np.concatenate(vals) if vals else np.empty(0)
    return sp.csr_matrix((vals.astype(dtype), (rows, cols)),
                         shape=(N * n, len(interior)))


def _amg_tensorfem(geom, prolongator, dirichlet_nodes, auxiliary_postprocess):
    disc = geom.discretization
    d, k = disc.d, disc.k
    dtype = geom.dtype
    s = k + 1
    n = s ** d
    N = geom.x.shape[1]
    n_broken = n * N
    nc = 1 << d

    full_labels = geom.t.reshape(-1, order="F")
    n_full_unique = int(full_labels.max()) + 1
    cornerlocal = [corner_local(c, s, d) for c in range(nc)]
    node_map_q1, n_v = corner_labels_from_t(geom.t, cornerlocal)

    # all-corners auxiliary stiffness from the broken operators:
    # A = sum_a Da' W Da over the ambient gradient components
    W = sp.diags(geom.w.astype(np.float64))
    A = sp.csr_matrix((n_broken, n_broken))
    for a in range(geom.x.shape[2]):
        Da = geom.operators[AXIS_SYMS[a]].to_sparse().astype(np.float64)
        A = A + Da.T @ W @ Da

    full_to_corner = {}
    for e in range(N):
        for c in range(nc):
            full_to_corner[int(full_labels[n * e + cornerlocal[c]])] = \
                int(node_map_q1[nc * e + c])

    S_full = _interior_q1_lift(node_map_q1, k, d, n_v, np.arange(n_v), dtype)
    K_full = sp.csr_matrix((S_full.astype(np.float64).T @ A @ S_full))
    if auxiliary_postprocess is not None:
        K_full = sp.csr_matrix(auxiliary_postprocess(K_full))

    P_full = run_prolongator(K_full, prolongator)
    refine_full, sizes_full = assemble_ladder(P_full, S_full, n_broken)

    def build_dirichlet(nodes):
        dd_set = set(int(full_labels[r]) for r in pairs_to_linear(nodes, n))
        dc_set = set(full_to_corner[f] for f in dd_set if f in full_to_corner)
        interior = np.array(sorted(set(range(n_v)) - dc_set), dtype=np.int64)
        K_int = K_full[interior][:, interior] if len(interior) else \
            sp.csr_matrix((0, 0))
        P_dir = run_prolongator(K_int, prolongator)
        bridge = _interior_q1_lift(node_map_q1, k, d, n_v, interior, dtype)
        bridge = mask_dirichlet_rows(bridge, full_labels, dd_set)
        refine_dir, sizes_dir = assemble_ladder(P_dir, bridge, n_broken)
        K_amg = len(refine_dir) - 1
        sub = [sp.identity(sizes_dir[l], format="csr", dtype=dtype)
               for l in range(K_amg)]
        sub.append(continuous_subspace(full_labels, n_full_unique, dd_set, dtype))
        return refine_dir, sub

    return assemble_amg_dicts(geom, n_broken, dirichlet_nodes,
                              refine_full, sizes_full, build_dirichlet)


# ---------------------------------------------------------------------------
# geometric_mg dispatch
# ---------------------------------------------------------------------------

def geometric_mg(geom: Geometry, L: int) -> MultiGrid:
    """Geometric-subdivision hierarchy of L levels (fine = L-1 subdivisions)."""
    disc = geom.discretization
    if isinstance(disc, Spectral1D):
        return spectral1d_multigrid(disc.n, geom.dtype)
    if isinstance(disc, Spectral2D):
        return spectral2d_multigrid(disc.n, geom.dtype)
    if isinstance(disc, TensorFEM):
        return _geometric_mg_tensorfem(geom, L)
    from ..discretize.fem2d_p1 import FEM2DP1, geometric_mg_p1
    from ..discretize.fem2d_p2 import FEM2DP2, geometric_mg_p2

    if isinstance(disc, FEM2DP1):
        return geometric_mg_p1(geom, L)
    if isinstance(disc, FEM2DP2):
        return geometric_mg_p2(geom, L)
    raise TypeError(f"geometric_mg: unsupported discretization {type(disc)}")


def subdivide(geom: Geometry, L: int) -> Geometry:
    """Refine by L-1 levels of geometric subdivision (operators rebuilt)."""
    return geometric_mg(geom, L).geometry


def _block_refine_sparse(P_local: np.ndarray, n_elems: int, n: int,
                         nc: int, dtype) -> sp.csr_matrix:
    """Per-element broken refine: each parent's n dofs map to its nc children."""
    blocks = [sp.csr_matrix(P_local.astype(dtype)) for _ in range(n_elems)]
    return sp.block_diag(blocks, format="csr")


def _geometric_mg_tensorfem(geom, L):
    disc = geom.discretization
    d, k = disc.d, disc.k
    dtype = geom.dtype
    if L < 1:
        raise ValueError("L must be >= 1")
    s = k + 1
    n = s ** d
    nc = 1 << d
    P_local = refine_local(k, d)

    meshes = [np.asarray(geom.x, dtype=dtype)]
    topos = [geom.t.copy()]
    for l in range(L - 1):
        Xc = meshes[l]
        Nl = Xc.shape[1]
        Xf = np.empty((n, Nl * nc, Xc.shape[2]), dtype=dtype)
        for ch in range(nc):
            blk = P_local[ch * n:(ch + 1) * n, :]
            Xf[:, ch::nc, :] = np.einsum("im,mNe->iNe", blk, Xc)
        meshes.append(Xf)
        topos.append(refine_connectivity(topos[l], k, d))

    geomL = geom if L == 1 else build_geometry(d, disc.e, k, meshes[-1],
                                               t=topos[-1])
    refine = []
    for l in range(L - 1):
        refine.append(_block_refine_sparse(P_local, meshes[l].shape[1],
                                           n, nc, dtype))
    refine.append(sp.identity(n * meshes[-1].shape[1], format="csr",
                              dtype=dtype))

    subspaces = {"dirichlet": [], "full": [], "uniform": []}
    for l in range(L):
        labels = topos[l].reshape(-1, order="F")
        n_unique = int(labels.max()) + 1
        gl = Geometry.__new__(Geometry)
        gl.discretization = disc
        gl.x = meshes[l]
        gl.t = topos[l]
        gl.w = np.zeros(meshes[l].shape[0] * meshes[l].shape[1], dtype=dtype)
        gl.operators = {}
        pairs = find_boundary_tensorfem(gl)
        bset = set(int(labels[v + e * n]) for v, e in pairs)
        nl = n * meshes[l].shape[1]
        subspaces["dirichlet"].append(
            continuous_subspace(labels, n_unique, bset, dtype))
        subspaces["full"].append(sp.identity(nl, format="csr", dtype=dtype))
        subspaces["uniform"].append(
            sp.csr_matrix(np.ones((nl, 1), dtype=dtype)))

    return MultiGrid.from_subspaces(geomL, subspaces,
                                    {k2: refine for k2 in subspaces})
