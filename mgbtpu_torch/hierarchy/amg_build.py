"""amg(geom) / geometric_mg(geom, L) for fem2d_P2.

Host numpy/scipy, a copy of the fem2d_P2 branch of
``mgbtpu/hierarchy/amg_build.py`` (the reference's ``amg`` for P2 is
``src/fem2d_P2.jl:400-455``):

1. corner labels from the cached connectivity t;
2. an auxiliary all-corners Neumann P1 stiffness on the corner mesh;
3. a pluggable prolongator coarsens it;
4. a "bridge" level lifts interior corners into the broken P2 basis via
   P1 weights;
5. the fine cap is the subspace embedding itself (identity for :full, the
   continuous zero-trace embedding for Dirichlet classes); bridge rows are
   masked at every Dirichlet node so coarse spaces stay nested in the
   constrained fine space.

Everything here is one-time host-side setup; only the resulting level
operators reach the device (``solver/levelops.py``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..discretize.geometry import Geometry
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
# Dispatch: the fem2d_P2 branch only
# ---------------------------------------------------------------------------

def _require_p2(geom: Geometry, what: str):
    from ..discretize.fem2d_p2 import FEM2DP2

    if not isinstance(geom.discretization, FEM2DP2):
        raise NotImplementedError(
            f"{what}: only fem2d_P2 is ported; other discretizations "
            f"({type(geom.discretization).__name__}) are ROADMAP Queue 1 "
            "item 10 (standalone host setup)")


def find_boundary(geom: Geometry):
    """(v, e) pairs (0-based) of the mesh nodes on the domain boundary."""
    from ..discretize.fem2d_p2 import find_boundary_p2

    _require_p2(geom, "find_boundary")
    return find_boundary_p2(geom)


def amg(geom: Geometry, *, prolongator=None, dirichlet_nodes=None) -> MultiGrid:
    """Attach an algebraic-multigrid hierarchy to a single-level Geometry."""
    from ..discretize.fem2d_p2 import amg_p2

    _require_p2(geom, "amg")
    if prolongator is None:
        prolongator = amg_ruge_stuben(max_coarse=2)
    if dirichlet_nodes is None:
        dirichlet_nodes = {"dirichlet": find_boundary(geom)}
    return amg_p2(geom, prolongator, dirichlet_nodes)


def geometric_mg(geom: Geometry, L: int) -> MultiGrid:
    """Geometric-subdivision hierarchy of L levels (fine = L-1 subdivisions)."""
    from ..discretize.fem2d_p2 import geometric_mg_p2

    _require_p2(geom, "geometric_mg")
    return geometric_mg_p2(geom, L)


def subdivide(geom: Geometry, L: int) -> Geometry:
    """Refine by L-1 levels of geometric subdivision (operators rebuilt)."""
    return geometric_mg(geom, L).geometry
