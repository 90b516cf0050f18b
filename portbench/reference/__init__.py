"""The plain reference of the benchmark, in NumPy.

It rebuilds, from the configuration alone, what the program's set-up derives
from it: the fine mesh's nodes in the order ``subdivide`` numbers them, the
nodal quadrature weights, the derivative of the element basis at every node,
the continuous numbering of the scalar field ``u`` and its Dirichlet nodes.
``certify`` then judges a solution ``z`` of the p = 1 barrier problem by the
optimality conditions of its central point at the final barrier parameter.

A configuration names its module here by ``reference.module``; the module
exposes ``build(cfg) -> Discretization``. Nothing here imports the program,
JAX or the JAX package.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np


@dataclass
class Discretization:
    """One fine level, nodes in the program's order (row e*n + v).

    x (m, d) node coordinates; w (m,) quadrature weights; elem (N, n) the
    rows of each element's nodes; deriv (d, N, n, n) with deriv[a, e, i, j]
    the derivative along axis a of basis function j of element e at its node
    i (N may be 1 where every element has the same matrices); dof (m,)
    the continuous id of each node's value of u; boundary (n_dof,) whether
    that id lies on the domain's boundary."""

    x: np.ndarray
    w: np.ndarray
    elem: np.ndarray
    deriv: np.ndarray
    dof: np.ndarray
    boundary: np.ndarray

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]


def build(cfg) -> Discretization:
    """The discretization of configuration ``cfg`` (its parsed file)."""
    ref = cfg["reference"]
    mod = importlib.import_module(f"{__name__}.{ref['module']}")
    return mod.build(cfg)
