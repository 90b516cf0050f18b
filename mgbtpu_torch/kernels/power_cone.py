"""K2 ``power_cone_eval``: the per-node power-cone barrier, fused with the
level's weight mask and linear term.

Replaces the Pallas kernel ``node_eval`` (``mgbtpu/ops/pallas_dd.py:258``,
call :353), which ran ``vmap(F)`` of a traced per-node function; its f64
counterpart on the x64 path is ``jax.vmap(F)`` (``mgbtpu/solver/
barrier.py:59``) of the Euclidean power cone (``mgbtpu/convex/
euclidian_power.py:46-116``) inside the level functions (``barrier.py:
61-109``). Per node, with z = A Dz[idx] + b = (q, s) and alpha = 2/p::

    F0 = -Log(s^alpha - |q|^2) - mu Log(s)
    mode 0:  bw F0 (0 where bw == 0) + <wc, Dz>          -> (m,)
    mode 1:  bw A'grad (0 where bw == 0) + wc             -> (m, nD)
    mode 2:  bw A'Hess A (0 where bw == 0)                -> (m, nD, nD)

``spec`` is the static alpha specialisation of the JAX code (2 for p = 1,
1 for p = 2, 0 for the general ``safe_pow``). Every operation follows the
JAX expressions in the same order, and the non-finite semantics are kept
exactly (``Log`` of a value at or below sqrt(tiny), NaN included, is -inf;
``safe_pow`` of s <= 0 is 0; masked nodes give 0, never 0*inf): the line
searches reject non-finite trial points, so any difference here would
change the Newton path.

CUDA design (``csrc/power_cone.cu``, the closed forms in
``csrc/power_cone.cuh``, shared with K6): one thread per node in blocks of
32 nodes (64 above 8,448 nodes), one instance per (nz, mode, spec), so every
loop over the cone unrolls and z, A and the nz x nz Hessians stay in
registers. A block stages its nodes' A, b, Dz and wc in shared memory with
coalesced ``cp.async`` copies; modes 1 and 2 build the block's rows or
nD x nD blocks in shared memory (the entries outside the cone's rows
first, then the cone's entries at the ``idx`` positions) and store them
coalesced. nz <= 5, nD <= 12. Every other barrier family, the power
cone's cobarrier and a lone cone past those limits run through K6
(``node_barrier.py``). What bounds it on
an H100: bytes (a few hundred flops per node against ~(nz^2 + 2nD + 4)
doubles read); at L=5 the inputs sit in L2 and the call is launch-bound.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build as B
from ..convex._common import gather, scatter_mat, scatter_vec, ssum
from ..utils.log import Log, barrier_floor, safe_pow
from ..utils.trace import enqueue

NAME = "power_cone"
MAX_NZ, MAX_ROWS = 5, 12    # the kernel's limits (K6 takes wider cones)
_ARGS = ([ctypes.c_int] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7
         + [ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p])


def pow_alpha(s, alpha, spec):
    """s^alpha with safe_pow semantics (0 for s <= 0); exact for the static
    alpha in {1, 2}."""
    if spec == 2:
        return torch.where(s > 0, s * s, torch.zeros_like(s))
    if spec == 1:
        return torch.where(s > 0, s, torch.zeros_like(s))
    return safe_pow(s, alpha)


def core_parts(A, b, idx, Dz):
    """z = A Dz[idx] + b as a list of (m,) columns; returns (q list, s)."""
    nz = b.shape[1]
    ys = gather(idx, Dz)
    z = [ssum([A[:, i * nz + j] * ys[j] for j in range(nz)]) + b[:, i]
         for i in range(nz)]
    return z[:-1], z[-1]


def core_value(q, s, p, mu, spec):
    alpha = 2.0 / p
    q_sq = ssum([qi * qi for qi in q])
    return -Log(pow_alpha(s, alpha, spec) - q_sq) - mu * Log(s)


def core_grad(q, s, p, mu, spec):
    """Gradient wrt (q, s) as a list of nz columns (euclidian_power.py
    ``_core_grad``)."""
    alpha = 2.0 / p
    q_sq = ssum([qi * qi for qi in q])
    s_a = pow_alpha(s, alpha, spec)
    r = s_a - q_sq
    inv_r = 1.0 / r
    two_ir = 2.0 * inv_r
    grad_q = [two_ir * qi for qi in q]
    s_am1 = s_a / s
    grad_s = -alpha * s_am1 * inv_r - mu / s
    return grad_q + [grad_s]


def core_hess_parts(q, s, p, mu, spec):
    """The pieces of the Hessian wrt (q, s) (euclidian_power.py
    ``_core_hess``, the factored form): u = q / r (a list), two_ir, the
    cross factor cv (Hz[i][nq] = cv u_i) and H_ss."""
    alpha = 2.0 / p
    q_sq = ssum([qi * qi for qi in q])
    s_a = pow_alpha(s, alpha, spec)
    r = s_a - q_sq
    inv_r = 1.0 / r
    s_am1 = s_a / s
    s_am2 = s_am1 / s
    u = [inv_r * qi for qi in q]
    v = s_am1 * inv_r
    H_ss = (-alpha * (alpha - 1.0) * s_am2 * inv_r
            + (alpha * alpha) * (v * v) + (mu / s) / s)
    return u, 2.0 * inv_r, -2.0 * alpha * v, H_ss


def core_hess(q, s, p, mu, spec):
    """Hessian wrt (q, s) as a nested nz x nz list (euclidian_power.py
    ``_core_hess``: Hz[i][j] = 4 u_i u_j (+ two_ir on the diagonal),
    Hz[i][nq] = cv u_i, Hz[nq][nq] = H_ss)."""
    u, two_ir, cv, H_ss = core_hess_parts(q, s, p, mu, spec)
    n = len(q)
    cross = [cv * ui for ui in u]
    rows = []
    for i in range(n):
        row = [4.0 * u[i] * u[j] + two_ir if i == j else 4.0 * u[i] * u[j]
               for j in range(n)]
        rows.append(row + [cross[i]])
    rows.append(cross + [H_ss])
    return rows


def at_g(A, g, nz):
    """A' g for per-node A (m, nz*nz) and g a list of nz columns."""
    return [ssum([A[:, k * nz + i] * g[k] for k in range(nz)])
            for i in range(nz)]


def at_h_a(A, Hz, nz):
    """A' Hz A, nested list (``_AtHA``): entry (i, j) is the left fold over
    the (k, l) pairs, k-major, of (A[k, i] Hz[k, l]) A[l, j]. The fold runs
    over all (i, j) at once, one (m, nz, nz) add a pair (the same
    products, rounded alike, summed in the same order: the same bits as
    nz^4 scalar columns, at a cost that stays small at nz = 33)."""
    Am = A.reshape(-1, nz, nz)
    acc = None
    for k in range(nz):
        for l in range(nz):
            t = (Am[:, k, :, None] * Hz[k][l][:, None, None]) \
                * Am[:, l, None, :]
            acc = t if acc is None else acc + t
    return [[acc[:, i, j] for j in range(nz)] for i in range(nz)]


def at_h_a_gram(A, u, two_ir, cv, H_ss, nz):
    """A' Hz A in the Gram order of K6's runtime-width cone
    (``csrc/power_cone.cuh`` ``pcw_w_i``, ``pcw_h_ij``), from
    ``core_hess_parts``: with nq = nz - 1, Aq the rows 0..nq-1 of A and
    a = its row nq, Hz = [[4 u u' + two_ir I, cv u], [cv u', H_ss]] gives
    A' Hz A = two_ir Aq'Aq + 4 w w' + cv (w a' + a w') + H_ss a a' with
    w = Aq' u. Per entry, each sum a left fold::

        g_ij = fold over k = 0..nq-1, ascending, of A[k,i] A[k,j]
        w_i  = fold over k = 0..nq-1, ascending, of A[k,i] u_k
        H_ij = ((two_ir g_ij + 4 (w_i w_j)) + cv (w_i a_j + a_i w_j))
               + H_ss (a_i a_j)

    and the cobarrier's cross entries cr_i = cv w_i + H_ss a_i. Returns
    (H (m, nz, nz), cr (m, nz)); H is bitwise symmetric."""
    Am = A.reshape(-1, nz, nz)
    nq = nz - 1
    g = ssum([Am[:, k, :, None] * Am[:, k, None, :] for k in range(nq)])
    w = ssum([Am[:, k, :] * u[k][:, None] for k in range(nq)])
    a = Am[:, nq, :]
    wi, wj, ai, aj = w[:, :, None], w[:, None, :], a[:, :, None], a[:, None, :]
    H = ((two_ir[:, None, None] * g + 4.0 * (wi * wj))
         + cv[:, None, None] * (wi * aj + ai * wj)) \
        + H_ss[:, None, None] * (ai * aj)
    return H, cv[:, None] * w + H_ss[:, None] * a


def power_cone_plain(mode, Dz, A, b, p, mu, bw, wc, idx, spec):
    """Plain PyTorch version of the kernel (same arithmetic, same order)."""
    nz = b.shape[1]
    nD = Dz.shape[1]
    q, s = core_parts(A, b, idx, Dz)
    if mode == 0:
        v = core_value(q, s, p, mu, spec)
        lin = ssum([wc[:, k] * Dz[:, k] for k in range(nD)])
        return torch.where(bw != 0, bw * v, torch.zeros_like(v)) + lin
    if mode == 1:
        g = scatter_vec(idx, at_g(A, core_grad(q, s, p, mu, spec), nz), nD, s)
        bw1 = bw[:, None]
        return torch.where(bw1 != 0, bw1 * g, torch.zeros_like(g)) + wc
    H = scatter_mat(idx, at_h_a(A, core_hess(q, s, p, mu, spec), nz), nD, s)
    bw2 = bw[:, None, None]
    return torch.where(bw2 != 0, bw2 * H, torch.zeros_like(H))


def takes(nz: int, nD: int) -> bool:
    """Whether the kernel takes a cone of nz rows over nD rows of Dz (on
    every device the Convex routes a wider one to K6)."""
    return 2 <= nz <= MAX_NZ and nD <= MAX_ROWS


@enqueue("power_cone")
def power_cone_eval(mode, Dz, A, b, p, mu, bw, wc, idx, spec):
    """Dz (m, nD), A (m, nz*nz), b (m, nz), p/mu/bw (m,), wc (m, nD); ``idx``
    the nz input rows (tuple of ints), ``spec`` in {0, 1, 2}. Returns the
    mode's per-node output (see the module docstring)."""
    idx = tuple(int(i) for i in idx)
    if not B.on_cuda(NAME, Dz, A, b, p, mu, bw, wc):
        return power_cone_plain(mode, Dz, A, b, p, mu, bw, wc, idx, spec)
    m, nD = Dz.shape
    nz = len(idx)
    B.require(mode in (0, 1, 2), NAME, f"mode {mode}")
    B.require(spec in (0, 1, 2), NAME, f"spec {spec}")
    B.require(takes(nz, nD), NAME, f"nz={nz}, nD={nD}")
    B.require(all(0 <= i < nD for i in idx), NAME, f"idx {idx}")
    B.cuda_f64(NAME, Dz, (m, nD), "Dz")
    B.cuda_f64(NAME, A, (m, nz * nz), "A")
    B.cuda_f64(NAME, b, (m, nz), "b")
    for t, label in ((p, "p"), (mu, "mu"), (bw, "bw")):
        B.cuda_f64(NAME, t, (m,), label)
    B.cuda_f64(NAME, wc, (m, nD), "wc")
    shape = ((m,), (m, nD), (m, nD, nD))[mode]
    out = torch.empty(shape, dtype=torch.float64, device=Dz.device)
    ids = list(idx) + [0] * (5 - nz)
    fn = B.launcher(NAME, _ARGS)
    err = fn(mode, spec, m, nD, nz, *ids,
             B.ptr(Dz), B.ptr(A), B.ptr(b), B.ptr(p), B.ptr(mu), B.ptr(bw),
             B.ptr(wc), barrier_floor(torch.float64), B.ptr(out),
             B.stream(Dz.device))
    B.check(NAME, err)
    power_cone_eval.launches += 1
    power_cone_eval.mode_launches[mode] += 1
    return out


power_cone_eval.launches = 0
power_cone_eval.mode_launches = [0, 0, 0]     # the same launches by mode
