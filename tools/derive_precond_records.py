#!/usr/bin/env python3
"""Derive the JAX x64 records of the large-level preconditioners
(``MGBTPU_BIG_PRE``: vcycle, fsai, fsai2, fsai2a) that the port's tests and
``chip_smoke.py`` hold the port to. Runs the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/derive_precond_records.py          # all
    JAX_PLATFORMS=cpu python tools/derive_precond_records.py l3 pcg   # some
    JAX_PLATFORMS=cpu python tools/derive_precond_records.py l3 fsai2 # one

Records, under ``mgbtpu_torch/data``:

- ``l3``: ``ref_fem2d_p2_L3_<choice>.npz``, ``assemble`` -> ``mgb_solve``
  of fem2d_P2 p=1 at L=3 with ``DENSE_MAX=50`` and ``DENSE_BASE=40`` (so
  that the top level, n_J = 305, takes the preconditioner): z, the Newton
  its per level and per ramp step, the CG counts, the steps. Beside the
  record, the same solve three times more with a last-bit change that
  leaves the method as it is (``PERTURBATIONS``: the CG dots in plain f64
  instead of the package's compensated ones, f and g one ulp up), under
  ``<name>/``: many of these CG solves stop at the 150-iteration cap,
  where last-bit differences steer the ramp, and these runs measure how
  far the reference itself moves (``spread``).
- ``pcg``: ``ref_pcg_L5_<choice>.npz``, one ``make_pcg_pre`` +
  ``pcg_solve`` at the top level of fem2d_P2 L=5 (n_J = 5,057 at p=1)
  with the default ``DENSE_MAX`` and ``DENSE_BASE``, at two states:
  ``p2/`` (p=2, t=100, s=0 from g, as ``tests/test_pcg_scaling.py``) and
  ``deep/`` (p=1 at the last t of the stored p=1 L=5 ramp,
  ``ref_fem2d_p2_L5.npz``, from its solution): x, the CG count, and for
  the V-cycle the chosen levels' sizes and lambda_max.
  For fsai2/fsai2a the JAX package's own result beside it
  (``<state>/as_is/``): its ``build_bsr`` puts entries in the wrong tiles
  once a matrix has more than one column tile, which the coarse transfer
  has at L=5 (a dense base of 514 or more coefficients); the records are
  derived with that tiling repaired (``repaired_build_bsr``), as the port
  builds it. At L=3 (a dense base of at most 40) both agree.
- ``l4``: ``ref_fem2d_p2_L4_vcycle.npz``, the V-cycle ramp at L=4 with the
  default knobs (``chip_smoke.py --precond-full``), with its perturbed
  runs as the L=3 records (four solves of about 6 minutes each).

The JAX package's AOT export cache keys the ``MGBTPU_*`` environment but
not module attributes set at run time, so this script turns it off
(``MGBTPU_AOT_CACHE=0``): with it on, a solve under one ``BIG_PRE`` can
load the program traced under another.
"""
from __future__ import annotations

import os
import sys
import time

os.environ["MGBTPU_AOT_CACHE"] = "0"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "mgbtpu_torch", "data")
CHOICES = ("vcycle", "fsai", "fsai2", "fsai2a")
PERTURBATIONS = ("plain_dots", "ulp_f", "ulp_g")
L3_KNOBS = dict(DENSE_MAX=50, DENSE_BASE=40)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def repaired_build_bsr(A, dtype=None):
    """The JAX package's ``build_bsr`` with its tile assignment repaired:
    it pairs the tile ids, in sorted-key order, with the entries in COO
    order, so a matrix of more than one column tile gets entries in the
    wrong tiles; here each entry goes to its own tile (as the port's
    ``mgbtpu_torch/ops/bsr.py``). Only the coarse transfer of fsai2/fsai2a
    is built with it."""
    import numpy as np
    import scipy.sparse as sp

    from mgbtpu.ops.bsr import B, BsrMatrix
    from mgbtpu.utils import to_dev

    dtype = dtype or np.float64
    A = sp.csr_matrix(A)
    n, m = A.shape
    nrt, nct = -(-n // B), -(-m // B)
    coo = A.tocoo()
    key = (coo.row // B).astype(np.int64) * nct + coo.col // B
    uniq = np.unique(key)
    T = max(len(uniq), 1)
    tiles = np.zeros((T, B, B), dtype)
    np.add.at(tiles, (np.searchsorted(uniq, key), coo.row % B, coo.col % B),
              coo.data.astype(dtype))
    rid = (uniq // nct) if len(uniq) else np.zeros(1, np.int64)
    cid = (uniq % nct) if len(uniq) else np.zeros(1, np.int64)
    return BsrMatrix(rid=to_dev(rid, np.int32), cid=to_dev(cid, np.int32),
                     tiles=to_dev(tiles), n_rows=n, n_cols=m, nrt=nrt,
                     nct=nct, T=T)


def _configure(choice, knobs=None, repair_bsr=True):
    """Set BIG_PRE and the level knobs of the JAX package, and (unless
    ``repair_bsr`` is False) its ``build_bsr`` to ``repaired_build_bsr``;
    returns a function that restores them."""
    from mgbtpu.ops import bsr
    from mgbtpu.solver import mgb as M, newton as N

    knobs = knobs or {}
    old = {k: getattr(M.ProblemKernels, k) for k in knobs}
    old_pre, old_bsr = N.BIG_PRE, bsr.build_bsr
    for k, v in knobs.items():
        setattr(M.ProblemKernels, k, v)
    N.BIG_PRE = choice
    if repair_bsr:
        bsr.build_bsr = repaired_build_bsr

    def restore():
        for k, v in old.items():
            setattr(M.ProblemKernels, k, v)
        N.BIG_PRE, bsr.build_bsr = old_pre, old_bsr
    return restore


def _solve_record(sol):
    import numpy as np

    S = sol.SOL_main
    return dict(z=np.asarray(sol.z, np.float64),
                its=np.asarray(S["its"], np.int64),
                its_per_level=np.asarray(S["its"].sum(axis=1), np.int64),
                cg=np.asarray(S["cg"], np.int64),
                steps=np.array([S["steps_accepted"], S["steps_attempted"]],
                               np.int64))


def ramp_record(choice, L, knobs=None, perturbation=None):
    """One JAX x64 ``mgb_solve`` of fem2d_P2 p=1 at level L under
    ``choice``, with an optional last-bit ``perturbation``."""
    _jax()
    import jax.numpy as jnp
    import numpy as np

    import mgbtpu
    from mgbtpu.ops import df64

    restore = _configure(choice, knobs)
    dd_dot = df64.dd_dot
    try:
        if perturbation == "plain_dots":
            df64.dd_dot = lambda a, b: (jnp.dot(a, b),
                                        jnp.zeros((), a.dtype))
        mg = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
        prob = mgbtpu.assemble(mg, p=1.0)
        if perturbation == "ulp_f":
            prob.f_grid = prob.f_grid * (1 + np.finfo(np.float64).eps)
        elif perturbation == "ulp_g":
            prob.g_grid = np.nextafter(prob.g_grid, np.inf)
        t0 = time.time()
        sol = mgbtpu.mgb_solve(prob)
        out = _solve_record(sol)
        out["seconds"] = np.array(time.time() - t0)
        return out
    finally:
        df64.dd_dot = dd_dot
        restore()


def spread_record(choice, L, knobs=None):
    """The level-L ramp record of ``choice`` with its perturbed runs
    beside it."""
    import numpy as np

    out = dict(ramp_record(choice, L, knobs), L=np.array(L))
    for name in PERTURBATIONS:
        rec = ramp_record(choice, L, knobs, perturbation=name)
        out.update({f"{name}/{k}": v for k, v in rec.items()})
    return out


def l3_record(choice):
    """The L=3 record of ``choice`` (DENSE_MAX=50, DENSE_BASE=40)."""
    return spread_record(choice, 3, L3_KNOBS)


def pcg_state(choice, L, p, state, repair_bsr=True):
    """One ``make_pcg_pre`` + ``pcg_solve`` at the top level of fem2d_P2
    level L under ``choice`` (default knobs) at ``state``: "p2" (t=100,
    s=0 from g) or "deep" (p=1, the last t of the stored L=5 ramp, from
    its solution). Returns x, its CG count and the V-cycle's data."""
    _jax()
    import jax.numpy as jnp
    import numpy as np

    import mgbtpu
    from mgbtpu.solver.mgb import _kernels_for, barrier_weights
    from mgbtpu.solver.newton import (linesearch_backtracking,
                                      make_pcg_pre, pcg_solve)

    restore = _configure(choice, repair_bsr=repair_bsr)
    try:
        prob = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(
            mgbtpu.fem2d_P2(), L)), p=p)
        M1 = prob.M[0]
        kern = _kernels_for(M1, prob.Q.barrier, linesearch_backtracking(),
                            np.float64)
        l = M1.depth - 1
        ops = kern.ops(l)
        w = M1.w.astype(np.float64)
        bw = barrier_weights(w, None)
        if state == "p2":
            t = 100.0
            z = np.asarray(prob.g_grid, np.float64).T.reshape(-1)
        else:
            ref = np.load(os.path.join(DATA, "ref_fem2d_p2_L5.npz"))
            # the ramp ends on its target, 1/tol with the default tol
            t = 1.0 / float(np.sqrt(np.finfo(np.float64).eps))
            z = np.asarray(ref["z"], np.float64).T.reshape(-1)
        wc = w[:, None] * (t * prob.f_grid)
        fa = kern._fargs(l, z, wc, bw, tuple(prob.Q.args))
        s0 = jnp.zeros((ops.n_J,), np.float64)
        g = kern.fns[1](s0, *fa)
        H = kern.fns[2](s0, *fa)
        t0 = time.time()
        pre = make_pcg_pre(H)
        x, k = pcg_solve(H, g, pre=pre, return_stats=True)
        x = np.asarray(x)
        out = dict(x=x, cg=np.array(int(k)), t=np.array(t),
                   n_J=np.array(ops.n_J),
                   seconds=np.array(time.time() - t0))
        ctx = ops.pcg_ctx
        out["levels"] = np.array([o.n_J for o in ctx.coarse_ops], np.int64)
        if choice == "vcycle":
            out["lambda_max"] = np.array(float(pre[2][1]))
        return out
    finally:
        restore()


def pcg_record(choice, L=5):
    """Both states; for fsai2/fsai2a also the JAX package's own result
    with its unrepaired ``build_bsr`` (``<state>/as_is/``), which the
    port is not held to."""
    out = {"L": __import__("numpy").array(L)}
    for state, p in (("p2", 2.0), ("deep", 1.0)):
        rec = pcg_state(choice, L, p, state)
        out.update({f"{state}/{k}": v for k, v in rec.items()})
        if choice in ("fsai2", "fsai2a"):
            rec = pcg_state(choice, L, p, state, repair_bsr=False)
            out.update({f"{state}/as_is/{k}": rec[k] for k in ("x", "cg")})
    return out


def main(argv):
    import numpy as np

    which = [a for a in argv if a not in CHOICES] or ["l3", "pcg", "l4"]
    choices = [a for a in argv if a in CHOICES] or CHOICES
    if "l3" in which:
        for c in choices:
            rec = l3_record(c)
            path = os.path.join(DATA, f"ref_fem2d_p2_L3_{c}.npz")
            np.savez_compressed(path, **rec)
            print(f"wrote {path}: its {int(rec['its'].sum())}, cg "
                  f"{int(rec['cg'].sum())}; perturbed its "
                  + ", ".join(f"{n} {int(rec[n + '/its'].sum())}"
                              for n in PERTURBATIONS), flush=True)
    if "pcg" in which:
        for c in choices:
            rec = pcg_record(c)
            path = os.path.join(DATA, f"ref_pcg_L5_{c}.npz")
            np.savez_compressed(path, **rec)
            print(f"wrote {path}: cg p2 {int(rec['p2/cg'])}, deep "
                  f"{int(rec['deep/cg'])}, levels "
                  f"{rec['p2/levels'].tolist()}", flush=True)
    if "l4" in which:
        rec = spread_record("vcycle", 4)
        path = os.path.join(DATA, "ref_fem2d_p2_L4_vcycle.npz")
        np.savez_compressed(path, **rec)
        print(f"wrote {path}: its {int(rec['its'].sum())}, cg "
              f"{int(rec['cg'].sum())}, {float(rec['seconds'])!r} s; "
              "perturbed its " + ", ".join(
                  f"{n} {int(rec[n + '/its'].sum())}" for n in PERTURBATIONS),
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
