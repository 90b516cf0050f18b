"""JAX x64 yardsticks of the PyTorch port's card runs.

``chip_smoke.py`` holds the port's card solves against solve records of the
JAX package, stored in ``mgbtpu_torch/data/*.npz``: the solution, the Newton
iterations per level and per ramp step of the main ramp and of phase I, and
the accepted/attempted ramp steps. The ``tests/test_torch_reference_*.py``
files re-derive them from JAX in tier-1 and write them from their
``__main__``; this module holds what they share (not a test module).
"""
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "mgbtpu_torch", "data")


def solve_record(sol) -> dict:
    S, F = sol.SOL_main, sol.SOL_feasibility
    return dict(z=np.asarray(sol.z, np.float64),
                its=np.asarray(S["its"], np.int64),
                its_per_level=np.asarray(S["its"].sum(axis=1), np.int64),
                steps=np.array([S["steps_accepted"], S["steps_attempted"]],
                               np.int64),
                feas_its=(np.zeros((0, 0), np.int64) if F is None
                          else np.asarray(F["its"], np.int64)))


def zoo_reference(name, L, **kw) -> dict:
    """Record of the JAX x64 solve of ``mgbtpu.zoo.<name>`` on fem2d_P2 L."""
    import mgbtpu

    mg = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
    return solve_record(mgbtpu.mgb_solve(getattr(mgbtpu.zoo, name)(mg, **kw)))


def parabolic_reference(L, ts) -> dict:
    """``mgbtpu.parabolic_solve`` on fem2d_P2 L, p=1, over ``ts``: the states
    u (steps + 1, m, 3) and, under ``step<j>/``, each implicit step's solve
    record (captured around the solver's own ``mgb_solve`` calls)."""
    import mgbtpu
    import mgbtpu.solver.parabolic as P

    sols, solve = [], P.mgb_solve

    def recording(prob, **kw):
        sols.append(solve(prob, **kw))
        return sols[-1]

    P.mgb_solve = recording
    try:
        sol = mgbtpu.parabolic_solve(
            mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)), ts=ts, p=1.0)
    finally:
        P.mgb_solve = solve
    out = dict(u=np.stack(sol.u).astype(np.float64),
               ts=np.asarray(ts, np.float64))
    for j, s in enumerate(sols, 1):
        out.update({f"step{j}/{k}": v for k, v in solve_record(s).items()})
    return out


def flatten(records: dict) -> dict:
    """{prefix: record} -> one flat dict of arrays with "prefix/key" keys."""
    return {f"{p}/{k}": v for p, rec in records.items() for k, v in rec.items()}


def record_of(data, prefix) -> dict:
    """The record stored under ``prefix/`` in a loaded npz (or a dict)."""
    n = len(prefix) + 1
    return {k[n:]: data[k] for k in data.keys() if k.startswith(prefix + "/")}


def assert_same_record(fresh, stored):
    z = stored["z"]
    assert fresh["z"].shape == z.shape
    assert np.linalg.norm(fresh["z"] - z) <= 1e-10 * np.linalg.norm(z)
    for key in ("its", "its_per_level", "steps", "feas_its"):
        np.testing.assert_array_equal(fresh[key], stored[key])


def save(path, arrays: dict):
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {sorted(arrays)}")


def main_setup():
    """The JAX x64 CPU setup of a ``__main__`` that regenerates a file."""
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
