"""JAX x64 yardsticks of the PyTorch port's card runs.

``chip_smoke.py`` holds the port's card solves against solve records of the
JAX package, stored in ``mgbtpu_torch/data/*.npz``: the solution, the Newton
iterations per level and per ramp step of the main ramp and of phase I, and
the accepted/attempted ramp steps. The ``tests/test_torch_reference_*.py``
files re-derive them from JAX in tier-1 and write them from their
``__main__``; this module holds what they share (not a test module).
"""
import contextlib
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


def p_laplace_reference(geometry, L, p=1.0) -> dict:
    """Record of the JAX x64 p-Laplace solve (the default f, g and D) on
    ``mgbtpu.subdivide(mgbtpu.<geometry>(), L)``, with its CG iterations
    per ramp step and L."""
    import mgbtpu

    mg = mgbtpu.amg(mgbtpu.subdivide(getattr(mgbtpu, geometry)(), L))
    sol = mgbtpu.mgb_solve(mgbtpu.assemble(mg, p=p))
    return dict(solve_record(sol), cg=np.asarray(sol.SOL_main["cg"], np.int64),
                L=np.array(L))


def zoo_reference(name, L, **kw) -> dict:
    """Record of the JAX x64 solve of ``mgbtpu.zoo.<name>`` on fem2d_P2 L."""
    import mgbtpu

    mg = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
    return solve_record(mgbtpu.mgb_solve(getattr(mgbtpu.zoo, name)(mg, **kw)))


ZOO_L3 = os.path.join(DATA, "ref_zoo_L3.npz")


def zoo_l3_reproduces(name):
    """``zoo_reference(name, 3)`` equals its record in ``ref_zoo_L3.npz``
    (one ``tests/test_torch_reference_zoo_l3_<name>.py`` a problem)."""
    assert_same_record(zoo_reference(name, 3),
                       record_of(np.load(ZOO_L3), name))


def zoo_l3_update(name):
    """Rewrite ``name``'s record in ``ref_zoo_L3.npz`` (a file's
    ``__main__``)."""
    main_setup()
    update(ZOO_L3, {name: zoo_reference(name, 3)})


def spectral_reference(kind, n) -> dict:
    """Record of the JAX x64 p=1 solve (the default f, g and D) on
    ``mgbtpu.amg(mgbtpu.<kind>(n=n))``, kind spectral1d or spectral2d:
    every level is dense (one element), so there is no CG count."""
    import mgbtpu

    mg = mgbtpu.amg(getattr(mgbtpu, kind)(n=n))
    return dict(solve_record(mgbtpu.mgb_solve(mgbtpu.assemble(mg, p=1.0))),
                n=np.array(n))


@contextlib.contextmanager
def recorded_steps():
    """While active, each implicit step's ``mgb_solve`` solution of
    ``mgbtpu.parabolic_solve`` is appended to the yielded list."""
    import mgbtpu.solver.parabolic as P

    sols, solve = [], P.mgb_solve

    def recording(prob, **kw):
        sols.append(solve(prob, **kw))
        return sols[-1]

    P.mgb_solve = recording
    try:
        yield sols
    finally:
        P.mgb_solve = solve


def parabolic_record(sol, steps) -> dict:
    """A ``parabolic_solve``'s states u (steps + 1, m, 3) and, under
    ``step<j>/``, each implicit step's solve record (``recorded_steps``)."""
    out = dict(u=np.stack(sol.u).astype(np.float64))
    for j, s in enumerate(steps, 1):
        out.update({f"step{j}/{k}": v for k, v in solve_record(s).items()})
    return out


def parabolic_reference(L, ts) -> dict:
    """``mgbtpu.parabolic_solve`` on fem2d_P2 L, p=1, over ``ts``
    (``parabolic_record``), with ``ts``."""
    import mgbtpu

    mg = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
    with recorded_steps() as steps:
        sol = mgbtpu.parabolic_solve(mg, ts=ts, p=1.0)
    return dict(parabolic_record(sol, steps), ts=np.asarray(ts, np.float64))


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


def update(path, records: dict):
    """Write ``records`` ({prefix: record}) into the npz at ``path``, keeping
    its records under other prefixes."""
    keep = {}
    if os.path.exists(path):
        with np.load(path) as old:
            keep = {k: old[k] for k in old.files
                    if k.split("/", 1)[0] not in records}
    save(path, {**keep, **flatten(records)})


def main_setup():
    """The JAX x64 CPU setup of a ``__main__`` that regenerates a file."""
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
