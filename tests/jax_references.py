"""JAX x64 yardsticks of the PyTorch port's card runs.

``chip_smoke.py`` holds the port's card solves against solve records of the
JAX package, stored in ``mgbtpu_torch/data/*.npz``: the solution, the Newton
iterations per level and per ramp step of the main ramp and of phase I, and
the accepted/attempted ramp steps. The ``tests/test_torch_reference_*.py``
files write them from their ``__main__`` and re-derive them from JAX in
tests marked ``slow``; this module holds what they share (not a test
module).

A record's tier-1 case checks, in well under a second, that the record is
whole (``assert_whole``) and that nothing its derivation reads has changed
since it was written: the record's entry in
``mgbtpu_torch/data/ref_fingerprint.json`` (``write_fingerprint``, called
by the same ``__main__`` that writes the record) is the sha256 of every
source file of ``mgbtpu/``, of this module and ``tests/conftest.py`` (and
of the files a record names besides), with the jax, jaxlib and numpy
versions (``fingerprint``). A mismatch names the slow test to run.
"""
import contextlib
import functools
import hashlib
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "mgbtpu_torch", "data")
FINGERPRINT = os.path.join(DATA, "ref_fingerprint.json")


def _sources(extra):
    """Every file under ``mgbtpu/`` but the build outputs ``.gitignore``
    lists (bytecode, the native helper's shared library), this module,
    ``tests/conftest.py``, then ``extra`` (paths from the repo root)."""
    out = []
    for d, dirs, files in os.walk(os.path.join(ROOT, "mgbtpu")):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.join(d, f) for f in sorted(files)
                if not f.endswith((".pyc", ".so"))]
    return sorted(out) + [os.path.join(ROOT, f) for f in (
        "tests/jax_references.py", "tests/conftest.py", *extra)]


@functools.lru_cache(maxsize=None)
def fingerprint(extra=()) -> dict:
    """What derives a record: the sha256 over each source file's path and
    contents (``_sources``) and the jax, jaxlib and numpy versions, with
    those versions and ``extra`` beside it."""
    import jax
    import jaxlib

    versions = {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                "numpy": np.__version__}
    h = hashlib.sha256()
    for path in _sources(extra):
        with open(path, "rb") as f:
            body = hashlib.sha256(f.read()).hexdigest()
        h.update(f"{os.path.relpath(path, ROOT)} {body}\n".encode())
    for k, v in versions.items():
        h.update(f"{k} {v}\n".encode())
    return dict(sha256=h.hexdigest(), extra=list(extra), **versions)


def _fingerprints() -> dict:
    if not os.path.exists(FINGERPRINT):
        return {}
    with open(FINGERPRINT) as f:
        return json.load(f)


def write_fingerprint(key, extra=()):
    """Store the fingerprint of record ``key`` (its file name, with
    ``/<prefix>`` for one record of a shared file), as derived now."""
    data = _fingerprints()
    data[key] = fingerprint(tuple(extra))
    with open(FINGERPRINT, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def assert_fingerprint(key, slow_test, extra=()):
    """The stored fingerprint of record ``key`` is today's; on a mismatch,
    name what changed and the slow test that re-derives the record."""
    stored = _fingerprints().get(key)
    now = fingerprint(tuple(extra))
    if stored == now:
        return
    what = ("no fingerprint is stored" if stored is None else ", ".join(
        f"{k} {stored.get(k)!r} -> {now[k]!r}" for k in now
        if stored.get(k) != now[k]))
    raise AssertionError(
        f"{key}: what derived the record changed ({what}). Run the JAX "
        f"re-derivation, `JAX_PLATFORMS=cpu python -m pytest -m slow "
        f"'{slow_test}'`; if it passes, the record's __main__ rewrites the "
        f"record and its fingerprint.")


def assert_whole(rec, z_shape=None, cg=False):
    """A stored solve record is whole: its keys, consistent shapes, finite
    z (of ``z_shape`` where given, a dimension None for any), at least one
    Newton iteration and one accepted step, and with ``cg`` a CG count of
    one a ramp step, at least one in all."""
    for key in ("z", "its", "its_per_level", "steps"):
        assert key in rec, f"missing {key}"
    z, its, steps = rec["z"], rec["its"], rec["steps"]
    assert z.dtype == np.float64 and z.ndim == 2 and z.size > 0
    assert np.isfinite(z).all()
    if z_shape is not None:
        assert all(w is None or w == n for w, n in zip(z_shape, z.shape)), \
            (z.shape, z_shape)
    assert its.ndim == 2 and its.dtype.kind == "i" and (its >= 0).all()
    np.testing.assert_array_equal(rec["its_per_level"], its.sum(axis=1))
    assert its.sum() >= 1
    assert steps.shape == (2,) and 1 <= steps[0] <= steps[1]
    if "feas_its" in rec:
        f = rec["feas_its"]
        assert f.ndim == 2 and (f >= 0).all()
        assert f.size == 0 or (f.shape[0] == its.shape[0] and f.sum() >= 1)
    if cg:
        c = rec["cg"]
        assert c.shape == (its.shape[1],) and (c >= 0).all() and c.sum() >= 1


def assert_record_holds(key, rec, slow_test, extra=(), **whole):
    """The tier-1 case of a stored record: ``assert_fingerprint`` and
    ``assert_whole(rec, **whole)``."""
    assert_fingerprint(key, slow_test, extra)
    assert_whole(rec, **whole)


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


def zoo_l3_holds(name):
    """``name``'s record in ``ref_zoo_L3.npz`` is whole and its fingerprint
    holds (one ``tests/test_torch_reference_zoo_l3_<name>.py`` a
    problem)."""
    assert_record_holds(
        f"ref_zoo_L3.npz/{name}", record_of(np.load(ZOO_L3), name),
        f"tests/test_torch_reference_zoo_l3_{name}.py::"
        "test_zoo_l3_reference_rederives", z_shape=(224, None))


def zoo_l3_reproduces(name):
    """``zoo_reference(name, 3)`` equals its record in ``ref_zoo_L3.npz``."""
    assert_same_record(zoo_reference(name, 3),
                       record_of(np.load(ZOO_L3), name))


def zoo_l3_update(name):
    """Rewrite ``name``'s record in ``ref_zoo_L3.npz`` and its fingerprint
    (a file's ``__main__``)."""
    main_setup()
    update(ZOO_L3, {name: zoo_reference(name, 3)})
    write_fingerprint(f"ref_zoo_L3.npz/{name}")


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
