"""The stored JAX x64 yardsticks of the port's card solves of the spectral
discretizations, p=1 (held against by ``chip_smoke.py``), re-derived from
JAX in the ``slow`` tests so they cannot drift from the reference (the
tier-1 cases check that each record is whole and that what derived it,
``tests/test_golden.py`` included, is unchanged: its fingerprint,
``jax_references``):

- ``mgbtpu_torch/data/ref_spectral.npz``: spectral1d n=128 (7 levels, 128
  nodes), the golden elliptic cases spectral1d n=5 and spectral2d n=5 of
  ``tests/test_golden.py``, and its parabolic spectral1d n=4 and
  spectral2d n=4 cases (h=0.5: the states u and each implicit step's
  record);
- ``mgbtpu_torch/data/ref_spectral2d_n32.npz``: spectral2d n=32 (5 levels,
  1,024 nodes, n_J = 1,924 at the top), which takes about a minute of JAX
  x64 on one CPU and is marked ``slow`` (outside tier-1).

Every level of a spectral solve is dense, so the records hold no CG count.
The four golden cases also hold their ``tests/test_golden.py`` vector
(``gold``), read from that file's own test (``golden``), so that
``chip_smoke.py``, which cannot import the JAX package's tests, holds the
card to it. Regenerate both files (and their fingerprints) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_spectral.py
"""
import functools
import os
import types

import numpy as np
import pytest

import test_golden
from jax_references import (DATA, assert_record_holds, assert_same_record,
                            parabolic_record, record_of, recorded_steps, save,
                            solve_record, spectral_reference, update,
                            write_fingerprint)

REF = os.path.join(DATA, "ref_spectral.npz")
REF_N32 = os.path.join(DATA, "ref_spectral2d_n32.npz")
ELLIPTIC = {"spectral1d_n128": ("spectral1d", 128),
            "spectral1d_n5": ("spectral1d", 5),
            "spectral2d_n5": ("spectral2d", 5)}
PARABOLIC = {"parabolic_spectral1d_n4": ("spectral1d", 4, 0.5),
             "parabolic_spectral2d_n4": ("spectral2d", 4, 0.5)}
GOLDEN = {"spectral1d_n5": "test_spectral1d_p1",
          "spectral2d_n5": "test_spectral2d_p1",
          "parabolic_spectral1d_n4": "test_parabolic_spectral1d",
          "parabolic_spectral2d_n4": "test_parabolic_spectral2d"}


def golden(test):
    """The vector that ``tests/test_golden.py::<test>`` holds its JAX solve
    to, read back from the test itself: its solve's z (or stacked states u)
    less the difference its assertion takes the norm of (exact: the two
    agree to 1e-6). Returns (vector, the test's solution)."""
    seen = {}

    class _Numpy:   # numpy, recording the argument of linalg.norm
        linalg = types.SimpleNamespace(norm=lambda x, *a, **kw: (
            seen.__setitem__("diff", np.asarray(x)),
            np.linalg.norm(x, *a, **kw))[1])

        def __getattr__(self, name):
            return getattr(np, name)

    def recorded(fn):
        def run(*a, **kw):
            seen["sol"] = fn(*a, **kw)
            return seen["sol"]
        return run

    saved = {k: getattr(test_golden, k)
             for k in ("np", "mgb_solve", "parabolic_solve")}
    test_golden.np = _Numpy()
    test_golden.mgb_solve = recorded(saved["mgb_solve"])
    test_golden.parabolic_solve = recorded(saved["parabolic_solve"])
    try:
        getattr(test_golden, test)()
    finally:
        for k, v in saved.items():
            setattr(test_golden, k, v)
    sol = seen["sol"]
    out = np.stack(sol.u) if hasattr(sol, "u") else np.asarray(sol.z)
    return out - seen["diff"], sol


@functools.lru_cache(maxsize=None)
def fresh(name):
    """The JAX x64 record of case ``name``; a golden case's from one run of
    its ``tests/test_golden.py`` test (the same solve), with the vector
    that test holds it to (``gold``)."""
    if name not in GOLDEN:
        return spectral_reference(*ELLIPTIC[name])
    with recorded_steps() as steps:
        gold, sol = golden(GOLDEN[name])
    if name in PARABOLIC:
        _, n, h = PARABOLIC[name]
        rec = dict(parabolic_record(sol, steps), n=np.array(n),
                   h=np.array(h))
    else:
        rec = dict(solve_record(sol), n=np.array(ELLIPTIC[name][1]))
    return dict(rec, gold=gold)


def records():
    return {k: fresh(k) for k in [*ELLIPTIC, *PARABOLIC]}


# the golden vectors come from tests/test_golden.py's own tests
SOURCES = ("tests/test_golden.py",)


def _holds(rec, slow_test, **whole):
    assert_record_holds(
        "ref_spectral.npz", rec,
        f"tests/test_torch_reference_spectral.py::{slow_test}", SOURCES,
        **whole)


def _nodes(kind, n):
    return n if kind == "spectral1d" else n * n


@pytest.mark.parametrize("name", list(ELLIPTIC))
def test_spectral_reference_reproduces(name):
    """The record is whole and what derived it is unchanged."""
    kind, n = ELLIPTIC[name]
    stored = record_of(np.load(REF), name)
    assert int(stored["n"]) == n
    _holds(stored, f"test_spectral_reference_rederives[{name}]",
           z_shape=(_nodes(kind, n), 2))


@pytest.mark.parametrize("name", list(PARABOLIC))
def test_parabolic_spectral_reference_reproduces(name):
    """Both implicit steps' records are whole, each the state it gives,
    and what derived them is unchanged."""
    kind, n, h = PARABOLIC[name]
    stored = record_of(np.load(REF), name)
    assert int(stored["n"]) == n and float(stored["h"]) == h
    u = stored["u"]
    assert u.shape == (3, _nodes(kind, n), 3) and np.isfinite(u).all()
    for j in range(1, u.shape[0]):
        step = record_of(stored, f"step{j}")
        _holds(step, f"test_parabolic_spectral_reference_rederives[{name}]",
               z_shape=u.shape[1:])
        np.testing.assert_array_equal(step["z"], u[j])


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_vectors_stored(name):
    """The stored x64 solve is within ``tests/test_golden.py``'s 1e-6 of
    the stored ``gold``, and what derived both is unchanged."""
    stored = record_of(np.load(REF), name)
    _holds(record_of(stored, "step1") if "u" in stored else stored,
           f"test_golden_vectors_rederive[{name}]")
    if name == "parabolic_spectral2d_n4":
        np.testing.assert_array_equal(stored["gold"],
                                      test_golden.GOLD_spectral2d)
    x = stored["u"] if "u" in stored else stored["z"]
    assert np.linalg.norm(x - stored["gold"]) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("name", list(ELLIPTIC))
def test_spectral_reference_rederives(name):
    stored = record_of(np.load(REF), name)
    assert_same_record(fresh(name), stored)
    assert int(stored["n"]) == ELLIPTIC[name][1]


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PARABOLIC))
def test_parabolic_spectral_reference_rederives(name):
    stored = record_of(np.load(REF), name)
    rec = fresh(name)
    u = stored["u"]
    assert rec["u"].shape == u.shape
    assert np.linalg.norm(rec["u"] - u) <= 1e-10 * np.linalg.norm(u)
    for j in range(1, u.shape[0]):
        assert_same_record(record_of(rec, f"step{j}"),
                           record_of(stored, f"step{j}"))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_vectors_rederive(name):
    """The stored ``gold`` is ``tests/test_golden.py``'s vector, and the
    stored x64 solve is within that file's 1e-6 of it."""
    stored = record_of(np.load(REF), name)
    gold = fresh(name)["gold"]
    np.testing.assert_array_equal(stored["gold"], gold)
    if name == "parabolic_spectral2d_n4":
        np.testing.assert_array_equal(gold, test_golden.GOLD_spectral2d)
    x = stored["u"] if "u" in stored else stored["z"]
    assert np.linalg.norm(x - gold) < 1e-6


@pytest.mark.slow
def test_spectral2d_n32_reference_reproduces():
    assert_same_record(spectral_reference("spectral2d", 32),
                       dict(np.load(REF_N32)))


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    update(REF, records())
    write_fingerprint(os.path.basename(REF), SOURCES)
    save(REF_N32, spectral_reference("spectral2d", 32))
