"""The stored JAX x64 yardsticks of the PyTorch port's fem2d_P2, p=1 card
solves.

``mgbtpu_torch/data/ref_fem2d_p2_L{4,5,6,7}.npz`` each hold the solution z,
the Newton iterations per level and per ramp step, the CG count and the
accepted / attempted ramp steps of a JAX x64 CPU solve of fem2d_P2, p=1,
at L. ``chip_smoke.py`` holds the port's card solve against L=5 (and
against L=4, 6 or 7 with ``--level``). The tier-1 cases check that each
record is whole and that what derived it is unchanged (its fingerprint,
``jax_references``); the ``slow`` tests re-run the JAX solve and check that
the file still matches, so the yardstick cannot drift from the reference
(L=5 about a minute of JAX x64 on one CPU, L=6 about two, L=7 about
twenty). Regenerate a file (and its fingerprint) with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_data.py [L ...]

(L=5 when no level is given).
"""
import os
import sys

import numpy as np
import pytest

from jax_references import DATA, assert_record_holds, write_fingerprint

REF = os.path.join(DATA, "ref_fem2d_p2_L5.npz")
L = 5
LEVELS = (4, 6, 7)


def ref_path(L):
    return os.path.join(DATA, f"ref_fem2d_p2_L{L}.npz")


def jax_reference(L):
    import mgbtpu

    prob = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
                           p=1.0)
    sol = mgbtpu.mgb_solve(prob)
    S = sol.SOL_main
    return dict(z=np.asarray(sol.z, np.float64),
                its=np.asarray(S["its"], np.int64),
                its_per_level=np.asarray(S["its"].sum(axis=1), np.int64),
                cg=np.asarray(S["cg"], np.int64),
                steps=np.array([S["steps_accepted"], S["steps_attempted"]],
                               np.int64),
                L=np.array(L))


def _holds(L, slow_test):
    ref = dict(np.load(ref_path(L)))
    assert int(ref["L"]) == L
    # 2 * 4^(L-1) triangles of 7 quadrature nodes, (u, s) a node
    assert_record_holds(os.path.basename(ref_path(L)), ref,
                        f"tests/test_torch_reference_data.py::{slow_test}",
                        z_shape=(14 * 4 ** (L - 1), 2), cg=True)


def _reproduces(L):
    ref = np.load(ref_path(L))
    fresh = jax_reference(int(ref["L"]))
    z_ref = ref["z"]
    assert fresh["z"].shape == z_ref.shape
    assert np.linalg.norm(fresh["z"] - z_ref) <= 1e-10 * np.linalg.norm(z_ref)
    np.testing.assert_array_equal(fresh["its_per_level"], ref["its_per_level"])
    np.testing.assert_array_equal(fresh["its"], ref["its"])
    np.testing.assert_array_equal(fresh["steps"], ref["steps"])


def test_reference_file_reproduces():
    """The L=5 record is whole and what derived it is unchanged."""
    _holds(L, "test_reference_file_rederives")


@pytest.mark.parametrize("level", LEVELS)
def test_level_record_reproduces(level):
    """The L=4, 6 and 7 records are whole and what derived them is
    unchanged."""
    _holds(level, f"test_level_record_rederives[{level}]")


@pytest.mark.slow
def test_reference_file_rederives():
    _reproduces(L)


@pytest.mark.slow
@pytest.mark.parametrize("level", LEVELS)
def test_level_record_rederives(level):
    _reproduces(level)


if __name__ == "__main__":
    from jax_references import main_setup

    main_setup()
    for level in [int(a) for a in sys.argv[1:]] or [L]:
        out = jax_reference(level)
        np.savez_compressed(ref_path(level), **out)
        write_fingerprint(os.path.basename(ref_path(level)))
        print(f"wrote {ref_path(level)}: its {out['its_per_level'].tolist()}, "
              f"|z| {np.linalg.norm(out['z'])!r}")
