"""The stored JAX x64 yardstick of the PyTorch port's chip smoke run.

``mgbtpu_torch/data/ref_fem2d_p2_L5.npz`` holds the solution z, the Newton
iterations per level and per ramp step, the CG count and the accepted /
attempted ramp steps of a JAX x64 CPU solve of fem2d_P2, p=1, L=5.
``chip_smoke.py`` holds the port's card solve against it. This test re-runs
the JAX solve and checks that the file still matches, so the yardstick
cannot drift from the reference. Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_data.py
"""
import os
import sys

import numpy as np

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "mgbtpu_torch", "data", "ref_fem2d_p2_L5.npz")
L = 5


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


def test_reference_file_reproduces():
    ref = np.load(REF)
    fresh = jax_reference(int(ref["L"]))
    z_ref = ref["z"]
    assert fresh["z"].shape == z_ref.shape
    assert np.linalg.norm(fresh["z"] - z_ref) <= 1e-10 * np.linalg.norm(z_ref)
    np.testing.assert_array_equal(fresh["its_per_level"], ref["its_per_level"])
    np.testing.assert_array_equal(fresh["its"], ref["its"])
    np.testing.assert_array_equal(fresh["steps"], ref["steps"])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = jax_reference(L)
    np.savez_compressed(REF, **out)
    print(f"wrote {REF}: its {out['its_per_level'].tolist()}, "
          f"|z| {np.linalg.norm(out['z'])!r}")
