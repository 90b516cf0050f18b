#!/usr/bin/env python3
"""Device times of K6 ``node_barrier`` on two_sided_obstacle's piece table
(a power cone and a linear block) at the fem2d_P2 L=5 and L=7 top-level
shapes, on one CUDA card.

    python3 tools/k6_obstacle_times.py [ROOT]

ROOT (default: this checkout) is the tree whose ``mgbtpu_torch`` and
``chip_smoke.py`` are used, so that two versions of the kernel can be
timed in one call: run it over each tree in turn (A, B, B, A). Builds
``node_barrier.cu`` alone and prints its nvcc seconds and ptxas report,
then, at each level, holds the six calls of ``chip_smoke.k6_calls``
(modes 0/1/2, barrier and phase-I form) bitwise against the plain version
and times each twice (``chip_smoke.k6_time``: ``[time]`` and ``[bound]``
lines)."""
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch import (amg, assemble, fem2d_P2, intersect,  # noqa: E402
                          subdivide)
from mgbtpu_torch.convex import (convex_euclidian_power,  # noqa: E402
                                 convex_linear)
from mgbtpu_torch.kernels import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_obstacle_times: no CUDA device available")
    t0 = time.time()
    _build.build_all(("node_barrier",), force=True)
    print(f"[build] node_barrier.cu alone in {time.time() - t0!r} s")
    for fn, r in sorted(_build.PTXAS["node_barrier"][1].items()):
        print(f"[ptxas] {fn}: {r}")
    for L in (5, 7):
        mg = amg(subdivide(fem2d_P2(), L))
        M = assemble(mg, p=1.0, device="cuda").M[0]
        m, w = M.n_nodes, np.asarray(M.w, np.float64)
        rng = np.random.default_rng(100 + L)
        obstacle = intersect(
            mg, convex_euclidian_power(mg, idx=(1, 2, 3), p=2.0),
            convex_linear(mg, idx=(0,),
                          A=lambda x: np.array([[1.0], [-1.0]]),
                          b=lambda x: np.array([0.1, 1.0])))
        Dz = torch.as_tensor(C._obstacle_rows(m, rng), dtype=torch.float64,
                             device="cuda")
        calls = C.k6_calls(obstacle, Dz, 2, w, torch, K, rng)
        C.k6_check(f"L={L} obstacle", calls, K)
        for rep in range(2):
            for label, call in calls.items():
                C.k6_time(f"L={L} obstacle {label} rep {rep}", call, K)


if __name__ == "__main__":
    main()
