#!/usr/bin/env python3
"""Device times of K4 ``gram_matvec`` at the fem3d k=3 shapes, where its
cluster form runs, beside the bytes bound, the plain version and
``torch.mv`` on the assembled Hessian in CSR, on one CUDA card.

    python3 tools/k4_cluster_times.py [ROOT ...]

Each ROOT (optional) is another tree, e.g. a parent commit unpacked with
``git archive`` into a gitignored directory: its ``mgbtpu_torch`` is loaded
beside this checkout's (as ``mgbtpu_torch_root<i>``, its kernels built
under ROOT/build), and each call is timed in turns, the ROOTs' first (a,
..., b, b, ..., a; the first ROOT is "a", the others by their directory's
name, this checkout "b"). This checkout's call is held to the bits of
``gram_matvec_cluster_plain`` at the R its C entry picks, each ROOT's to
the plain version within ``chip_smoke.TOL_KERNEL``.

Shapes: the top level of fem3d k=3 L=4's main system (nD = 5, C = 128)
and of its phase-I system (nD = 8, C = 192), from the problem itself; the
same at L=5's size (N = 4,096 elements) on seeded panels and factors, a
level whose columns neighbouring elements share as a mesh's do. Each
prints one ``[k4]`` line: {tree: [ms, ms]} device ms in turns
(``chip_smoke.device_ms``), the R the entry picks and this checkout's time
at each R the card takes ({R: [ms, ms]}, in turns), the clusters the card
holds at once by R, the plain version's and the library's ms and the
bound. ``--no-l5`` skips the L=5-sized shapes.
"""
import os
import subprocess
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
import mgbtpu_torch.kernels.gram_matvec  # noqa: E402
from k6_gram_times import reps_for  # noqa: E402
from mgbtpu_torch.solver.levelops import inverse_incidence  # noqa: E402

GM = sys.modules["mgbtpu_torch.kernels.gram_matvec"]   # the module


def load_tree(root, name):
    """ROOT's ``mgbtpu_torch``, loaded as ``name``."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "mgbtpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.kernels")
    return mod


class Level:
    """The panel operators ``chip_smoke.gram_matvec_phase`` reads."""

    def __init__(self, panels, cols, inv, n_J):
        self.panels, self.cols, self.inv, self.n_J = panels, cols, inv, n_J


def seeded_level(N, nD, Cs, rng, dev, p=64):
    """N elements of p nodes, element e's slots the columns 90 e + 3 c
    (mod n_J = 90 N): neighbouring elements share columns."""
    n_J = 90 * N
    cols = np.sort((90 * np.arange(N)[:, None] + 3 * np.arange(Cs)) % n_J,
                   axis=1)
    panels = torch.empty((nD, N, p, Cs), dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    panels.normal_(generator=g)
    return Level(panels, torch.as_tensor(cols, device=dev),
                 torch.as_tensor(inverse_incidence(cols, n_J), device=dev),
                 n_J)


def set_r(R):
    GM._R = R
    GM._FORM = 2 if R else 0


def time_level(tag, lv, trees, smi, rng):
    dev = torch.device("cuda")
    nD, N, p, Cs = lv.panels.shape
    m = N * p
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    Ln = torch.randn((m, nD, nD), dtype=torch.float64, device=dev,
                     generator=g).tril_()
    v = torch.randn(lv.n_J, dtype=torch.float64, device=dev, generator=g)
    args = (lv.panels, lv.cols, lv.inv, Ln, v)
    ref = K.gram_matvec_plain(*args)
    R = GM.cluster_size(nD, N, p, Cs)
    for label, KK in trees:
        out = KK.gram_matvec(*args)
        if label == "b":
            C.same_bits(f"gram_matvec {tag} (b)", out,
                        K.gram_matvec_cluster_plain(*args, R),
                        f"its cluster plain version (R = {R})")
        C.compare(f"gram_matvec {tag} ({label})", out, ref)
    got = {label: [] for label, _ in trees}
    fns = [(label, (lambda KK=KK: KK.gram_matvec(*args)))
           for label, KK in trees]
    for label, fn in fns + fns[::-1]:
        got[label].append(C.device_ms(fn, reps_for(fn))[0])
    taken = [r for r in (1, 2, 4, 8) if GM.cluster_size(nD, N, p, Cs, r)]
    by_r = {r: [] for r in taken}
    for r in taken + taken[::-1]:
        set_r(r)
        try:
            C.same_bits(f"gram_matvec {tag} R={r}", K.gram_matvec(*args),
                        K.gram_matvec_cluster_plain(*args, r),
                        f"its cluster plain version (R = {r})")
            fn = lambda: K.gram_matvec(*args)  # noqa: E731
            by_r[r].append(C.device_ms(fn, reps_for(fn))[0])
        finally:
            set_r(0)
    occ = {r: GM.cluster_occupancy(nD, p, Cs, r) for r in (1, 2, 4, 8)}
    plain_ms = C.device_ms(lambda: K.gram_matvec_plain(*args), 5)[0]
    H = C.hessian_csr(lv, Ln)
    C.compare(f"gram_matvec {tag} library", torch.mv(H, v), ref)
    lib_ms = C.device_ms(lambda: torch.mv(H, v), 20)[0]
    del H
    bnd, by = C.bound_ms(8 * (nD * N * p * Cs + N * Cs
                              + m * nD * (nD + 1) // 2 + 2 * lv.n_J),
                         4 * nD * m * Cs + 4 * m * nD * nD)
    print(f"[k4] {tag} (nD={nD}, N={N}, p={p}, C={Cs}, n_J={lv.n_J}, "
          f"K={lv.inv.shape[1]}): device ms {got}; R by shape {R}, by R "
          f"{by_r}; clusters held by R {occ}; plain {plain_ms!r}, library "
          f"{lib_ms!r}, bound {bnd!r} ({by}) on {smi}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_cluster_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    trees = []
    for i, path in enumerate(args):
        root = load_tree(path, f"mgbtpu_torch_root{i}")
        label = "a" if i == 0 else os.path.basename(os.path.normpath(path))
        print(f"[tree] ROOT {os.path.abspath(path)} ({label})")
        root.kernels.build_all()
        trees.append((label, root.kernels))
    print(f"[tree] this checkout {HERE} (b)")
    K.build_all()
    trees.append(("b", K))
    rng = np.random.default_rng(1604)
    prob = C.fem3d_problem(4)
    for tag, M in (("fem3d L=4", prob.M[0]), ("fem3d L=4 phase I",
                                              prob.M[1])):
        time_level(tag, C.top_level_ops(M, tag, torch), trees, smi, rng)
    del prob
    if "--no-l5" not in sys.argv:
        dev = torch.device("cuda")
        for tag, nD, Cs in (("L=5-sized", 5, 128),
                            ("L=5-sized phase I", 8, 192)):
            time_level(tag, seeded_level(4096, nD, Cs, rng, dev), trees, smi,
                       rng)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
