#!/usr/bin/env python3
"""Device times of K3 ``panel_adj`` at the fem3d k=3 shapes, where its
bulk form runs, beside the bytes bound, the plain version and ``torch.mv``
on Gᵀ in CSR, with phase A and phase B timed apart, on one CUDA card.

    python3 tools/k3_form_times.py [ROOT ...] [--no-l5] [--sweep] [--tune]

Each ROOT (optional) is another tree, e.g. a parent commit unpacked with
``git archive`` into a gitignored directory: its ``mgbtpu_torch`` is loaded
beside this checkout's (``tools/k4_cluster_times.py``'s ``load_tree``),
and each call is timed in turns, the ROOTs' first (a, ..., b, b, ..., a;
the first ROOT is "a", this checkout "b"). Every tree's call must give
this checkout's bits (the bulk form keeps the staged form's order, and
phase B is the same kernel); this checkout's phase A in the bulk form and
in the staged form must give ``panel_adj_contrib_rows_plain``'s bits.

Shapes: the top level of fem3d k=3 L=4's main system (nD = 5, C = 128)
and of its phase-I system (nD = 8, C = 192), from the problem itself; the
same at L=5's size (N = 4,096 elements) on seeded panels whose columns
neighbouring elements share (``k4_cluster_times.seeded_level``). Each
prints one ``[k3]`` line: the call's device ms by tree in turns, phase A
in the staged and the bulk form in turns, each tree's phase A as its
C entry takes it, phase B (``adjoint_sum``), the plain version's and the
library's ms, and the bounds (bytes: the call, phase A, phase B), with K
(the most slots a column has) and the bulk form's layout (rows a stage,
stages, consumer threads, shared bytes a CTA, CTAs an SM). Before them,
``[ptxas]`` lines: each tree's phase-A kernels as ``-Xptxas -v`` reports
them (registers, stack, spills).

``--sweep``: phase A at every level shape of the fem3d k=3 L=2 to 5
systems (``chip_smoke.FEM3D_K3_C``, seeded panels) whose C is even (the
bulk form's), staged and bulk in turns: what the form rule
(``ADJ_BULK_MIN_N``, ``ADJ_BULK_MIN_ROWS`` in ``csrc/adjoint.cuh``) rests
on. ``--tune``: the bulk form under other rows a stage and stages
(``panel_adj_bulk_tune``; the order, so the bits, stay), in turns with
each other and the staged form, at the L=4 top-level shapes and at
L=5-sized seeded panels of each even C of the L=5 levels. ``--no-l5``
skips the L=5-sized shapes.
"""
import ctypes
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
import mgbtpu_torch.kernels.panel_adj  # noqa: E402
from k4_cluster_times import load_tree, seeded_level  # noqa: E402
from k6_gram_times import reps_for  # noqa: E402

PA = sys.modules["mgbtpu_torch.kernels.panel_adj"]   # the module
B = K._build
FAILED = []


def layout(nD, p, Cs):
    """The bulk form's (rows a stage, stages, consumer threads, shared
    bytes a CTA, CTAs an SM) at this shape on this card."""
    out = (ctypes.c_int * 5)()
    fn = B.launcher("panel_adj", [ctypes.c_int] * 3 + [ctypes.c_void_p],
                    "panel_adj_bulk_layout")
    B.check("panel_adj", fn(nD, p, Cs, out))
    return tuple(out)


def tune(rows, stages):
    B.launcher("panel_adj", [ctypes.c_int] * 2,
               "panel_adj_bulk_tune")(rows, stages)


def hold(name, out, ref, what):
    """Bits held, a miss recorded (the run goes on, and fails at its end)."""
    try:
        C.same_bits(name, out, ref, what)
    except RuntimeError as err:
        print(f"[k3] MISMATCH {err}", flush=True)
        FAILED.append(str(err))


def ms(fn):
    return C.device_ms(fn, reps_for(fn))[0]


def in_turns(fns):
    """{label: [ms, ms]} with the labels' calls timed a, ..., b, b, ..., a."""
    got = {label: [] for label, _ in fns}
    for label, fn in fns + fns[::-1]:
        got[label].append(ms(fn))
    return got


def phase_a(form):
    return lambda panels, Y: C.in_form(K.panel_adj_contrib, form, panels, Y)


def time_level(tag, lv, trees, smi, rng):
    dev = torch.device("cuda")
    nD, N, p, Cs = lv.panels.shape
    m, Kc = N * p, lv.inv.shape[1]
    Y = torch.as_tensor(rng.standard_normal((m, nD)), dtype=torch.float64,
                        device=dev)
    args = (lv.panels, lv.cols, lv.inv, Y, lv.n_J)
    rows = K.panel_adj_contrib_rows_plain(lv.panels, Y)
    staged, bulk = phase_a(1), phase_a(4)
    hold(f"panel_adj {tag} staged", staged(lv.panels, Y), rows,
         "its rows plain version")
    hold(f"panel_adj {tag} bulk", bulk(lv.panels, Y), rows,
         "its rows plain version")
    hold(f"panel_adj {tag} bulk", bulk(lv.panels, Y), bulk(lv.panels, Y),
         "a repeat call")
    out = K.panel_adj(*args)
    hold(f"panel_adj {tag} (b)", out,
         PA.adjoint_sum_ordered_plain(lv.inv, rows),
         "its rows plain version, then phase B's order")
    for label, KK in trees[:-1]:
        hold(f"panel_adj {tag} ({label})", KK.panel_adj(*args), out,
             "this checkout's call")
    C.compare(f"panel_adj {tag}", out, K.panel_adj_plain(*args))
    calls = in_turns([(label, (lambda KK=KK: KK.panel_adj(*args)))
                      for label, KK in trees])
    forms = in_turns([("staged", lambda: staged(lv.panels, Y)),
                      ("bulk", lambda: bulk(lv.panels, Y))])
    own = in_turns([(label, (lambda KK=KK: KK.panel_adj_contrib(lv.panels,
                                                                Y)))
                    for label, KK in trees])
    contrib = K.panel_adj_contrib(lv.panels, Y)
    phase_b = in_turns([(label, (lambda KK=KK: KK.adjoint_sum(
        lv.cols, lv.inv, contrib, lv.n_J))) for label, KK in trees])
    plain_ms = C.device_ms(lambda: K.panel_adj_plain(*args), 5)[0]
    GT, Yf = C.csr_of_panels(lv, transpose=True), Y.reshape(-1)
    C.compare(f"panel_adj {tag} library", torch.mv(GT, Yf),
              K.panel_adj_plain(*args))
    lib_ms = C.device_ms(lambda: torch.mv(GT, Yf), 20)[0]
    del GT
    f8 = 8
    b_call, by = C.bound_ms(f8 * (nD * N * p * Cs + N * Cs + m * nD
                                  + lv.n_J), 2 * nD * m * Cs)
    b_a, _ = C.bound_ms(f8 * (nD * N * p * Cs + m * nD + N * Cs),
                        2 * nD * m * Cs)
    b_b, _ = C.bound_ms(f8 * (lv.inv.numel() + N * Cs + lv.n_J), 0)
    print(f"[k3] {tag} (nD={nD}, N={N}, p={p}, C={Cs}, n_J={lv.n_J}, "
          f"K={Kc}): form by shape {PA.form(nD, N, p, Cs)}, bulk layout "
          f"{layout(nD, p, Cs)}; the call, device ms {calls}; phase A "
          f"{forms}, as each tree takes it {own}; phase B {phase_b}; plain "
          f"{plain_ms!r}, library {lib_ms!r}; bound: call {b_call!r} ({by}),"
          f" phase A {b_a!r}, phase B {b_b!r} on {smi}", flush=True)


def seeded_panels(nD, N, Cs, rng, dev, p=64):
    panels = torch.empty((nD, N, p, Cs), dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    panels.normal_(generator=g)
    Y = torch.randn((N * p, nD), dtype=torch.float64, device=dev,
                    generator=g)
    return panels, Y


def sweep(smi, rng):
    """Phase A, staged and bulk in turns, at every fem3d level shape whose
    C the bulk form takes."""
    dev = torch.device("cuda")
    for L in (2, 3, 4, 5):
        for nD, N, p, Cs in C.fem3d_k3_shapes(L):
            if Cs % 2:
                continue
            panels, Y = seeded_panels(nD, N, Cs, rng, dev)
            staged, bulk = phase_a(1), phase_a(4)
            hold(f"panel_adj L={L} {(nD, N, p, Cs)} bulk",
                 bulk(panels, Y), staged(panels, Y), "the staged form")
            got = in_turns([("staged", lambda: staged(panels, Y)),
                            ("bulk", lambda: bulk(panels, Y))])
            b_a, _ = C.bound_ms(8 * (nD * N * p * Cs + N * p * nD + N * Cs),
                                0)
            print(f"[k3 sweep] fem3d L={L} (nD, N, p, C) = "
                  f"{(nD, N, p, Cs)}: phase A device ms {got}, form by "
                  f"shape {PA.form(nD, N, p, Cs)}, bulk layout "
                  f"{layout(nD, p, Cs)}, bound {b_a!r} on {smi}",
                  flush=True)
            del panels, Y
    torch.cuda.empty_cache()


# (rows a stage, stages); (0, 0) the rule's
TUNES = [(0, 0), (4, 2), (8, 2), (16, 2), (32, 2), (8, 3), (16, 3)]


def tune_runs(levels, smi, rng):
    """The bulk form's phase A under other rows a stage and stages, in
    turns with each other and the staged form: at the L=4 top levels
    (``levels``) and at seeded L=5-sized panels of each even C of the L=5
    levels."""
    dev = torch.device("cuda")
    seeded = [(f"L=5-sized C={Cs}", nD, Cs) for nD, _, _, Cs in
              C.fem3d_k3_shapes(5) if Cs % 2 == 0]
    for tag, lv, nD, Cs in ([(tag, lv, None, None) for tag, lv in levels]
                            + [(tag, None, nD, Cs) for tag, nD, Cs in seeded]):
        if lv is None:
            panels, Y = seeded_panels(nD, 4096, Cs, rng, dev)
        else:
            panels = lv.panels
            Y = torch.as_tensor(rng.standard_normal(
                (panels.shape[1] * panels.shape[2], panels.shape[0])),
                dtype=torch.float64, device=dev)
        nD, N, p, Cs = panels.shape
        ref = phase_a(1)(panels, Y)

        def run(rows, stages):
            tune(rows, stages)
            try:
                return phase_a(4)(panels, Y)
            finally:
                tune(0, 0)

        fns = [("staged", lambda: phase_a(1)(panels, Y))]
        for rows, stages in TUNES:
            tune(rows, stages)
            key = f"{rows}/{stages} {layout(nD, p, Cs)}"
            tune(0, 0)
            hold(f"panel_adj {tag} bulk {key}", run(rows, stages), ref,
                 "the staged form")
            fns.append((key, (lambda r=rows, st=stages: run(r, st))))
        print(f"[k3 tune] {tag} (nD, N, p, C) = {(nD, N, p, Cs)}: phase A "
              f"device ms by rows a stage/stages (0/0 the rule's; layout: "
              f"rows, stages, consumer threads, shared bytes, CTAs an SM) "
              f"{in_turns(fns)} on {smi}", flush=True)
        del panels, Y
        torch.cuda.empty_cache()


def print_ptxas(label, kk):
    _, info = kk._build.PTXAS.get("panel_adj", (None, {}))
    for fn, rec in info.items():
        if "adjoint_contrib" in fn:
            print(f"[ptxas] {label} {fn}: {rec}")


def main():
    if not torch.cuda.is_available():
        sys.exit("k3_form_times: no CUDA device available")
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
        root.kernels.build_all(force=True)
        print_ptxas(label, root.kernels)
        trees.append((label, root.kernels))
    print(f"[tree] this checkout {HERE} (b)")
    K.build_all(force=True)
    print_ptxas("b", K)
    trees.append(("b", K))
    rng = np.random.default_rng(1705)
    prob = C.fem3d_problem(4)
    levels = [(tag, C.top_level_ops(M, tag, torch)) for tag, M in
              (("fem3d L=4", prob.M[0]), ("fem3d L=4 phase I", prob.M[1]))]
    del prob
    for tag, lv in levels:
        time_level(tag, lv, trees, smi, rng)
    if "--tune" in sys.argv:
        tune_runs(levels, smi, rng)
    del levels
    torch.cuda.empty_cache()
    if "--no-l5" not in sys.argv:
        dev = torch.device("cuda")
        for tag, nD, Cs in (("L=5-sized", 5, 128),
                            ("L=5-sized phase I", 8, 192)):
            time_level(tag, seeded_level(4096, nD, Cs, rng, dev), trees, smi,
                       rng)
            torch.cuda.empty_cache()
    if "--sweep" in sys.argv:
        sweep(smi, rng)
    if FAILED:
        sys.exit(f"k3_form_times: {len(FAILED)} bit checks failed")


if __name__ == "__main__":
    main()
