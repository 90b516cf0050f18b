#!/usr/bin/env python3
"""Device times of K1 ``panel_fwd`` and K3 ``panel_adj`` at one element of
many rows (the spectral levels), in their spread forms and in the forms
that also take the shape, beside their plain versions, one library call
and the bytes bound, on one CUDA card.

    python3 tools/spread_times.py [ROOT]

ROOT (optional) is a second tree, e.g. a parent commit unpacked with
``git archive`` into a gitignored directory: its ``mgbtpu_torch`` is loaded
beside this checkout's (as ``mgbtpu_torch_root``, its kernels built under
ROOT/build), and its spread forms are timed in turns with this
checkout's, ROOT's first: (a, b, b, a). The two trees' spread forms may
sum in different orders, so they are held to each other by tolerance
(1e-12 relative, ``chip_smoke.compare``), not by bits; this checkout's
spread forms are held to the bits of their split plain versions where the
checkout has them.

Shapes (nD, N = 1, p, C), seeded panels: the top levels of spectral1d
n = 128 (3, 1, 128, 254), spectral2d n = 16 (4, 1, 256, 452) and n = 32
(4, 1, 1024, 1924), one row of spectral2d n = 32's nodes (1, 1, 1024,
1924) and its parabolic phase-I rows (9, 1, 1024, 3972). Timed: K1's call
(this checkout's wide form 2 too, for p*nD <= 1,024); K3's phase A alone
(``panel_adj_contrib``; this checkout's staged phase A 1 too, for
p*nD <= 4,096) and K3's whole call (phase B included). The library calls
are ``torch.addmv`` (K1, with Dz0) and ``torch.mv`` (K3's per-slot sums,
like phase A) on the element's dense (nD*p, C) panel view. Each line is a
``[spread]`` line, its times {label: [ms, ms]} in turns. A ``[kernels]``
line splits this checkout's spread calls and the library calls by kernel:
{kernel name: device microseconds a call}, from torch.profiler.
"""
import importlib
import importlib.util
import os
import subprocess
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch.solver.levelops import inverse_incidence  # noqa: E402

SHAPES = [(3, 128, 254), (4, 256, 452), (1, 1024, 1924), (4, 1024, 1924),
          (9, 1024, 3972)]
SPREAD, WIDE, STAGED = 3, 2, 1


def load_tree(root):
    """ROOT's ``mgbtpu_torch.kernels``, loaded as ``mgbtpu_torch_root``."""
    name = "mgbtpu_torch_root"
    pkg = os.path.join(os.path.abspath(root), "mgbtpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels")


def time_turns(tag, variants, reps=100):
    """``variants`` [(label, fn)] timed in turns (forward, then backward),
    each output held to the first's to 1e-12 relative. Returns {label:
    [ms, ms]}."""
    outs = [fn() for _, fn in variants]
    for (label, _), o in zip(variants[1:], outs[1:]):
        C.compare(f"{tag} {label} against {variants[0][0]}", o, outs[0])
    got = {label: [] for label, _ in variants}
    for label, fn in variants + variants[::-1]:
        got[label].append(C.device_ms(fn, reps)[0])
    return got


def kernel_us(fn, n=20):
    """{kernel name: device microseconds a call} over n profiled calls of
    fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def main():
    if not torch.cuda.is_available():
        sys.exit("spread_times: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    KR = None
    if len(sys.argv) > 1:
        KR = load_tree(sys.argv[1])
        print(f"[tree] ROOT {os.path.abspath(sys.argv[1])} (a), this "
              f"checkout {HERE} (b)")
        KR.build_all(("panel_fwd", "panel_adj"))
    K.build_all(("panel_fwd", "panel_adj"))
    split = hasattr(K, "panel_fwd_split_plain")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    for nD, p, Cw in SHAPES:
        n_J = Cw + 37
        cols = np.sort(rng.choice(n_J, Cw, replace=False))[None, :]
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        panels = t(rng.standard_normal((nD, 1, p, Cw)))
        colt, inv = t(cols), t(inverse_incidence(cols, n_J))
        s, dz0 = t(rng.standard_normal(n_J)), t(rng.standard_normal((p, nD)))
        Y = t(rng.standard_normal((p, nD)))
        fargs, aargs = (panels, colt, s, dz0), (panels, colt, inv, Y, n_J)
        tag = f"(nD, N, p, C) = ({nD}, 1, {p}, {Cw})"
        if split:
            C.same_bits(f"panel_fwd {tag}",
                        C.in_form(K.panel_fwd, SPREAD, *fargs),
                        K.panel_fwd_split_plain(*fargs),
                        "its split plain version")
            C.same_bits(f"panel_adj {tag} phase A",
                        C.in_form(K.panel_adj_contrib, SPREAD, panels, Y),
                        K.panel_adj_contrib_split_plain(panels, Y),
                        "its split plain version")

        def forms(fn, codes, args):
            return [(label, lambda fn=fn, c=c: C.in_form(fn, c, *args))
                    for label, c in codes]

        fwd, phase_a, whole = [], [], []
        if KR is not None:
            fwd += forms(KR.panel_fwd, [("a spread", SPREAD)], fargs)
            phase_a += forms(KR.panel_adj_contrib, [("a spread", SPREAD)],
                             (panels, Y))
            whole += forms(KR.panel_adj, [("a spread", SPREAD)], aargs)
        fwd += forms(K.panel_fwd, [("b spread", SPREAD)]
                     + ([("b wide", WIDE)] if p * nD <= 1024 else []), fargs)
        phase_a += forms(K.panel_adj_contrib, [("b spread", SPREAD)]
                         + ([("b staged", STAGED)] if p * nD <= 4096
                            else []), (panels, Y))
        whole += forms(K.panel_adj, [("b spread", SPREAD)], aargs)
        t1 = time_turns(f"panel_fwd {tag}", fwd)
        ta = time_turns(f"panel_adj {tag} phase A", phase_a)
        tw = time_turns(f"panel_adj {tag}", whole)
        P, c0 = panels.reshape(nD * p, Cw), colt[0]
        dzf = dz0.t().contiguous().reshape(-1)
        Yf = Y.t().contiguous().reshape(-1)
        lib1 = C.device_ms(lambda: torch.addmv(dzf, P, s[c0]), 100)[0]
        lib3 = C.device_ms(lambda: torch.mv(P.t(), Yf), 100)[0]
        pl1 = C.device_ms(lambda: K.panel_fwd_plain(*fargs), 50)[0]
        pl3 = C.device_ms(lambda: K.panel_adj_plain(*aargs), 50)[0]
        b1, _ = C.bound_ms(8 * (nD * p * Cw + Cw + n_J + 2 * p * nD), 0)
        ba, _ = C.bound_ms(8 * (nD * p * Cw + p * nD + Cw), 0)
        b3, _ = C.bound_ms(8 * (nD * p * Cw + Cw + p * nD + n_J), 0)
        for label, fn in [("panel_fwd b spread", dict(fwd)["b spread"]),
                          ("panel_adj phase A b spread",
                           dict(phase_a)["b spread"]),
                          ("panel_adj b spread", dict(whole)["b spread"]),
                          ("torch.addmv",
                           lambda: torch.addmv(dzf, P, s[c0])),
                          ("torch.mv", lambda: torch.mv(P.t(), Yf))]:
            print(f"[kernels] {label} {tag}: {kernel_us(fn)} on {smi}")
        print(f"[spread] panel_fwd {tag}: device ms {t1}, plain {pl1!r}, "
              f"torch.addmv {lib1!r}, bound {b1!r} (bytes) on {smi}")
        print(f"[spread] panel_adj {tag} phase A: device ms {ta}, "
              f"torch.mv {lib3!r}, bound {ba!r} (bytes) on {smi}")
        print(f"[spread] panel_adj {tag}: device ms {tw}, plain {pl3!r}, "
              f"bound {b3!r} (bytes) on {smi}")
        del panels, P


if __name__ == "__main__":
    main()
