#!/usr/bin/env python3
"""The card tests of K4's cluster form, K6's group kernels and K5a's and
K5b's large forms under NVIDIA's ``compute-sanitizer``, one CUDA card.

    python3 tools/sanitize_kernels.py [--probe] [--timeout SECONDS]
                                      [--out DIR]

Runs ``tests/test_torch_kernels_cuda.py`` (without the JAX conftest) under
each of the tools memcheck, racecheck, synccheck and initcheck, once for
each selection of its cases below, and prints one ``[sanitize]`` line a
run: the tool, the selection, the exit code, the tests' summary and the
sanitizer's ``ERROR SUMMARY``; each run's whole output goes to
``DIR/<tool>_<selection>.log`` (default ``build/sanitize``). ``--probe``
runs one small case under each tool (does it run on this machine at all).
The L=5-sized cases are left out: under a sanitizer a kernel runs tens to
hundreds of times slower.
"""
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
SELECTIONS = {
    "k4_cluster": "(gram_matvec_fem3d_shapes or gram_matvec_forms_agree or "
                  "cluster_every_r or cluster_refusals) and not 4096",
    "k6_group": "node_barrier_wide_tables or node_barrier_table_kernels or "
                "table_rows_in_global_memory or table_staging_fallbacks or "
                "signed_zero_fold_wide or repeated_rows_wide",
    "k5_large": "large_form",
}
PROBE = {"k4_probe": "gram_matvec_fem3d_shapes and 128"}


def sanitizer():
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    path = "/usr/local/cuda/bin/compute-sanitizer"
    return path if os.path.exists(path) else None


def run(tool, name, select, timeout, out_dir):
    cmd = [sanitizer(), "--tool", tool, "--target-processes", "all",
           sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-q", "tests/test_torch_kernels_cuda.py",
           "-k", select]
    log = os.path.join(out_dir, f"{tool}_{name}.log")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=timeout)
        text, rc = proc.stdout + proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as exc:
        text = (exc.stdout or b"").decode(errors="replace") if isinstance(
            exc.stdout, bytes) else (exc.stdout or "")
        rc = "timeout"
    with open(log, "w") as f:
        f.write(text)
    tests = re.findall(r"^=*\s*(\d+ (?:passed|failed).*?) in [\d.]+s", text,
                       re.M)
    errors = re.findall(r"ERROR SUMMARY: (\d+) errors?", text)
    print(f"[sanitize] {tool} {name}: rc {rc}, {time.time() - t0:.0f} s; "
          f"tests {tests[-1] if tests else 'no summary'}; ERROR SUMMARY "
          f"{errors if errors else 'none printed'}; log {log}", flush=True)
    if not errors:
        tail = "\n".join(text.strip().splitlines()[-8:])
        print(f"[sanitize] {tool} {name}: last lines:\n{tail}", flush=True)


def main():
    args = sys.argv[1:]
    timeout = 900
    if "--timeout" in args:
        timeout = int(args[args.index("--timeout") + 1])
    if sanitizer() is None:
        print("[sanitize] compute-sanitizer: not found (PATH, "
              "/usr/local/cuda/bin)")
        return 1
    out_dir = os.path.join(HERE, "build", "sanitize")
    if "--out" in args:
        out_dir = os.path.abspath(args[args.index("--out") + 1])
    os.makedirs(out_dir, exist_ok=True)
    ver = subprocess.run([sanitizer(), "--version"], capture_output=True,
                         text=True)
    print(f"[sanitize] {sanitizer()}: "
          f"{(ver.stdout + ver.stderr).strip().splitlines()[-1:]}")
    # build the kernels once, outside the sanitizer
    subprocess.run([sys.executable, "-c", "import mgbtpu_torch.kernels as K; "
                    "K.build_all()"], cwd=HERE, check=True)
    if "--probe" in args:
        for tool in TOOLS:
            for name, select in PROBE.items():
                run(tool, name, select, timeout, out_dir)
        return 0
    for tool in TOOLS:
        for name, select in SELECTIONS.items():
            run(tool, name, select, timeout, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
