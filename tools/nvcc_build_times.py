#!/usr/bin/env python3
"""nvcc wall seconds of the port's kernels, with and without split
compilation, on the machine that builds them (one with the CUDA toolkit).

    python3 tools/nvcc_build_times.py [OUT_DIR]

Builds ``node_barrier.cu`` alone twice under each flag set (none;
``--split-compile=0``; ``-Xptxas --split-compile=0``; both) and prints its
seconds and the md5 of its SASS (``cuobjdump -sass``), so that a flag that
changes the generated code shows; then builds all seven sources at once,
as ``_build.build_all`` does, under three of the flag sets. Each build's
log (its ``-Xptxas -v`` report) goes to OUT_DIR (default
``build/nvcc_build_times``); the libraries go to a temporary
directory."""
import hashlib
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from mgbtpu_torch.kernels import _build as B  # noqa: E402

FLAGS = {"base": [], "nvsplit": ["--split-compile=0"],
         "ptxsplit": ["-Xptxas", "--split-compile=0"],
         "both": ["--split-compile=0", "-Xptxas", "--split-compile=0"]}


def build(nvcc, names, extra, tag, out, lib):
    """Starts one nvcc per source at once; {name: (seconds, returncode)}."""
    t0, procs = time.time(), {}
    for n in names:
        log = open(os.path.join(out, f"{tag}_{n}.txt"), "w")
        cmd = [nvcc, *B.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o",
               os.path.join(lib, f"{tag}_{n}.so"), B.source(n)]
        procs[n] = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    secs = {}
    while len(secs) < len(procs):
        for n, p in procs.items():
            if n not in secs and p.poll() is not None:
                secs[n] = (time.time() - t0, p.returncode)
        time.sleep(0.01)
    return secs


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "build", "nvcc_build_times")
    os.makedirs(out, exist_ok=True)
    nvcc = B._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[-2:])
    print("cpus", os.cpu_count())
    with tempfile.TemporaryDirectory() as lib:
        for rep in range(2):
            for v, extra in FLAGS.items():
                tag = f"alone_{v}"
                s = build(nvcc, ["node_barrier"], extra, tag, out, lib)
                sass = subprocess.run(
                    [cuobjdump, "-sass",
                     os.path.join(lib, f"{tag}_node_barrier.so")],
                    capture_output=True, text=True).stdout
                print(f"rep {rep} {v} alone: {s['node_barrier']}, sass lines "
                      f"{len(sass.splitlines())} md5 "
                      f"{hashlib.md5(sass.encode()).hexdigest()}", flush=True)
        for v in ("base", "both", "nvsplit"):
            s = build(nvcc, B.NAMES, FLAGS[v], f"all_{v}", out, lib)
            print(f"{v} all seven: " + ", ".join(
                f"{n} {t:.1f}s rc{rc}" for n, (t, rc) in s.items()),
                flush=True)


if __name__ == "__main__":
    main()
