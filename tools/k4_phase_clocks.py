#!/usr/bin/env python3
"""Where a CTA of K4's cluster form spends its time, on one CUDA card: a
variant of ``csrc/gram_matvec.cu`` in which thread 0 of every CTA writes
``clock64()`` at the phase boundaries of ``gram_cluster_kernel`` (and
``%globaltimer`` at its first and last instruction), built beside the
package's own library and run at the fem3d k=3 L=4 top-level shapes (main
nD = 5, C = 128; phase I nD = 8, C = 192) on seeded panels, at each R the
card takes.

    python3 tools/k4_phase_clocks.py

The variant (written to build/k4_phase_clocks/) differs from the source
only by the stamps. Phases, by the stamp that ends each: ``pdl`` (the
barriers set up, the kernel before done), ``gathers`` (warp 0's bulk
copies and thread 0's copies of the node factors and of v[cols] issued),
``staged`` (those in shared memory), ``slab0`` and ``slabs`` (the first and the last slab landed, as
thread 0 waits for them), ``Pv`` (warp 0's rows), ``B`` (warp 0's),
``W`` (every warp's), ``wait`` (every CTA of
the cluster has started), ``A`` (thread 0's partials written to their
owners), ``sync`` (the cluster barrier), ``end`` (the owned slots' sums
written). Each ``[clk]`` line
gives, for one call, the median over the CTAs of the cycles between
consecutive stamps (the SM's other CTAs run in between, so a phase's
cycles count theirs too), the span, the call's wall on the device clock
(first CTA start to last CTA end), the CTAs' mean lifetime and how many
run at once on average an SM, and the call's device ms
(``chip_smoke.device_ms``). Prints the card's name and power limit first.
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
import mgbtpu_torch.kernels.gram_matvec  # noqa: E402
from k4_cluster_times import seeded_level  # noqa: E402
from mgbtpu_torch.kernels import _build as B  # noqa: E402

GM = sys.modules["mgbtpu_torch.kernels.gram_matvec"]
OUT = os.path.join(HERE, "build", "k4_phase_clocks")
STAMPS = 16
HEAD = """
__device__ long long* k4_clk = nullptr;
#define K4CLK(i) do { if (threadIdx.x == 0 && k4_clk) \\
    k4_clk[blockIdx.x * 16 + (i)] = clock64(); } while (0)
#define K4NOW(i) do { if (threadIdx.x == 0 && k4_clk) { \\
    long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
    k4_clk[blockIdx.x * 16 + (i)] = t_; } } while (0)
#define K4SM() do { if (threadIdx.x == 0 && k4_clk) { \\
    unsigned s_; asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); \\
    k4_clk[blockIdx.x * 16 + 13] = s_; } } while (0)
extern "C" int k4_set_clk(long long* p) {
    return (int)cudaMemcpyToSymbol(k4_clk, &p, sizeof(p));
}
"""
# (text in gram_cluster_kernel, the stamp inserted after it)
AFTER = [("    extern __shared__ __align__(16) unsigned char smb[];\n",
          "    K4NOW(14); K4SM(); K4CLK(0);\n"),
         ("    pdl_trigger();\n", "    K4CLK(1);\n"),
         ("        mbar_wait(bars + k, 0);\n",
          "        if (k == 0) K4CLK(4);\n        if (k == nD - 1) K4CLK(5);\n")]
NAMES = ["start", "pdl", "gathers", "staged", "slab0", "slabs", "Pv", "B",
         "W", "wait", "A", "sync", "end"]


def variant():
    """The stamped source, written beside copies of its headers."""
    src = open(B.source("gram_matvec")).read()
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + HEAD, 1)
    k0 = src.index("__global__ void gram_cluster_kernel(")
    k1 = src.index("static int cluster_threads(int C)")
    body = src[k0:k1]

    def once(old, new):
        nonlocal body
        assert body.count(old) == 1, old
        body = body.replace(old, new)

    for text, stamp in AFTER:
        once(text, text + stamp)
    once("    cp_async_wait_all();\n    __syncthreads();\n",
         "    cp_async_wait_all();\n    __syncthreads();\n    K4CLK(3);\n")
    once("    cp_async_wait_all();\n    __syncthreads();\n",
         "    K4CLK(2);\n    cp_async_wait_all();\n    __syncthreads();\n")
    once("    const int mine", "    K4CLK(6);\n    const int mine")
    w_loop = "    for (int u = lane; u < mine; u += 32) {  // W"
    once("    __syncwarp();\n" + w_loop,
         "    __syncwarp();\n    K4CLK(7);\n" + w_loop)
    wait = '    asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
    once("    __syncthreads();\n" + wait,
         "    __syncthreads();\n    K4CLK(8);\n" + wait + "    K4CLK(9);\n")
    sync = "    cluster.sync();"
    once(sync, "    K4CLK(10);\n" + sync + "\n    K4CLK(11);")
    end = body.rindex("}\n")
    body = body[:end] + "    K4CLK(12); K4NOW(15);\n" + body[end:]
    src = src[:k0] + body + src[k1:]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "gram_matvec.cu"), "w") as f:
        f.write(src)
    for h in os.listdir(B.CSRC):
        if h.endswith(".cuh"):
            with open(os.path.join(B.CSRC, h)) as fi, \
                    open(os.path.join(OUT, h), "w") as fo:
                fo.write(fi.read())


def breakdown(lib, tag, args, R, smi):
    nD, N, p, Cs = args[0].shape
    GM._FORM, GM._R = 2, R
    try:
        buf = torch.zeros(N * R * STAMPS, dtype=torch.int64, device="cuda")
        lib.k4_set_clk(ctypes.c_void_p(buf.data_ptr()))
        K.gram_matvec(*args)
        torch.cuda.synchronize()
        buf.zero_()
        K.gram_matvec(*args)
        torch.cuda.synchronize()
        a = buf.view(N * R, STAMPS).cpu().numpy()
        lib.k4_set_clk(ctypes.c_void_p(0))
        ms = C.device_ms(lambda: K.gram_matvec(*args), 20)[0]
    finally:
        GM._FORM, GM._R = 0, 0
    parts = [f"{NAMES[i]}->{NAMES[i + 1]} "
             f"{int(np.median(a[:, i + 1] - a[:, i]))}"
             for i in range(len(NAMES) - 1)]
    span = int(np.median(a[:, 12] - a[:, 0]))
    t0, t1 = a[:, 14], a[:, 15]
    wall = (t1.max() - t0.min()) * 1e-6
    life = (t1 - t0).mean() * 1e-6
    sms = len(np.unique(a[:, 13]))
    print(f"[clk] {tag} R={R}: {N * R} CTAs on {sms} SMs; median cycles "
          f"{', '.join(parts)}; span {span}; device-clock wall {wall!r} ms, "
          f"CTA lifetime {life!r} ms, CTAs at once an SM "
          f"{N * R * life / wall / sms!r}; device ms {ms!r} on {smi}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_phase_clocks: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    variant()
    so = os.path.join(OUT, "libgram_matvec.so")
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", so,
                    os.path.join(OUT, "gram_matvec.cu")], check=True)
    K.build_all()
    # this process's K4 launches go to the stamped library
    for entry in [e for e in B._LIBS if e.startswith("gram_matvec")]:
        B._LIBS.pop(entry)
    lib_of = B.library
    B.library = lambda name: so if name == "gram_matvec" else lib_of(name)
    B._fresh = lambda name: True
    lib = ctypes.CDLL(so)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1605)
    for tag, nD, Cs in (("fem3d L=4-sized", 5, 128),
                        ("fem3d L=4-sized phase I", 8, 192)):
        lv = seeded_level(512, nD, Cs, rng, dev)
        m = 512 * 64
        Ln = torch.as_tensor(np.tril(rng.standard_normal((m, nD, nD))),
                             device=dev)
        v = torch.as_tensor(rng.standard_normal(lv.n_J), device=dev)
        args = (lv.panels, lv.cols, lv.inv, Ln, v)
        for R in (2, 4, 8):
            if GM.cluster_size(nD, 512, 64, Cs, R):
                breakdown(lib, tag, args, R, smi)


if __name__ == "__main__":
    main()
