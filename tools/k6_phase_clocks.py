#!/usr/bin/env python3
"""Where a K6 group-kernel block spends its time, on one CUDA card: a
variant of ``csrc/node_barrier.cu`` in which thread 0 of every block
writes ``clock64()`` at the phase boundaries of the wide and table kernels,
built beside the package's own library and run on the tables that
``tools/k6_gram_times.py`` times.

    python3 tools/k6_phase_clocks.py

The variant (written to build/k6_phase_clocks/) differs from the source
only by the stamps. Phases, by the stamp that ends each: ``start`` (the
block's first instruction), ``records`` (the pieces' records, input rows,
y rows and sel in shared memory), ``staged`` (the grids staged, the masks
derived, the output rows filled with +0.0), then per piece (the last
piece's stamps win) ``affine`` (y[idx] gathered, z or F), ``value`` (mode
0, lane 0), ``gz`` and ``A'g`` (mode 1), ``lane0`` (mode 2: the closed
forms' scalars), ``w``, ``H`` (the Gram tiles), then ``tail`` (the box
terms) and ``stored`` (the rows out). Each ``[clk]`` line gives, for one
call, the median over the blocks of the cycles between consecutive stamps
(every resident block's work interleaves with a block's own phases, so a
phase's cycles count the SM's other blocks too), the span, and the call's
device ms (``chip_smoke.device_ms``). Prints the card's name and power
limit first.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import mgbtpu_torch.kernels as K  # noqa: E402
from mgbtpu_torch.kernels import _build as B  # noqa: E402

NB = sys.modules["mgbtpu_torch.kernels.node_barrier"]
OUT = os.path.join(ROOT, "build", "k6_phase_clocks")
STAMPS = 16
HEAD = """
__device__ long long* nb_clk = nullptr;
#define NBCLK(i) do { if (threadIdx.x == 0 && nb_clk) \\
    nb_clk[blockIdx.x * 16 + (i)] = clock64(); } while (0)
extern "C" int nb_set_clk(long long* p) {
    return (int)cudaMemcpyToSymbol(nb_clk, &p, sizeof(p));
}
"""
# (the text a stamp follows, its number, its name); each must occur once in
# its function
BODY = [("    extern __shared__ __align__(16) double sh[];\n", 0, "start"),
        ("nb * npc, t, B);\n    __syncthreads();\n", 1, "records"),
        ("    cp_async_wait_all();\n    __syncthreads();\n", 2, "staged"),
        ("    __syncthreads();\n    if (!k.sos) {", 13, "tail")]
CONE = ["affine", "value", "gz", "A'g", "lane0", "w", "H"]


def variant():
    """The stamped source, written beside copies of its headers."""
    src = open(B.source("node_barrier")).read()
    src = src.replace("#define NB_MAXP 16", HEAD + "\n#define NB_MAXP 16", 1)
    c0 = src.index("static __device__ __forceinline__ double cone_grp(")
    c1 = src.index("// The runtime-width linear block over the group")
    parts = src[c0:c1].split("grp_sync(G, g.mask);")
    assert len(parts) == len(CONE) + 1, len(parts)
    cone = parts[0] + "".join(f"grp_sync(G, g.mask); NBCLK({3 + i});" + p
                              for i, p in enumerate(parts[1:]))
    src = src[:c0] + cone + src[c1:]
    b0 = src.index("static __device__ __forceinline__ void group_body(")
    b1 = src.index("// The wide kernels: the table in their parameter")
    body = src[b0:b1]
    for text, i, _ in BODY:
        assert body.count(text) == 1, text
        if text.startswith("    __syncthreads();"):
            body = body.replace(text, f"    __syncthreads();\n    NBCLK({i});"
                                + text[len("    __syncthreads();"):])
        else:
            body = body.replace(text, text + f"    NBCLK({i});\n")
    end = body.rindex("}\n")
    body = body[:end] + "    NBCLK(14);\n" + body[end:]
    # the early returns of the tail end the block as well
    body = body.replace("        return;\n    }\n    // the block's nb rows",
                        "        NBCLK(14);\n        return;\n    }\n"
                        "    // the block's nb rows")
    src = src[:b0] + body + src[b1:]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "node_barrier.cu"), "w") as f:
        f.write(src)
    for h in ("cpasync.cuh", "linear.cuh", "power_cone.cuh"):
        with open(os.path.join(B.CSRC, h)) as fi, \
                open(os.path.join(OUT, h), "w") as fo:
            fo.write(fi.read())


NAMES = {0: "start", 1: "records", 2: "staged", 13: "tail", 14: "stored",
         **{3 + i: n for i, n in enumerate(CONE)}}


def breakdown(lib, tag, call, smi):
    m = call[1].shape[0]
    buf = torch.zeros(m * STAMPS + 64, dtype=torch.int64, device="cuda")
    lib.nb_set_clk(ctypes.c_void_p(buf.data_ptr()))
    K.node_barrier(*call)
    torch.cuda.synchronize()
    buf.zero_()
    K.node_barrier(*call)
    torch.cuda.synchronize()
    blocks = (m + NB.last_block() - 1) // NB.last_block()
    a = buf[:blocks * STAMPS].view(blocks, STAMPS).cpu().numpy()
    lib.nb_set_clk(ctypes.c_void_p(0))
    used = [i for i in range(STAMPS) if (a[:, i] != 0).all()]
    parts = [f"{NAMES[p]}->{NAMES[q]} {int(np.median(a[:, q] - a[:, p]))}"
             for p, q in zip(used, used[1:])]
    span = int(np.median(a[:, used[-1]] - a[:, used[0]]))
    ms = C.device_ms(lambda: K.node_barrier(*call), 20)[0]
    print(f"[clk] {tag}: {blocks} blocks of {NB.last_block()} nodes, "
          f"{NB.last_group()} lanes a node; median cycles {', '.join(parts)}; "
          f"span {span}; device ms {ms!r} on {smi}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_phase_clocks: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    variant()
    so = os.path.join(OUT, "libnode_barrier.so")
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", so,
                    os.path.join(OUT, "node_barrier.cu")], check=True)
    K.build_all()
    # this process's K6 launches go to the stamped library
    B._LIBS.pop("node_barrier_launch", None)
    NB._LAUNCH.clear()
    lib_of = B.library
    B.library = lambda name: so if name == "node_barrier" else lib_of(name)
    B._fresh = lambda name: True
    lib = ctypes.CDLL(so)
    dev = torch.device("cuda")
    rng = np.random.default_rng(4096)
    sets = [(m, C.table_kernel_tables(m, rng)) for m in (8, C.TABLE_M)]
    sets += [(m, [w for w in C.wide_tables(m, rng) if w[0] == "cone nz=7"])
             for m in (224, C.MODEL_M)]
    for m, tables in sets:
        for name, Q, nD, nu in tables:
            Dz = torch.as_tensor(C._wide_rows(m, Q, nD, rng),
                                 dtype=torch.float64, device=dev)
            calls = C.k6_calls(Q, Dz, nu, np.full(m, 1.0 / m), torch, K, rng)
            for label in ("mode 0", "mode 1", "mode 2", "co mode 2"):
                breakdown(lib, f"{name} m={m} {label}", calls[label], smi)


if __name__ == "__main__":
    main()
