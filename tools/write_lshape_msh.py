"""Write the L-shaped test mesh as an ASCII Gmsh MSH 2.2 file.

The domain is [-1, 1]^2 minus (0, 1]^2, cut into squares of side h = 1/16,
each split along its rising diagonal into two 6-node triangles (Gmsh type
9: corners counter-clockwise, then the midpoints of edges 01, 12, 20):
1,536 triangles and 3,201 nodes on the lattice of spacing h/2. The
boundary (perimeter 8) is a physical line group "boundary" of 128 3-node
lines (type 8), the triangles the physical surface "domain". Coordinates
are multiples of 1/32, so they are written exactly.

    python tools/write_lshape_msh.py [PATH]

PATH defaults to mgbtpu_torch/data/lshape_tri6.msh, the committed file both
packages import (``chip_smoke.py``'s Gmsh path and
``tests/test_torch_gmsh.py``).
"""
import os
import sys

N = 32          # lattice steps of h/2 per unit length
H = 2           # a square's side in lattice steps (h = 1/16)


def inside(i, j):
    """Lattice point (i, j), coordinates (i / N - 1, j / N - 1), in the L."""
    return 0 <= i <= 2 * N and 0 <= j <= 2 * N and not (i > N and j > N)


def mesh():
    tag = {}
    for j in range(2 * N + 1):
        for i in range(2 * N + 1):
            if inside(i, j):
                tag[(i, j)] = len(tag) + 1
    tris = []
    for j in range(0, 2 * N, H):
        for i in range(0, 2 * N, H):
            if not inside(i + H, j + H):
                continue
            a, b, c, d = (i, j), (i + H, j), (i + H, j + H), (i, j + H)
            for p, q, r in ((a, b, c), (a, c, d)):
                mid = [((u[0] + v[0]) // 2, (u[1] + v[1]) // 2)
                       for u, v in ((p, q), (q, r), (r, p))]
                tris.append([tag[x] for x in (p, q, r, *mid)])
    # the boundary walked counter-clockwise, corner to corner
    corners = [(0, 0), (2 * N, 0), (2 * N, N), (N, N), (N, 2 * N),
               (0, 2 * N), (0, 0)]
    lines = []
    for (x0, y0), (x1, y1) in zip(corners, corners[1:]):
        n = max(abs(x1 - x0), abs(y1 - y0)) // H
        sx, sy = (x1 - x0) // (n * H), (y1 - y0) // (n * H)
        for k in range(n):
            p = (x0 + sx * H * k, y0 + sy * H * k)
            q = (p[0] + sx * H, p[1] + sy * H)
            m = (p[0] + sx, p[1] + sy)
            lines.append([tag[p], tag[q], tag[m]])
    return tag, tris, lines


def write(path):
    tag, tris, lines = mesh()
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
           "2", '1 1 "boundary"', '2 2 "domain"', "$EndPhysicalNames",
           "$Nodes", str(len(tag))]
    for (i, j), t in tag.items():
        out.append(f"{t} {repr(i / N - 1.0)} {repr(j / N - 1.0)} 0")
    out += ["$EndNodes", "$Elements", str(len(lines) + len(tris))]
    e = 0
    for conn in lines:
        e += 1
        out.append(f"{e} 8 2 1 1 " + " ".join(map(str, conn)))
    for conn in tris:
        e += 1
        out.append(f"{e} 9 2 2 2 " + " ".join(map(str, conn)))
    out.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return len(tag), len(tris), len(lines)


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "mgbtpu_torch", "data", "lshape_tri6.msh")
    nodes, tris, lines = write(path)
    print(f"{path}: {nodes} nodes, {tris} triangles, {lines} boundary lines")
