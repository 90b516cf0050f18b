"""Interactive 3D solution viewer as a single self-contained HTML file.

Fills the role of the reference's PyVista extension
(``ext/MultiGridBarrierPyPlotExt/plot3d.jl``: interactive exterior-surface
rendering): ``plot3d_html(sol, "out.html")`` writes one file with the
triangulated solution surface (2D problems: solution as height; embedded
surfaces and 3D volumes: the boundary shell colored by the solution) and a
tiny inline WebGL orbit viewer — no external libraries or network access,
so the file renders anywhere.

Port of ``mgbtpu/plot/html3d.py`` on the port's geometries. It needs numpy
and json only (the colours come from a viridis table, ``_viridis.py``, with
matplotlib's indexing), so it runs where matplotlib is missing; the one
exception is a geometry with neither triangles nor tensor quads (spectral2d),
whose node cloud matplotlib's Delaunay triangulation meshes, as the JAX
package's does.
"""
from __future__ import annotations

import json

import numpy as np


def _mesh_data(geom, z):
    """(verts (n, 3) float, tris (m, 3) int, vals (n,) float) for a solved
    geometry; reuses the triangulations of plot.plotting."""
    from ..discretize.fem2d_p1 import FEM2DP1
    from ..discretize.fem2d_p2 import FEM2DP2
    from ..discretize.tensorfem import TensorFEM
    from .plotting import _hex_boundary_tris, _quad_fans

    xf = np.asarray(geom.xflat(), np.float64)
    z = np.asarray(z, np.float64).reshape(-1)
    disc = geom.discretization
    if isinstance(disc, (FEM2DP1, FEM2DP2)):
        V, N = geom.x.shape[0], geom.x.shape[1]
        fans = [(0, 1, 2)] if V == 3 else \
            [(0, 1, 5), (1, 2, 3), (3, 4, 5), (1, 3, 5)]
        tris = np.array([[e * V + v for v in f]
                         for e in range(N) for f in fans], np.int64)
        verts = np.column_stack([xf[:, 0], xf[:, 1], z])
        return verts, tris, z
    if isinstance(disc, TensorFEM) and disc.d == 3:
        tris = np.asarray(_hex_boundary_tris(geom), np.int64)
        return xf[:, :3], tris, z
    tris = _quad_fans(geom)
    if tris is None:
        import matplotlib.tri as mtri

        tris = mtri.Triangulation(
            xf[:, 0] + 1e-9 * np.arange(len(z)), xf[:, 1]).triangles
    tris = np.asarray(tris, np.int64)
    if xf.shape[1] >= 3:
        return xf[:, :3], tris, z          # embedded surface, color by z
    verts = np.column_stack([xf[:, 0], xf[:, 1], z])
    return verts, tris, z


def _viridis(vals):
    """matplotlib's ``colormaps["viridis"](Normalize(lo, hi)(vals))[:, :3]``
    from the table: x = (v - lo) / (hi - lo) picks entry floor(256 x), the
    last for x = 1; NaN is black."""
    from ._viridis import VIRIDIS

    lo, hi = float(vals.min()), float(vals.max())
    x = (np.asarray(vals, np.float64) - lo) / ((hi if hi > lo else lo + 1.0)
                                               - lo)
    x = x * len(VIRIDIS)
    x[x == len(VIRIDIS)] = len(VIRIDIS) - 1
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        i = np.clip(x, 0, len(VIRIDIS) - 1).astype(int)
    i[bad] = 0
    rgb = np.asarray(VIRIDIS, np.float64)[i]
    rgb[bad] = 0.0
    return rgb


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mgbtpu 3D view</title>
<style>html,body{margin:0;height:100%%;overflow:hidden;background:#111}
canvas{width:100%%;height:100%%;display:block}
#hud{position:fixed;left:10px;top:8px;color:#ccc;font:12px monospace}</style>
</head><body><div id="hud">drag: rotate &nbsp; wheel: zoom &nbsp; %(n_v)d verts</div>
<canvas id="c"></canvas><script>
const MESH=%(mesh)s;
const cv=document.getElementById('c'),gl=cv.getContext('webgl');
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);return o;}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(pr);gl.useProgram(pr);
const vtx=new Float32Array(MESH.v.flat()),col=new Float32Array(MESH.c.flat());
const idx=new Uint32Array(MESH.t.flat());gl.getExtension('OES_element_index_uint');
function buf(tgt,data){const b=gl.createBuffer();gl.bindBuffer(tgt,b);gl.bufferData(tgt,data,gl.STATIC_DRAW);return b;}
const pb=buf(gl.ARRAY_BUFFER,vtx);const pl=gl.getAttribLocation(pr,'p');
gl.enableVertexAttribArray(pl);gl.vertexAttribPointer(pl,3,gl.FLOAT,false,0,0);
const cb=buf(gl.ARRAY_BUFFER,col);const cl=gl.getAttribLocation(pr,'col');
gl.bindBuffer(gl.ARRAY_BUFFER,cb);gl.enableVertexAttribArray(cl);
gl.vertexAttribPointer(cl,3,gl.FLOAT,false,0,0);
buf(gl.ELEMENT_ARRAY_BUFFER,idx);
let yaw=0.7,pitch=0.5,dist=2.6,drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.01;
pitch+=(e.clientY-ly)*0.01;pitch=Math.max(-1.5,Math.min(1.5,pitch));
lx=e.clientX;ly=e.clientY};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault()};
function mul(a,b){const o=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s}return o;}
function draw(){const w=cv.clientWidth,h=cv.clientHeight;
if(cv.width!=w||cv.height!=h){cv.width=w;cv.height=h}
gl.viewport(0,0,w,h);gl.enable(gl.DEPTH_TEST);
gl.clearColor(0.07,0.07,0.07,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
const f=2.2,a=w/h,n=0.01,fa=100;
const P=new Float32Array([f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0]);
const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
const Ry=new Float32Array([cy,0,-sy,0, 0,1,0,0, sy,0,cy,0, 0,0,0,1]);
const Rx=new Float32Array([1,0,0,0, 0,cp,sp,0, 0,-sp,cp,0, 0,0,0,1]);
const T=new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,-dist,1]);
const mvp=mul(P,mul(T,mul(Rx,Ry)));
gl.uniformMatrix4fv(gl.getUniformLocation(pr,'mvp'),false,mvp);
gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);
requestAnimationFrame(draw);}
draw();
</script></body></html>
"""


def plot3d_html(obj, path, z=None, component=0):
    """Write an interactive, dependency-free 3D view of a solution (or a
    (geometry, values) pair) to ``path``. Returns the path."""
    geom = getattr(obj, "geometry", obj)
    if z is None:
        zz = np.asarray(obj.z)
        z = zz[:, component] if zz.ndim == 2 else zz
    verts, tris, vals = _mesh_data(geom, z)
    # normalize into a unit-ish box centered at the origin
    c = verts.mean(axis=0)
    v = verts - c
    scale = np.abs(v).max() or 1.0
    v = v / scale
    # y-up for the viewer: swap z (solution/height) into y
    v = v[:, [0, 2, 1]]
    cols = _viridis(vals)
    mesh = {"v": np.round(v, 5).tolist(),
            "t": tris.tolist(),
            "c": np.round(cols, 4).tolist()}
    html = _TEMPLATE % {"mesh": json.dumps(mesh, separators=(",", ":")),
                        "n_v": len(v)}
    with open(path, "w") as f:
        f.write(html)
    return path
