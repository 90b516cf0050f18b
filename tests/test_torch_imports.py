"""The PyTorch port stands alone: no module of ``mgbtpu_torch``, not
``chip_smoke.py`` and not the models it solves (``port_models.py``)
imports ``jax`` or the JAX package ``mgbtpu`` (an AST
scan, so imports inside functions count too; the front ends and the plots
included), and the package imports where matplotlib does not (the card's
host has none)."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mgbtpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "port_models.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mgbtpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_scan_covers_the_port():
    files = _port_files()
    assert len(files) > 20
    for module in (("kernels", "power_cone.py"),
                   ("discretize", "tensorfem.py"),
                   ("discretize", "fem2d_p1.py"),
                   ("discretize", "spectral.py"),
                   ("utils", "interpolate.py"),
                   ("utils", "checkpoint.py"),
                   ("hierarchy", "prolongators.py"),
                   ("frontends", "model.py"),
                   ("frontends", "gmsh.py"),
                   ("plot", "plotting.py"),
                   ("plot", "html3d.py"),
                   ("parallel", "sharding.py"),
                   ("solver", "fsai.py"),
                   ("ops", "bsr.py"),
                   ("ops", "blockchol.py"),
                   ("utils", "threefry.py")):
        assert any(f.endswith(os.path.join(*module)) for f in files)


def test_the_port_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import mgbtpu_torch as mt\n"
            "assert callable(mt.plot3d_html) and callable(mt.Model)\n"
            "assert 'jax' not in sys.modules and 'mgbtpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
