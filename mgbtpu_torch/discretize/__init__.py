from .geometry import Geometry, dedupe
from .fem2d_p2 import FEM2DP2, fem2d_P2

__all__ = ["Geometry", "dedupe", "FEM2DP2", "fem2d_P2"]
