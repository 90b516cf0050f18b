from .geometry import Geometry, dedupe
from .fem2d_p1 import FEM2DP1, fem2d_P1
from .fem2d_p2 import FEM2DP2, fem2d_P2
from .spectral import Spectral1D, Spectral2D, spectral1d, spectral2d
from .tensorfem import (TensorFEM, fem1d, fem2d, fem3d,
                        find_boundary_tensorfem, tensor_dofmap)

__all__ = ["Geometry", "dedupe", "FEM2DP1", "fem2d_P1", "FEM2DP2",
           "fem2d_P2", "Spectral1D", "Spectral2D", "spectral1d",
           "spectral2d", "TensorFEM", "fem1d", "fem2d", "fem3d",
           "tensor_dofmap", "find_boundary_tensorfem"]
