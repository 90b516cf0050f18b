"""Front ends: the Model DSL (``model.Model``) and Gmsh import
(``gmsh.gmsh_import``)."""
from .gmsh import gmsh_import
from .model import Model

__all__ = ["Model", "gmsh_import"]
