from .prolongators import amg_ruge_stuben, amg_smoothed_aggregation
from .multigrid import MultiGrid, AMGSystem, amg_helper, prepare_amg
from .amg_build import amg, geometric_mg, subdivide, find_boundary

__all__ = [
    "amg_ruge_stuben", "amg_smoothed_aggregation", "MultiGrid", "AMGSystem", "amg_helper", "prepare_amg",
    "amg", "geometric_mg", "subdivide", "find_boundary",
]
