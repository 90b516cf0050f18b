from .convex import Convex, intersect, validate_convex_inputs
from .euclidian_power import convex_euclidian_power
from .linear import convex_linear
from .piecewise import convex_piecewise

convex_Euclidian_power = convex_euclidian_power

__all__ = ["Convex", "convex_euclidian_power", "convex_Euclidian_power",
           "convex_linear", "convex_piecewise", "intersect",
           "validate_convex_inputs"]
