from .convex import Convex, validate_convex_inputs
from .euclidian_power import convex_euclidian_power

convex_Euclidian_power = convex_euclidian_power

__all__ = ["Convex", "convex_euclidian_power", "convex_Euclidian_power",
           "validate_convex_inputs"]
