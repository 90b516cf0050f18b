from .errors import MGBConvergenceFailure
from .interpolate import chebfun, interpolate
from .log import Log, Logger, safe_pow
from .maps import map_rows, sample_rows

__all__ = ["Log", "Logger", "MGBConvergenceFailure", "chebfun",
           "interpolate", "map_rows", "safe_pow", "sample_rows"]
