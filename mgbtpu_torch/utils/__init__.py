from .errors import MGBConvergenceFailure
from .log import Log, Logger, safe_pow
from .maps import sample_rows

__all__ = ["Log", "Logger", "MGBConvergenceFailure", "safe_pow",
           "sample_rows"]
