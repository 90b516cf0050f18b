"""What the program's own spans and counters (``mgbtpu_torch.utils.trace``)
leave for a traced run's readers; None where the program has none."""
import importlib


def program_trace():
    """The program's tracing module, or None in a checkout without it."""
    try:
        return importlib.import_module("mgbtpu_torch.utils.trace")
    except ImportError:
        return None


def window_records(run):
    """The program's records of the window's solves: the last
    ``run.solves`` of ``trace.solves()`` (the warm-up and the probe run
    untraced, so they leave none); None in an untraced run."""
    tr = program_trace()
    if run.traced is None or not run.solves or tr is None:
        return None
    return tr.solves()[-run.solves:] or None


def idle_ms(run, layer):
    """Idle device milliseconds a solve whose gap fell inside a host span
    of ``layer`` (the span itself or one of its dotted children)."""
    if run.traced is None or not run.solves or program_trace() is None:
        return None
    secs = sum(v for k, v in run.traced.idle_s.items()
               if k == layer or k.startswith(layer + "."))
    return 1e3 * secs / run.solves
