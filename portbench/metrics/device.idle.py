"""device.idle: the share of the traced window in which no operation ran on
the device, in %: 1 - (union of the device operations' intervals) / window."""


def read(run):
    if run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.traced.busy_s / run.traced.window_s)
