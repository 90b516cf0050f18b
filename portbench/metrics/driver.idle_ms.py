"""driver.idle_ms: device idle milliseconds a solve while the host was
inside the driver's spans (``driver.solve``, ``driver.main``,
``driver.apply_D``, ``driver.prolong``, ``driver.to_device``, ...) and no
deeper span of the program: the host work of the t-ramp between Newton
solves, from the trace."""
from portbench.records import idle_ms


def read(run):
    return idle_ms(run, "driver")
