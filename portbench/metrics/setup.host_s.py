"""setup.host_s: host seconds of subdivide + amg + assemble."""


def read(run):
    return run.setup_host_s
