"""setup.plans_s: host seconds of the warm-up solve, which builds the panel
operators, the ND plans and loads the kernels."""


def read(run):
    return run.setup_plans_s
