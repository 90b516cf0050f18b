"""setup_s: process start to the first timed request (import, kernel
libraries from the checkout's build cache, host set-up, the warm-up solve
that builds the plans), on the host clock."""


def read(run):
    return run.setup_s
