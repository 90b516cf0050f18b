"""k5b_roofline: K5b's share of its roofline over the window, in %: the
least time of every nd_solve's two sweeps (bytes at 3.35 TB/s or flops at
67 TFLOP/s, whichever is larger, counted from the plan's shapes by
``roofline.solve_counts``) over the device time of K5b's kernels
(``kernels/csrc/front_solve.cu``) in the trace."""
from portbench.roofline import bound_s, solve_counts

KERNELS = ("front_forward_kernel", "front_backward_kernel",
           "front_separator_kernel", "front_forward_band_kernel",
           "front_backward_band_kernel")


def read(run):
    if run.traced is None or not run.solve_calls:
        return None
    device = run.traced.op_total(KERNELS)
    if device <= 0:
        return None
    bound = sum(bound_s(*solve_counts(levels, n_J, updated))[0]
                for levels, n_J, updated in run.solve_calls)
    return 100.0 * bound / device
