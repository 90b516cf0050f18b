"""k5a_roofline: K5a's share of its roofline over the window, in %: the
least time of every nd_factor's fronts (bytes at 3.35 TB/s or flops at the
67 TFLOP/s float64 tensor-core peak, whichever is larger, counted from the
plan's shapes by ``roofline.factor_counts``) over the device time of K5a's
kernels (``kernels/csrc/front_factor.cu``) in the trace."""
from portbench.roofline import bound_s, factor_counts

KERNELS = ("front_factor_kernel", "ff_init_kernel", "ff_diag_kernel",
           "ff_panel_kernel", "ff_gemm_kernel", "ff_final_kernel")


def read(run):
    if run.traced is None or not run.factor_calls:
        return None
    device = run.traced.op_total(KERNELS)
    if device <= 0:
        return None
    bound = sum(bound_s(*factor_counts(levels))[0]
                for levels, _, _ in run.factor_calls)
    return 100.0 * bound / device
