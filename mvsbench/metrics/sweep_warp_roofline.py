"""The `sweep_warp` kernel's share of its roofline."""

NAME = "sweep_warp_roofline"
UNIT = "%"
LAYER = "Kernels"
MOVES = "train_samples_per_s"
KERNEL = "sweep_warp"
#: the kernel's device name in the trace
PATTERN = r"sweep_view_kernel<false,\s*\d+,\s*false>"


def read(trace):
    """The bound of the traced units' jobs of KERNEL (mvsbench/work.py,
    from the cell's own geometry) over the device time of the kernels
    matching PATTERN, in percent of the H100's peaks."""
    return trace.roofline_pct(KERNEL, PATTERN)
