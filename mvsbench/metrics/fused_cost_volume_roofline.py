"""The `fused_cost_volume` kernel's share of its roofline."""

NAME = "fused_cost_volume_roofline"
UNIT = "%"
LAYER = "Kernels"
MOVES = "maps_per_s"
KERNEL = "fused_cost_volume"
#: the kernel's device name in the trace
PATTERN = r"fused_cost_volume_kernel"


def read(trace):
    """The bound of the traced units' jobs of KERNEL (mvsbench/work.py,
    from the cell's own geometry) over the device time of the kernels
    matching PATTERN, in percent of the H100's peaks."""
    return trace.roofline_pct(KERNEL, PATTERN)
