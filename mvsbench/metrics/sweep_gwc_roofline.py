"""The `sweep_gwc` kernel's share of its roofline."""

NAME = "sweep_gwc_roofline"
UNIT = "%"
LAYER = "Kernels"
MOVES = "maps_per_s"
KERNEL = "sweep_gwc"
#: the kernel's device name in the trace
PATTERN = r"sweep_view_kernel<true,\s*\d+,\s*true>"


def read(trace):
    """The bound of the traced units' jobs of KERNEL (mvsbench/work.py,
    from the cell's own geometry) over the device time of the kernels
    matching PATTERN, in percent of the H100's peaks."""
    return trace.roofline_pct(KERNEL, PATTERN)
