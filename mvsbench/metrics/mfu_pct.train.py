"""The whole step's share of the bf16 peak."""

from mvsbench.work import BF16_FLOPS

NAME = "mfu_pct.train"
UNIT = "%"
LAYER = "Models"
MOVES = "train_samples_per_s"


def read(trace):
    """Flops of one step by the plain reference at the cell's shapes,
    over the traced window's time a step, as a share of the H100's
    dense bf16 peak (989 TFLOP/s)."""
    if not trace.flops_per_unit or trace.units <= 0 or trace.window_s <= 0:
        return None
    per_unit_s = trace.window_s / trace.units
    return 100.0 * trace.flops_per_unit / per_unit_s / BF16_FLOPS
