"""The card's idle share in the traced steps."""

NAME = "device_idle_pct.train"
UNIT = "%"
LAYER = "Device"
MOVES = "train_samples_per_s"


def read(trace):
    """The share of the traced window in which no kernel, memcpy or
    memset ran on the card."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
