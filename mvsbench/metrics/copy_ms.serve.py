"""The device time of the host<->device copies a request."""

NAME = "copy_ms.serve"
UNIT = "ms"
LAYER = "Serving entry"
MOVES = "maps_per_s"


def read(trace):
    """Every memcpy record of the traced requests (the images and cameras
    in, the depth and confidence out), in ms a request."""
    if trace.units <= 0 or trace.memcpy_s <= 0:
        return None
    return 1e3 * trace.memcpy_s / trace.units
