"""The 3D regularizers' device time a request."""

NAME = "regularizer_ms.serve"
UNIT = "ms"
LAYER = "Models"
MOVES = "maps_per_s"


def read(trace):
    """CUDA events recorded by the benchmark's forward pre- and post-hooks
    on the configuration's `regularizer_modules` (MVSNet
    cost_regularization; Vis stage{1,2,3}.reg, .reg_pair, .reg_fuse),
    summed over the traced requests, in ms a request."""
    if not trace.regularizer_s or trace.units <= 0:
        return None
    return 1e3 * trace.regularizer_s / trace.units
