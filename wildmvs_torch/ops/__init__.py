# the score head's kernel registers with sweep_kernels' launch counts
from . import conv_head  # noqa: F401
