from . import cvp_mvsnet  # noqa: F401  (registers "cvp_mvsnet")
from . import mvsnet  # noqa: F401  (registers "mvsnet")
from . import vis_mvsnet  # noqa: F401  (registers "vis_mvsnet")
from .api import MODEL_REGISTRY, build_model, register_model, view_list

__all__ = ["MODEL_REGISTRY", "build_model", "register_model", "view_list"]
