from . import mvsnet  # noqa: F401  (registers "mvsnet")
from .api import MODEL_REGISTRY, build_model, register_model, view_list

__all__ = ["MODEL_REGISTRY", "build_model", "register_model", "view_list"]
