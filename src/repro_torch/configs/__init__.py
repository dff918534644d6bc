from .base import SHAPES, ModelConfig, MoEConfig, ShapeConfig  # noqa: F401
from .registry import ARCHS, cells, get_config  # noqa: F401
