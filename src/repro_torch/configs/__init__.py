from .base import SHAPES, FLConfig, MeshConfig, ModelConfig, OptimConfig, ShapeConfig
from .registry import ALIASES, ARCH_IDS, all_pairs, batch_logical_axes, for_shape, get_config, input_specs, smoke_config
