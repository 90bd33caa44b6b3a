from .base import SHAPES, FLConfig, MeshConfig, ModelConfig, OptimConfig, ShapeConfig
