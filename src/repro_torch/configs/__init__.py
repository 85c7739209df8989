from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeSpec, get_config, list_configs, register,
)
