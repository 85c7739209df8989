from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeSpec, cache_specs, get_config, input_specs,
    list_configs, make_inputs, register,
)
