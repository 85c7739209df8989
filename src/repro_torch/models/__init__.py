from repro_torch.models.api import (  # noqa: F401
    abstract_params, decode_step, forward, init_params, param_count,
)
