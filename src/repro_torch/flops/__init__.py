from repro_torch.flops.accounting import (  # noqa: F401
    Breakdown, decode_step_flops, forward_flops, model_flops_6nd,
    param_count_analytic, step_flops, train_step_flops,
)
