from repro_torch.train.steps import (  # noqa: F401
    cross_entropy, loss_fn, make_prefill_step, make_serve_step,
)
