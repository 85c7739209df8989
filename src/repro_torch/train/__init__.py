from repro_torch.train import checkpoint  # noqa: F401
from repro_torch.train.steps import (  # noqa: F401
    cross_entropy, loss_fn, make_prefill_step, make_serve_step,
    make_train_step,
)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
