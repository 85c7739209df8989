from repro_torch.optim.adamw import OptConfig, global_norm, init, lr_at, update  # noqa: F401,E501
