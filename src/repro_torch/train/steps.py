"""Loss and the functions that make the serving steps.

The serving half of the reference's `train/steps.py`: `cross_entropy`,
`loss_fn` (forward only), `make_prefill_step` and `make_serve_step`.
`make_train_step` and its optimizer come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as models


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE, in f32 (logsumexp minus the label's logit)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params, batch) -> tuple[torch.Tensor, dict]:
    labels = batch["labels"]
    if cfg.mtp_depth:
        from repro_torch.models.transformer import mtp_logits
        logits, h = models.forward(cfg, params, batch, return_hidden=True)
        main = cross_entropy(logits[:, :-1], labels[:, 1:])
        mtp = mtp_logits(cfg, params, h, batch)
        mtp_loss = cross_entropy(mtp[:, :-2], labels[:, 2:])
        loss = main + 0.3 * mtp_loss
        return loss, {"loss": loss, "main_loss": main, "mtp_loss": mtp_loss}
    logits = models.forward(cfg, params, batch)
    loss = cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss, {"loss": loss}


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> greedy next token (B,) -- inference prefill."""

    def prefill_step(params, batch):
        logits = models.forward(cfg, params, batch)
        return torch.argmax(logits[:, -1].float(), dim=-1)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, batch) -> (next_token (B,1), caches) -- one decode, the
    batch's caches updated in place."""

    def serve_step(params, batch):
        logits, caches = models.decode_step(cfg, params, batch)
        return torch.argmax(logits[:, -1:].float(), dim=-1), caches

    return serve_step
