"""Loss and the functions that make the train and serving steps.

`make_train_step` takes gradients per layer: the stacked (L, ...) leaves
are handed to the model as L per-layer tensors that alias the stacked
storage, and each one's gradient lands in its slice of one stacked
gradient buffer.  Differentiating through `a[i]` of a stacked leaf
would instead make every layer's backward materialise a zero-filled
gradient the size of the whole stack (the reference's `lax.scan` over
the stack makes the stacked gradient once).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as models
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw

#: the parameter subtrees whose leaves stack the layers along dim 0
STACKED = frozenset({"layers", "dense_layers", "moe_layers", "enc_layers",
                     "dec_layers"})


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


def grad_leaves(params, grads):
    """(model tree, leaves): tensors that alias `params`' storage and
    require grad, each with its `.grad` a view of `grads`' matching
    storage, so that the backward accumulates into `grads` in place; a
    stacked leaf becomes the list of its per-layer slices."""
    leaves = []

    def alias(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        leaves.append(t)
        return t

    def walk(p, g, stacked):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], stacked or k in STACKED) for k in p}
        if stacked:
            return [alias(pi, gi) for pi, gi in zip(p.unbind(0),
                                                    g.unbind(0))]
        return alias(p, g)

    return walk(params, grads, False), leaves


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, *,
                    accum_steps: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Parameters and optimizer state are updated in place (the reference
    donates them).  accum_steps > 1 splits the batch into microbatches
    along dim 0, each one's gradient divided by accum_steps and summed
    into an f32 accumulator, as in the reference (a stacked leaf a layer
    at a time: one f32 copy of zamba2-7b's `in_proj` stack is 17 GB).
    The step keeps its gradient buffers (`train_step.grads`, the
    reference's keys and stacked shapes) and its accumulator
    (`train_step.acc`) from one call to the next.
    """

    def grads_of(params, batch, grads):
        """Loss and aux of `batch`; its gradient written into `grads`."""
        for g in tree_leaves(grads):
            g.zero_()
        model, leaves = grad_leaves(params, grads)
        loss, aux = loss_fn(cfg, model, batch)
        loss.backward(inputs=leaves)
        return {k: v.detach() for k, v in aux.items()}

    def train_step(params, opt_state, batch):
        if train_step.grads is None:
            train_step.grads = tree_map(torch.zeros_like, params)
        grads = train_step.grads
        if accum_steps == 1:
            aux = grads_of(params, batch, grads)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum_steps} microbatches")
            mb = B // accum_steps
            if train_step.acc is None:
                train_step.acc = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            acc = train_step.acc
            for a in tree_leaves(acc):
                a.zero_()
            auxs = []
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                auxs.append(grads_of(params, micro, grads))
                with torch.no_grad():
                    for s, g in zip(tree_leaves(acc), tree_leaves(grads)):
                        for si, gi in zip(adamw.leading_slices(s),
                                          adamw.leading_slices(g)):
                            si += gi.float() / accum_steps
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
            grads = acc
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        aux.update(om)
        return params, opt_state, aux

    train_step.grads = train_step.acc = None
    return train_step


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
