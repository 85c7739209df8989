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

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.sharding import contiguous_strides
from repro_torch.models import api as models
from repro_torch.models.common import (ShardCtx, constrain, is_dtensor,
                                       sharded, tree_leaves, tree_map)
from repro_torch.optim import adamw

#: the parameter subtrees whose leaves stack the layers along dim 0
#: (zamba2's shared blocks, adapters and linears: blocks and invocations)
STACKED = frozenset({"layers", "dense_layers", "moe_layers", "enc_layers",
                     "dec_layers", "shared_blocks", "adapters", "linears"})


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE, in f32 (logsumexp minus the label's logit).
    On DTensor logits it runs on each device's shards (`_token_nll`)."""
    lf = logits.float()
    if is_dtensor(lf):
        return torch.mean(_token_nll(lf, labels))
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def _token_nll(lf, labels):
    """(B, S, 1) negative log-likelihoods of f32 DTensor logits, on each
    device's shards: split over the batch and the vocabulary (evenly or
    not), the sequence whole; the max, the sum of exponentials and the
    label's logit (picked by its id in the shard) each reduced over the
    devices that split the vocabulary.  DTensor's own `logsumexp` would
    gather the (B, S, V) logits, its `gather` backward makes their whole
    gradient on every device, and its redistributions of an unevenly
    split vocabulary move the whole tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    mesh, vocab = lf.device_mesh, lf.ndim - 1
    place = [p if p in (Shard(0), Shard(vocab)) else Replicate()
             for p in lf.placements]
    lf = lf.redistribute(mesh, place)
    rows = [Replicate() if p == Shard(vocab) else p for p in place]
    lab = labels.redistribute(mesh, rows).to_local() \
        if is_dtensor(labels) else labels
    with _disable_current_modes():
        _, off = compute_local_shape_and_global_offset(tuple(lf.shape),
                                                       mesh, place)
    split = Shard(vocab) in place

    def over_vocab(t, op):
        if not split:
            return t
        part = [Partial(op) if p == Shard(vocab) else p for p in place]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, rows).to_local()
    x = lf.to_local()
    m = over_vocab(x.detach().amax(-1, keepdim=True), "max")
    lse = torch.log(over_vocab(torch.exp(x - m).sum(-1, keepdim=True),
                               "sum")) + m
    ids = torch.arange(x.shape[-1], device=x.device) + off[vocab]
    ll = over_vocab(torch.where(ids == lab.long()[..., None], x, 0.0)
                    .sum(-1, keepdim=True), "sum")
    shape = (*lf.shape[:-1], 1)
    return DTensor.from_local(lse - ll, mesh, rows, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))


def shifted_cross_entropy(logits, labels, k: int) -> torch.Tensor:
    """`cross_entropy(logits[:, :-k], labels[:, k:])`.  On a DTensor the
    losses are taken at every position, against the labels rolled back
    by k, and the last k dropped from the (B, S, 1) losses: slicing the
    (B, S, V) logits would, in its backward, gather their gradient."""
    if not is_dtensor(logits):
        return cross_entropy(logits[:, :-k], labels[:, k:])
    rolled = torch.cat([labels[:, k:], labels[:, :k]], dim=1)
    nll = _token_nll(logits.float(), rolled)
    return torch.mean(nll[:, :-k])


def loss_fn(cfg: ModelConfig, params, batch,
            ctx: Optional[ShardCtx] = None) -> tuple[torch.Tensor, dict]:
    labels = batch["labels"]
    if cfg.mtp_depth:
        from repro_torch.models.transformer import mtp_logits
        logits, h = models.forward(cfg, params, batch, ctx,
                                   return_hidden=True)
        with sharded(ctx):
            main = shifted_cross_entropy(logits, labels, 1)
            mtp = mtp_logits(cfg, params, h, batch, ctx)
            mtp_loss = shifted_cross_entropy(mtp, labels, 2)
            loss = main + 0.3 * mtp_loss
        return loss, {"loss": loss, "main_loss": main, "mtp_loss": mtp_loss}
    logits = models.forward(cfg, params, batch, ctx)
    with sharded(ctx):
        loss = shifted_cross_entropy(logits, labels, 1)
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


def microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch i of n: rows [i·B/n, (i+1)·B/n) of `v`.  On a DTensor,
    split over the batch, the rows of each device's own shard (each
    device steps through its own rows, as XLA's partitioned scan over the
    reference's microbatch axis does): the same rows in all, in another
    order, so the accumulated gradient is the same."""
    if not is_dtensor(v) or not any(p.is_shard(0) for p in v.placements):
        mb = v.shape[0] // n
        return v[i * mb:(i + 1) * mb]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    mb = loc.shape[0] // n
    part = loc[i * mb:(i + 1) * mb]
    return DTensor.from_local(part, v.device_mesh, v.placements,
                              run_check=False,
                              shape=(v.shape[0] // n, *v.shape[1:]),
                              stride=part.stride())


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    ctx: Optional[ShardCtx] = None, *,
                    accum_steps: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Parameters and optimizer state are updated in place (the reference
    donates them).  accum_steps > 1 splits the batch into microbatches
    along dim 0, each one's gradient divided by accum_steps and summed
    into an f32 accumulator, as in the reference (a stacked leaf a layer
    at a time: one f32 copy of zamba2-7b's `in_proj` stack is 17 GB).
    The step keeps its gradient buffers (`train_step.grads`, the
    reference's keys and stacked shapes) and its accumulator
    (`train_step.acc`) from one call to the next.  Its phases open the
    spans of `repro_torch.spans`.  Under a `ctx` the
    parameters, state and batch are DTensors on its mesh, and so are the
    gradient buffers and the accumulator, placed as the parameters.
    """

    def grads_of(params, batch, grads):
        """Loss and aux of `batch`; its gradient written into `grads`."""
        for g in tree_leaves(grads):
            g.zero_()
        with spans.span(spans.FORWARD):
            model, leaves = grad_leaves(params, grads)
            loss, aux = loss_fn(cfg, model, batch, ctx)
        # the layers' recompute runs here
        with spans.span(spans.BACKWARD), sharded(ctx):
            loss.backward(inputs=leaves)
        return {k: v.detach() for k, v in aux.items()}

    def train_step(params, opt_state, batch):
        with spans.span(spans.STEP):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
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
            if train_step.acc is None:
                train_step.acc = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            acc = train_step.acc
            for a in tree_leaves(acc):
                a.zero_()
            auxs = []
            for i in range(accum_steps):
                micro = {k: microbatch(v, i, accum_steps)
                         for k, v in batch.items()}
                auxs.append(grads_of(params, micro, grads))
                with spans.span(spans.ACCUMULATE), torch.no_grad():
                    for s, g in zip(tree_leaves(acc), tree_leaves(grads)):
                        for si, gi in zip(adamw.leading_slices(s),
                                          adamw.leading_slices(g)):
                            si += gi.float() / accum_steps
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
            grads = acc
        with spans.span(spans.OPTIMIZER):
            params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                                 params)
        aux.update(om)
        return params, opt_state, aux

    train_step.grads = train_step.acc = None
    return train_step


def make_prefill_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """(params, batch) -> greedy next token (B,) -- inference prefill."""

    def prefill_step(params, batch):
        logits = models.forward(cfg, params, batch, ctx)
        # gathered over the vocabulary: an argmax does not split
        last = constrain(logits[:, -1], ctx, "dp", None)
        return torch.argmax(last.float(), dim=-1)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    """(params, batch) -> (next_token (B,1), caches) -- one decode, the
    batch's caches updated in place."""

    def serve_step(params, batch):
        logits, caches = models.decode_step(cfg, params, batch, ctx)
        last = constrain(logits[:, -1:], ctx, "dp", None, None)
        return torch.argmax(last.float(), dim=-1), caches

    return serve_step
