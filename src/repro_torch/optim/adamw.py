"""AdamW + cosine schedule over dict trees of tensors (no torch.optim).

Distributed-memory options for large models, as in the reference:
  moment_dtype="bfloat16" -- half-width first moment
  factored_v=True         -- Adafactor-style factored second moment for
                             matrices (row/col statistics), O(n+m) not O(nm)
The reference returns new trees (its train step donates the old ones);
`update` writes the parameters and the state in place, which on one card
is what keeps a 6.8 B-parameter model's state at one copy.  The f32
arithmetic of a leaf with ndim >= 3 (a stacked layer dim) runs one
leading index at a time: exact, since the factored row, column and mean
statistics all lie within one leading index, and one f32 copy of a
stacked leaf could be larger than the card has left.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.sharding import is_dtensor, on_shards
from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    factored_v: bool = False


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a number or a 0-d tensor, whose
    device the result shares), in f32: linear warm-up, then cosine decay
    to `min_lr`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) \
        * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def init(cfg: OptConfig, params):
    """{"mu": {"m", "v"} a leaf, "count": 0-d int32} on the parameters'
    device; v is {"row", "col"} for a factorable leaf under
    `factored_v`."""
    mdt = getattr(torch, cfg.moment_dtype)

    def leaf(p):
        m = torch.zeros_like(p, dtype=mdt)
        if cfg.factored_v and _factorable(p):
            v = {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                    device=p.device),
                 "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                    dtype=torch.float32, device=p.device)}
        else:
            v = torch.zeros_like(p, dtype=torch.float32)
        return {"m": m, "v": v}

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _split_dim0(t) -> bool:
    """t is a DTensor split along dim 0 (an expert or vocabulary dim:
    stacked layers are never split), which does not unbind."""
    return is_dtensor(t) and any(getattr(p, "dim", None) == 0
                                 for p in t.placements if p.is_shard())


def leading_slices(t, ndim=None):
    """The unit of a leaf's f32 work: t's slices along dim 0 when the
    leaf (`ndim` dims, t's own when None) has ndim >= 3, else t whole;
    whole, too, for a DTensor split along dim 0 (its shards are the
    unit there)."""
    if ndim is None:
        ndim = 0 if _split_dim0(t) else t.ndim
    return t.unbind(0) if ndim >= 3 else (t,)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        for s in leading_slices(x):
            total = total + s.float().square().sum()
    return total.sqrt()


def _placed_as(t, state):
    """t, a DTensor, placed as its `state` leaf: a factored statistic is
    reduced over its split dimension here, a vector, before the outer
    product makes it a matrix (whose reduction would move the matrix)."""
    if not is_dtensor(t):
        return t
    return t.redistribute(state.device_mesh, state.placements)


def _factors_placed_as(row, col, p):
    """The factored statistics, DTensors, each split along its dims as
    the parameter p is along the matching ones (row: p's but the last;
    col: p's but the second to last), so that row ⊗ col is formed on
    each device's own block of p: the specs of the state's factors come
    from rules meant for p's shape and may split them otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(p):
        return row, col
    last = p.ndim - 1
    r_place, c_place = [], []
    for q in p.placements:
        d = q.dim if isinstance(q, Shard) else None
        r_place.append(Shard(d) if d is not None and d < last
                       else Replicate())
        c_place.append(Replicate() if d is None or d == last - 1
                       else Shard(d if d < last - 1 else last - 1))
    return (row.redistribute(p.device_mesh, r_place),
            col.redistribute(p.device_mesh, c_place))


def _rank1(row, col, denom):
    return row[..., None] * col[..., None, :] / denom[..., None]


def _outer(row, col, denom, p):
    """row ⊗ col / denom, placed as p on DTensors: formed on each
    device's own block of p from the factors `_factors_placed_as` placed
    (DTensor's broadcast rule may instead gather one factor whole, and
    the product with it)."""
    if not is_dtensor(p):
        return _rank1(row, col, denom)
    from torch.distributed.tensor import Replicate, Shard
    whole = Shard(row.ndim - 1)          # the mean's dim: denom holds it 1
    d_place = [Replicate() if q == whole else q for q in row.placements]
    return on_shards(_rank1, (row, col, denom),
                     (row.placements, col.placements, d_place),
                     [(p.placements, p.shape)])


def update_leaf(cfg: OptConfig, p, g, mu, *, lr, scale, c1, c2,
                decay: bool) -> None:
    """One leaf's (or one leading slice's) AdamW step, in place: p, mu's
    m and v.  The reference's formulas, in f32."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = mu["m"].float() * b1 + g * (1 - b1)
    if isinstance(mu["v"], dict):  # factored second moment
        g2 = g.square() + 1e-30
        row = _placed_as(mu["v"]["row"] * b2 + g2.mean(-1) * (1 - b2),
                         mu["v"]["row"])
        col = _placed_as(mu["v"]["col"] * b2 + g2.mean(-2) * (1 - b2),
                         mu["v"]["col"])
        del g2
        mu["v"]["row"].copy_(row)
        mu["v"]["col"].copy_(col)
        row, col = _factors_placed_as(row, col, p)
        # rank-1 reconstruction: v ≈ row ⊗ col / mean(row)
        denom = torch.clamp_min(row.mean(-1, keepdim=True), 1e-30)
        v_hat = _outer(row, col, denom, p) / c2
    else:
        new_v = mu["v"] * b2 + g.square() * (1 - b2)
        mu["v"].copy_(new_v)
        v_hat = new_v / c2
    del g
    upd = (m / c1) / (v_hat.sqrt() + cfg.eps)
    del v_hat
    if decay:  # decoupled weight decay on matrices only
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    mu["m"].copy_(m)


def _walk(p, g, mu, fn):
    if isinstance(p, dict):
        for k in p:
            _walk(p[k], g[k], mu[k], fn)
    else:
        fn(p, g, mu)


@torch.no_grad()
def update(cfg: OptConfig, grads, state, params):
    """Returns (params, state, metrics): the same trees, updated in
    place; metrics {"lr", "grad_norm"} as 0-d f32 tensors (the norm is
    the one before clipping)."""
    count = state["count"]
    count += 1
    lr = lr_at(cfg, count)
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gn + 1e-9), 1.0)
    c1 = 1 - cfg.b1 ** count.float()
    c2 = 1 - cfg.b2 ** count.float()

    def leaf(p, g, mu):
        parts = [p, g, mu["m"]] + (list(mu["v"].values())
                                    if isinstance(mu["v"], dict)
                                    else [mu["v"]])
        n = 0 if any(_split_dim0(t) for t in parts) else p.ndim

        def split(t):
            return leading_slices(t, n)
        v = mu["v"]
        vs = ([{"row": r, "col": c}
               for r, c in zip(split(v["row"]), split(v["col"]))]
              if isinstance(v, dict) else split(v))
        for ps, gs, ms, vi in zip(split(p), split(g), split(mu["m"]), vs):
            update_leaf(cfg, ps, gs, {"m": ms, "v": vi}, lr=lr, scale=scale,
                        c1=c1, c2=c2, decay=p.ndim >= 2)

    _walk(params, grads, state["mu"], leaf)
    return params, state, {"lr": lr, "grad_norm": gn}
