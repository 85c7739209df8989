"""Shared model building blocks: norms, rope, activations, attention and
parameter init helpers.

All forward code is functional PyTorch over dicts of tensors.  The port
runs on one device, so the reference's `ShardCtx`, `constrain` and
`head_shardable` (a mesh and its sharding constraints) have no
counterpart here.  Full-sequence attention goes through the kernel API
(`kernels.ops.flash`, the flash kernel on the card, its plain version on
the CPU).  `remat` is the reference's `_remat` for the layer bodies.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 *statistics* but tensor math in x's dtype: only
    the variance reduction is upcast, as in the reference."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def _gelu(x):
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


def _relu2(x):
    return F.relu(x).square()


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu
    if name == "relu2":  # squared ReLU (nemotron)
        return _relu2
    raise ValueError(name)


def gated(name: str) -> bool:
    """Gated (SwiGLU-style) MLPs use wi+wg; relu2/gelu archs use a plain wi."""
    return name == "silu"


# ---------------------------------------------------------------------------
# rotary embeddings (llama-style rotate-half)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) or (S,).  In f32, cast back
    to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, hd/2)
    angles = angles[..., None, :]                           # over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd_v).

    The flash kernel through `ops.flash`, which on the card launches it
    and on the CPU runs its plain version.  A V narrower than q/k (MLA:
    hd_v < hd) is zero-padded to hd for the kernel and the output sliced
    back, which is exact: the padded columns of P·V are 0.  The
    reference's `q_offset` and `kv_len` (a query block placed past 0, a
    cache's valid length) have no counterpart: none of its models passes
    them, and decode attends through `decode_attention`.
    """
    hd, hd_v = q.shape[-1], v.shape[-1]
    if hd_v < hd:
        v = F.pad(v, (0, hd - hd_v))
    out = ops.flash(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal, scale=scale)
    return out[..., :hd_v] if hd_v < hd else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_index: torch.Tensor) -> torch.Tensor:
    """Single-position attention against a (possibly longer) cache, in
    plain PyTorch.

    q: (B, 1, H, hd); caches: (B, S, KV, hd).  Positions > cache_index masked.
    """
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qg.float(), k_cache.float()) \
        * hd ** -0.5
    valid = torch.arange(S, device=q.device) <= cache_index
    s = s.masked_fill(~valid[None, None, None], -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# per-layer recompute (the reference's `_remat`)
# ---------------------------------------------------------------------------
#: the matrix products with no batch dims, which `remat="dots"` saves
#: (the reference's `dots_with_no_batch_dims_saveable`)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots_policy)


def remat(cfg, fn, *args):
    """fn(*args), a layer body, under `cfg.remat` when grad mode is on:
    "nothing" keeps only the body's inputs for the backward and runs the
    body again there (`torch.utils.checkpoint`, non-reentrant, so the
    kernels' autograd Functions run again inside the recompute), "dots"
    also keeps its matrix products, "none" keeps everything.  With grad
    mode off (serving) it is a plain call."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_dots)
    if cfg.remat != "nothing":
        raise ValueError(f"remat policy {cfg.remat!r}")
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """N(0, (scale / sqrt(fan_in))²) drawn in f32 from `gen` on the
    default device (`models.api.init_params` sets it) and cast: the
    reference's shapes and std, from a Philox stream where the
    reference's is threefry."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen) * std
            ).to(dtype)


def stack_init(n: int, init_fn):
    """Stack n draws of `init_fn()` (a dict tree of tensors) along a new
    leading layer dim, filling the stacked tensors layer by layer so that
    only one layer's draws exist beside them (on the meta device, one
    call gives the shapes)."""
    first = init_fn()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    if tree_leaves(first)[0].device.type == "meta":
        return out                      # shapes only: nothing to draw
    for i in range(n):
        layer = first if i == 0 else init_fn()
        for dst, src in zip(tree_leaves(out), tree_leaves(layer)):
            dst[i].copy_(src)
    return out


def tree_map(fn, tree):
    """fn over every tensor of a dict tree, in the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a dict tree, in its insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]
