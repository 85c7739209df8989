"""Shared model building blocks: norms, rope, activations, attention,
sharding-constraint plumbing and parameter init helpers.

All forward code is functional PyTorch over dicts of tensors.  Sharding
is expressed through an optional `ShardCtx`, as in the reference: with
parameters placed as DTensors on its mesh, `constrain` redistributes an
activation to the reference's layout at each of the reference's
constraint sites; on a plain tensor, or with no ctx, every constraint is
the identity, so the same code runs unsharded, bit for bit as before.
Full-sequence attention goes through the kernel API (`kernels.ops.flash`,
the flash kernel on the card, its plain version on the CPU).  `remat` is
the reference's `_remat` for the layer bodies.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.kernels.sharding import (contiguous_strides, is_dtensor,
                                          on_shards)


# ---------------------------------------------------------------------------
# sharding context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardCtx:
    """Carries the mesh + logical axis bindings into the model code.

    dp : axis name(s) carrying the batch (e.g. ("pod", "data") multi-pod)
    tp : tensor-parallel axis name ("model"), or None when the model runs
         pure-DP/FSDP (small dense models)
    ep : expert-parallel axes; None -> tp.  Serving uses the FULL mesh
         (EP², one DeepSeek-V3 expert per device).
    """

    mesh: object            # launch.mesh.Mesh
    dp: tuple
    tp: Optional[str]
    ep: Optional[tuple] = None

    @property
    def ep_axes(self):
        return self.ep if self.ep is not None else self.tp

    @property
    def ep_covers_dp(self) -> bool:
        if self.ep is None:
            return False
        return any(a in self.ep for a in self.dp)

    def size(self, axes) -> int:
        """Devices over the logical axes "dp", "tp" or "ep"."""
        names = {"dp": self.dp, "tp": self.tp, "ep": self.ep_axes}[axes]
        if names is None:
            return 1
        names = (names,) if isinstance(names, str) else names
        return math.prod(self.mesh.shape[a] for a in names)

    def spec(self, *axes, shape=None) -> tuple:
        """The DTensor placements of a spec in logical names: "dp"
        (batch), "tp" (model), "ep" (experts), None (replicated).  With
        a tensor's `shape`, each dimension takes the reference's
        divisibility guard (`launch.sharding._fit`): axes whose size does
        not divide it fall back to the trailing one, else to none (XLA
        pads such a dimension instead; DTensor cannot view an unevenly
        split one)."""
        from repro_torch.launch.sharding import _fit, placements

        def resolve(a):
            if a == "dp":
                return self.dp
            if a == "tp":
                return self.tp
            if a == "ep":
                return self.ep_axes
            return a
        spec = tuple(resolve(a) for a in axes)
        if shape is not None:
            spec = tuple(_fit(n, self.mesh, a) for n, a in zip(shape, spec))
        return placements(spec, self.mesh)


def constrain(x: torch.Tensor, ctx: Optional[ShardCtx], *axes):
    """The reference's `with_sharding_constraint`: a DTensor redistributed
    to the placements of `axes` (logical names, as `ShardCtx.spec`, each
    dimension divisibility-guarded), and its gradient placed so in the
    backward, as jax constrains a cotangent too; the identity on a plain
    tensor or without a ctx."""
    if ctx is None or not is_dtensor(x):
        return x
    want = ctx.spec(*axes, shape=tuple(x.shape))
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _PlaceGrad.apply(x, want)
    return x


class _PlaceGrad(torch.autograd.Function):
    """The identity, whose backward places the gradient as `placements`
    (DTensor would otherwise keep whatever placements the backward's ops
    chose, replicating work the forward split).  A partial sum is left
    partial where the constraint replicates: its reduction then meets the
    split that follows (a reduce-scatter, where XLA fuses the all-reduce
    and the slice)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not is_dtensor(grad):
            return grad, None
        from torch.distributed.tensor import Partial, Replicate
        want = tuple(g if isinstance(g, Partial) and t == Replicate() else t
                     for g, t in zip(grad.placements, ctx.placements))
        if tuple(grad.placements) != want:
            grad = grad.redistribute(grad.device_mesh, want)
        return grad, None


def gather_sequence(x: torch.Tensor, ctx: Optional[ShardCtx]):
    """x (B, S, d), split over the sequence on the residual stream (`_sp`),
    gathered over it once before the products that need every position:
    XLA gathers it once for all of them, where a DTensor would gather it
    again for each product."""
    if ctx is None or not is_dtensor(x):
        return x
    return constrain(x, ctx, "dp", *([None] * (x.ndim - 1)))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens], the embedding gather.  A DTensor table is first
    gathered over every mesh axis but the one that splits its vocabulary
    (the FSDP all-gather of a weight), then looked up by `F.embedding`,
    whose rule splits the lookup and its backward over the vocabulary:
    an index's backward would make the whole table's gradient on every
    device, and DTensor's lookup on a table split over the tokens' own
    axis as well masks the wrong rows."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate, Shard
        vocab = [p if p == Shard(0) else Replicate()
                 for p in table.placements]
        return F.embedding(tokens, table.redistribute(table.device_mesh,
                                                      vocab))
    return table[tokens]


def zeros(shape: tuple, dtype, like: torch.Tensor,
          ctx: Optional[ShardCtx], *axes) -> torch.Tensor:
    """torch.zeros(shape) on `like`'s device, placed as a constraint of
    `axes` places it: under a ctx and a DTensor `like`, made as this
    device's shards alone (a plain tensor of the global shape would be
    whole on every device before a constraint split it)."""
    if ctx is None or not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    place = ctx.spec(*axes, shape=shape)
    with _disable_current_modes():
        local, _ = compute_local_shape_and_global_offset(
            shape, like.device_mesh, place)
    out = torch.zeros(local, dtype=dtype, device=like.to_local().device)
    return DTensor.from_local(out, like.device_mesh, place, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))



def head_shardable(n: int, ctx: Optional[ShardCtx]) -> bool:
    """True if a head-count dimension divides the tensor-parallel axis size."""
    if ctx is None or ctx.tp is None:
        return False
    return n % ctx.mesh.shape[ctx.tp] == 0


def sharded(ctx: Optional[ShardCtx]):
    """The context a model body runs in under `ctx`: plain tensors that
    meet a DTensor (positions, masks, the rope table: the same values on
    every rank) count as replicated on its mesh.  Nothing without a ctx."""
    if ctx is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 *statistics* but tensor math in x's dtype: only
    the variance reduction is upcast, as in the reference.  On a DTensor
    split along its last dim it runs on each device's shards
    (`_rms_norm_on_shards`)."""
    if is_dtensor(x) and any(p.is_shard(x.ndim - 1) for p in x.placements):
        return _rms_norm_on_shards(x, scale, eps)
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def _rms_norm_on_shards(x, scale, eps: float):
    """`rms_norm` of a DTensor split along the normalised (last) dim: each
    device's sum of squares of its features, summed over the devices that
    split them (one all-reduce of the (..., 1) f32 statistic, as XLA
    reduces it), then the norm on its own shards.  DTensor's own plan for
    the mean and its backward differs between PyTorch versions (an
    all-to-all of the activation, or its gradient gathered whole)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last, n = x.device_mesh, x.ndim - 1, x.shape[-1]
    place = [p if p.is_shard() else Replicate() for p in x.placements]
    feat = [Shard(0) if p.is_shard(last) else Replicate() for p in place]
    part = [Partial() if p.is_shard(last) else p for p in place]
    whole = [Replicate() if p.is_shard(last) else p for p in place]

    def local(xl, sl):
        ss = _SumOver.apply(xl.float().square().sum(-1, keepdim=True), mesh,
                            part, whole)
        inv = torch.rsqrt(ss / n + eps).to(xl.dtype)
        return xl * inv * sl.to(xl.dtype)
    return on_shards(local, (x, scale), (place, feat), [(place, x.shape)])


class _SumOver(torch.autograd.Function):
    """A local tensor summed over the devices of the mesh dims that
    `part` marks Partial (an all-reduce; `whole` the result's
    placements).  Each device's gradient of the sum holds only its own
    shards' part, so the backward sums those alike."""

    @staticmethod
    def forward(ctx, t, mesh, part, whole):
        ctx.layout = mesh, part, whole
        return _sum_over(t, mesh, part, whole)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, *ctx.layout), None, None, None


def _sum_over(t, mesh, part, whole):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, part, run_check=False) \
        .redistribute(mesh, whole).to_local()


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
    if name == "geglu":  # Zamba2's gated GELU: the exact, erf form
        return F.gelu
    if name == "relu2":  # squared ReLU (nemotron)
        return _relu2
    raise ValueError(name)


def gated(name: str) -> bool:
    """Gated MLPs: SwiGLU's wi+wg, and geglu's one gate_up product split
    in halves (gate, up); relu2/gelu archs use a plain wi."""
    return name in ("silu", "geglu")


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
                    causal: bool, scale: Optional[float] = None,
                    ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd_v).

    The flash kernel through `ops.flash`, which on the card launches it
    and on the CPU runs its plain version.  A V narrower than q/k (MLA:
    hd_v < hd) is zero-padded to hd for the kernel and the output sliced
    back, which is exact: the padded columns of P·V are 0.  The
    reference's `q_offset` and `kv_len` (a query block placed past 0, a
    cache's valid length) have no counterpart: none of its models passes
    them, and decode attends through `decode_attention`.

    Under a `ctx` whose model axis divides H, q is pinned head-sharded,
    as the reference pins it, and so are k and v: where KV does not
    divide the axis, each kv head is first repeated r times, the fewest
    that make KV·r divide it (the reference repeats all G), so that the
    kernel's sharding rule keeps every GQA group on one device.
    """
    H, KV = q.shape[2], k.shape[2]
    if head_shardable(H, ctx):
        q = constrain(q, ctx, "dp", None, "tp", None)
        n = ctx.mesh.shape[ctx.tp]
        r = n // math.gcd(KV, n)
        if r > 1 and (H // KV) % r == 0:
            k = k.repeat_interleave(r, dim=2)
            v = v.repeat_interleave(r, dim=2)
        if head_shardable(k.shape[2], ctx):
            k = constrain(k, ctx, "dp", None, "tp", None)
            v = constrain(v, ctx, "dp", None, "tp", None)
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
    On DTensor caches it runs on each device's shards (`_decode_on_shards`).
    """
    if is_dtensor(k_cache):
        return _decode_on_shards(q, k_cache, v_cache, cache_index)
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


def _decode_on_shards(q, k_cache, v_cache, cache_index):
    """`decode_attention` with DTensor caches, placed as `launch.sharding`
    places them (batch, and kv heads or, where KV does not divide the
    model axis, the sequence): q placed to match (its H split with the kv
    heads, whole over a split sequence), the scores and P·V on each
    device's shards, and where the sequence is split, the softmax's max
    and sum and P·V reduced over its shards (a flash-decoding
    combination).  DTensor's own einsum flattens dimensions split over
    different mesh axes together, and its redistribution planner then
    searches for minutes a call on the 2 x 16 x 16 mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    mesh = k_cache.device_mesh
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    kv_place = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
                for p in k_cache.placements]
    q_place = [p if p in (Shard(0), Shard(2)) else Replicate()
               for p in kv_place]
    k = k_cache.redistribute(mesh, kv_place)
    v = v_cache.redistribute(mesh, kv_place)
    with _disable_current_modes():
        _, off = compute_local_shape_and_global_offset(tuple(k.shape), mesh,
                                                       kv_place)
    kl, vl = k.to_local(), v.to_local()
    ql = q.redistribute(mesh, q_place).to_local()
    qg = ql.reshape(ql.shape[0], kl.shape[2], H // KV, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qg.float(), kl.float()) * hd ** -0.5
    idx = cache_index.full_tensor() if is_dtensor(cache_index) \
        else cache_index
    valid = torch.arange(kl.shape[1], device=kl.device) + off[1] <= idx
    s = s.masked_fill(~valid[None, None, None], -math.inf)
    split = Shard(1) in kv_place

    def over_sequence(t, op):
        """t, (B, KV, G, .) on this device's keys, reduced (op) over the
        devices that split the sequence."""
        if not split:
            return t
        part = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
                else Partial(op) if p == Shard(1) else Replicate()
                for p in kv_place]
        whole = [Replicate() if isinstance(p, Partial) else p for p in part]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, whole).to_local()
    if split:
        m = over_sequence(s.amax(-1, keepdim=True), "max")
        p = torch.exp(s - m)
        den = over_sequence(p.sum(-1, keepdim=True), "sum")
    else:
        p = torch.softmax(s, dim=-1)
    o = over_sequence(torch.einsum("bkgj,bjkd->bkgd", p.to(vl.dtype).float(),
                                   vl.float()), "sum")
    if split:
        o = o / den
    hd_v = vl.shape[-1]
    out = o.reshape(o.shape[0], 1, -1, hd_v).to(q.dtype)
    return DTensor.from_local(out, mesh, q_place, run_check=False,
                              shape=(B, 1, H, hd_v),
                              stride=(H * hd_v, H * hd_v, hd_v, 1))


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


def _recomputed(fn):
    """fn, opening the `train.recompute` span when it runs again inside
    the backward: autograd is then executing a graph task."""
    def body(*args):
        if torch._C._current_graph_task_id() == -1:
            return fn(*args)
        with spans.span(spans.RECOMPUTE):
            return fn(*args)
    return body


def remat(cfg, fn, *args):
    """fn(*args), a layer body, under `cfg.remat` when grad mode is on:
    "nothing" keeps only the body's inputs for the backward and runs the
    body again there (`torch.utils.checkpoint`, non-reentrant, so the
    kernels' autograd Functions run again inside the recompute, under
    the `train.recompute` span), "dots" also keeps its matrix products,
    "none" keeps everything.  With grad mode off (serving) it is a plain
    call."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    if cfg.remat == "dots":
        return checkpoint(_recomputed(fn), *args, use_reentrant=False,
                          context_fn=_save_dots)
    if cfg.remat != "nothing":
        raise ValueError(f"remat policy {cfg.remat!r}")
    return checkpoint(_recomputed(fn), *args, use_reentrant=False)


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
