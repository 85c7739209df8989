"""Mamba2 (SSD -- state-space duality) blocks.

Prefill runs the chunked SSD algorithm (quadratic intra-chunk, linear
inter-chunk recurrence) through the kernel API's `ops.ssd`, whose
intra-chunk term is the SSD kernel on the card; `ssd_chunked` is the
reference's plain version of the whole scan.  Decode is the O(1)-state
recurrent step, in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import compute_dtype
from repro_torch.kernels.sharding import on_shards
from repro_torch.models.common import (ShardCtx, constrain, dense_init,
                                       gather_sequence, head_shardable,
                                       is_dtensor, rms_norm)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def mamba_init(gen, cfg: ModelConfig, dtype):
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * g * ds
    in_dim = 2 * di + 2 * g * ds + nh  # [z, x, B, C, dt]
    f32 = torch.float32
    dt = torch.empty(nh).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen).exp()
    return {
        "in_proj": dense_init(gen, (d, in_dim), dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_dim), dtype, 0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh)).to(f32),
        "D": torch.ones((nh,), dtype=f32),
        "dt_bias": torch.log(torch.expm1(dt)),
        "out_norm": torch.ones((di,), dtype=dtype),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------
def causal_conv(x, w, b):
    """Depthwise causal conv as W shifted multiplies.  x: (B, S, C); w: (W, C).

    On DTensors it runs on each device's shards (`_conv_on_shards`)."""
    if is_dtensor(x):
        return _conv_on_shards(x, w, b)
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = b
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _conv_on_shards(x, w, b):
    """`causal_conv` of DTensors: x split over the batch and the channels
    only (its sequence whole: the conv reaches W - 1 positions back), w
    and b over the channels as x is, the conv on each device's own
    shards.  The shifted slices of a DTensor split over the sequence
    would gather their gradients whole in the backward."""
    from torch.distributed.tensor import Replicate, Shard
    place = [p if p in (Shard(0), Shard(2)) else Replicate()
             for p in x.placements]
    ch = [Shard(0) if p == Shard(2) else Replicate() for p in place]
    wch = [Shard(1) if p == Shard(2) else Replicate() for p in place]
    return on_shards(causal_conv, (x, w, b), (place, wch, ch),
                     [(place, x.shape)])


def conv_step(x_new, conv_state, w, b):
    """x_new: (B, C); conv_state: (B, W-1, C) rolling buffer."""
    full = torch.cat([conv_state, x_new[:, None]], dim=1)   # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w) + b
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# SSD core (chunked)
# ---------------------------------------------------------------------------
def segsum(dA):
    """dA: (..., Q) -> (..., Q, Q) lower-triangular segment sums
    T[i, j] = sum_{k=j+1..i} dA[k] for i >= j, -inf above diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, -1)
    T = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return T.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state=None, return_final=False):
    """Chunked SSD scan, plain PyTorch (the reference's `ssd_chunked`):
    the plain version of the scan `mamba_apply` runs through `ops.ssd`.

    x : (B, S, nh, hd)     dt: (B, S, nh)      A: (nh,) (negative)
    Bm, Cm: (B, S, g, ds)  heads are grouped nh = g * hpg.
    Returns y: (B, S, nh, hd) [, final_state (B, nh, hd, ds)].
    """
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // g
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    f32 = compute_dtype(x.dtype)

    xc = x.reshape(Bsz, nc, Q, nh, hd)
    dtc = dt.reshape(Bsz, nc, Q, nh).to(f32)
    Bh = Bm.reshape(Bsz, S, g, 1, ds).expand(Bsz, S, g, hpg, ds) \
        .reshape(Bsz, nc, Q, nh, ds)
    Ch = Cm.reshape(Bsz, S, g, 1, ds).expand(Bsz, S, g, hpg, ds) \
        .reshape(Bsz, nc, Q, nh, ds)

    dA = dtc * A                                           # (B, nc, Q, nh)
    dA_cs = torch.cumsum(dA, dim=2)

    # ---- intra-chunk (quadratic within chunk) ----
    L = torch.exp(segsum(dA.movedim(3, 2)))                # (B,nc,nh,Q,Q)
    CB = torch.einsum("bcqhd,bckhd->bchqk", Ch.to(f32), Bh.to(f32))
    M = CB * L * dtc.movedim(2, 3)[..., None, :]           # × dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xc.to(f32))

    # ---- chunk states ----
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B, nc, Q, nh)
    w = dtc * decay_to_end
    states = torch.einsum("bcqhd,bcqh,bcqhp->bchpd",
                          Bh.to(f32), w, xc.to(f32))

    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (B, nc, nh)
    h = (torch.zeros((Bsz, nh, hd, ds), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,nh,hd,ds)

    # ---- inter-chunk contribution ----
    decay_in = torch.exp(dA_cs)                            # (B, nc, Q, nh)
    y_inter = torch.einsum("bcqhd,bcqh,bchpd->bcqhp",
                           Ch.to(f32), decay_in, h_prevs)

    y = (y_intra + y_inter).reshape(Bsz, S, nh, hd).to(x.dtype)
    if return_final:
        return y, h
    return y


def ssd_step(x, dt, A, Bm, Cm, h):
    """Single-token SSD recurrence.

    x: (B, nh, hd); dt: (B, nh); Bm/Cm: (B, g, ds); h: (B, nh, hd, ds).
    On a DTensor state it runs on each device's shards (`_step_on_shards`).
    """
    if is_dtensor(h):
        return _step_on_shards(x, dt, A, Bm, Cm, h)
    Bsz, nh, hd = x.shape
    g, ds = Bm.shape[1], Bm.shape[2]
    hpg = nh // g
    f32 = torch.float32
    dt = dt.to(f32)
    dA = torch.exp(dt * A)                                  # (B, nh)
    Bx = torch.einsum("bgd,bghp->bghpd", Bm.to(f32),
                      dt.reshape(Bsz, g, hpg)[..., None]
                      * x.reshape(Bsz, g, hpg, hd).to(f32))
    h = h * dA[..., None, None] + Bx.reshape(Bsz, nh, hd, ds)
    y = torch.einsum("bghpd,bgd->bghp", h.reshape(Bsz, g, hpg, hd, ds),
                     Cm.to(f32))
    return y.reshape(Bsz, nh, hd).to(x.dtype), h


def _step_on_shards(x, dt, A, Bm, Cm, h):
    """`ssd_step` with the state a DTensor: split over the batch and the
    heads as the state is (`launch.sharding`'s ssm_state), the groups of
    B/C first repeated r times, the fewest that split them alike (as
    `_pin_heads`), or the heads gathered where no r does; the step then
    runs on each device's shards.  Returns DTensors placed as the state.
    DTensor cannot split a sharded head dimension into (g, heads a
    group) where g does not divide the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    place = [p if p in (Shard(0), Shard(1)) else Replicate()
             for p in h.placements]
    ways = math.prod(mesh.size(i) for i, p in enumerate(place)
                     if p == Shard(1))
    nh, g = x.shape[1], Bm.shape[1]
    r = ways // math.gcd(g, ways)
    if r > 1 and (nh // g) % r == 0:
        Bm = Bm.repeat_interleave(r, dim=1)
        Cm = Cm.repeat_interleave(r, dim=1)
    elif r > 1:
        place = [Replicate() if p == Shard(1) else p for p in place]
    a_place = [Shard(0) if p == Shard(1) else Replicate() for p in place]
    return on_shards(ssd_step, (x, dt, A, Bm, Cm, h),
                     (place, place, a_place, place, place, place),
                     [(place, x.shape), (place, h.shape)])


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def _split_in_proj(cfg: ModelConfig, proj):
    di, g, ds = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * g * ds]
    dt = proj[..., di + di + 2 * g * ds:]
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC):
    di, g, ds = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    x = xBC[..., :di]
    Bm = xBC[..., di:di + g * ds]
    Cm = xBC[..., di + g * ds:]
    return x, Bm, Cm


def _pin_heads(ctx, x, dt, Bm, Cm):
    """The SSD's inputs head-sharded over the model axis, as the
    reference pins its per-head intermediates: x (B, S, nh, hd) and dt
    (B, S, nh) on nh, and B/C (B, S, g, ds) on their groups, each group
    first repeated r times, the fewest that make g·r divide the axis
    (the reference broadcasts them to one copy a head), so that every
    device holds whole groups of its heads.  Unchanged where nh does not
    divide the axis, or r does not divide a group's heads."""
    nh, g = x.shape[2], Bm.shape[2]
    if not head_shardable(nh, ctx):
        return x, dt, Bm, Cm
    n = ctx.mesh.shape[ctx.tp]
    r = n // math.gcd(g, n)
    if (nh // g) % r:
        return x, dt, Bm, Cm
    if r > 1:
        Bm = Bm.repeat_interleave(r, dim=2)
        Cm = Cm.repeat_interleave(r, dim=2)
    return (constrain(x, ctx, "dp", None, "tp", None),
            constrain(dt, ctx, "dp", None, "tp"),
            constrain(Bm, ctx, "dp", None, "tp", None),
            constrain(Cm, ctx, "dp", None, "tp", None))


def _sharded_projections(cfg: ModelConfig, p, u, ctx):
    """(z, x, B, C, dt) of `mamba_apply`, each its own column-parallel
    product with its columns of `in_proj` (and x, B, C each through the
    depthwise conv with their channels of it): the same values as
    slicing the whole projection, but a DTensor slices a split dimension
    only after gathering it, and the projection's parts do not fall on
    the model axis's shard boundaries, so slicing the (B, S, in_dim)
    projection would gather it whole, for each part.  Sliced so, the
    weights' columns are gathered instead (a few per cent of the
    bytes), then split again as the reference's spec splits them.  The
    reference's constraint on the whole projection applies to each
    part."""
    di, g, ds = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    bounds = [0, di, 2 * di, 2 * di + g * ds, 2 * di + 2 * g * ds,
              2 * di + 2 * g * ds + cfg.ssm_nheads]
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    u = gather_sequence(u, ctx)

    def cols(t, a, b):
        return t[..., a:b].redistribute(t.device_mesh, t.placements)

    parts = []
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        h = constrain(u @ cols(w, a, b), ctx, "dp", None, "tp")
        if 1 <= i <= 3:                  # x, B, C: the conv's channels
            c0, c1 = a - di, b - di
            h = F.silu(causal_conv(h, cols(cw, c0, c1), cols(cb, c0, c1)))
        parts.append(h)
    z, x, Bm, Cm, dt = parts
    return z, x, Bm, Cm, dt


def gated_norm(cfg: ModelConfig, y, z, scale):
    """The mixer's gated RMSNorm of y · silu(z): over all d_inner
    features or, with `cfg.ssm_grouped_norm`, in `ssm_ngroups` groups of
    d_inner / ngroups, each normalised on its own (Zamba2's)."""
    h = y * F.silu(z)
    if not cfg.ssm_grouped_norm:
        return rms_norm(h, scale, cfg.norm_eps)
    g = cfg.ssm_ngroups
    grouped = h.reshape(*h.shape[:-1], g, h.shape[-1] // g)
    return rms_norm(grouped, scale.reshape(g, -1),
                    cfg.norm_eps).reshape(h.shape)


def mamba_apply(cfg: ModelConfig, p, u, ctx: Optional[ShardCtx] = None):
    """Full-sequence Mamba2 mixer.  u: (B, S, d) (already normed).

    The SSD goes through `ops.ssd`: the intra-chunk kernel on the card,
    its plain version on the CPU, with the plain inter-chunk recurrence.
    The reference's `use_kernel` switch (its default the plain scan) has
    no counterpart.
    """
    B, S, _ = u.shape
    nh, hd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    if is_dtensor(u) and ctx is not None and ctx.size("tp") > 1:
        z, x, Bm, Cm, dt_raw = _sharded_projections(cfg, p, u, ctx)
    else:
        proj = u @ p["in_proj"]
        z, xBC, dt_raw = _split_in_proj(cfg, proj)
        xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
        x, Bm, Cm = _split_xbc(cfg, xBC)
    x = x.reshape(B, S, nh, hd)
    if not head_shardable(g, ctx):
        # a DTensor cannot split g·ds into g groups the axis does not
        # divide: B/C gathered over it (g·ds channels a token)
        Bm = constrain(Bm, ctx, "dp", None, None)
        Cm = constrain(Cm, ctx, "dp", None, None)
    Bm = Bm.reshape(B, S, g, ds)
    Cm = Cm.reshape(B, S, g, ds)
    # softplus in the compute dtype; dt is upcast to f32 inside the SSD
    dt = F.softplus(dt_raw + p["dt_bias"].to(dt_raw.dtype))
    A = -torch.exp(p["A_log"])
    x, dt, Bm, Cm = _pin_heads(ctx, x, dt, Bm, Cm)
    y = ops.ssd(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(B, S, cfg.d_inner)
    y = constrain(y, ctx, "dp", None, "tp")
    y = gated_norm(cfg, y, z, p["out_norm"])
    out = y @ p["out_proj"]
    return constrain(out, ctx, "dp", "tp", None)


def mamba_decode(cfg: ModelConfig, p, u, ssm_state, conv_state):
    """Single-token step.  u: (B, 1, d); returns (out, ssm_state, conv_state),
    new tensors (the caller writes them back)."""
    B = u.shape[0]
    nh, hd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    f32 = torch.float32
    proj = u[:, 0] @ p["in_proj"]
    z, xBC, dt_raw = _split_in_proj(cfg, proj)
    xBC, conv_state = conv_step(xBC, conv_state, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    x, Bm, Cm = _split_xbc(cfg, xBC)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_step(x.reshape(B, nh, hd), dt, A,
                            Bm.reshape(B, g, ds), Cm.reshape(B, g, ds),
                            ssm_state)
    y = y + (p["D"][:, None] * x.reshape(B, nh, hd).to(f32)).to(y.dtype)
    y = y.reshape(B, cfg.d_inner)
    y = rms_norm(y * F.silu(z.to(f32)).to(y.dtype), p["out_norm"],
                 cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], ssm_state, conv_state
