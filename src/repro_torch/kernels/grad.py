"""Gradients through the flash and SSD kernels.

The kernels' outputs are filled by a launch PyTorch's autograd cannot
see, so a model that called them directly would train with no gradient
through attention or the SSD's intra-chunk term.  `FlashAttention` and
`SSDIntra` wrap them in `torch.autograd.Function`s: the forward is the
kernel's wrapper (the kernel on the card, its plain version on the CPU)
and the backward is the explicit vector-Jacobian product, in plain
PyTorch.  The reference has no `custom_vjp` (its Pallas kernels have no
backward), so there is no TPU backward kernel to port.

`kernels.ops.flash` and `kernels.ops.ssd` route through these only when
grad mode is on and an input requires grad; the kernels' wrappers raise
on CUDA inputs that would need a gradient, so nothing bypasses them.
The backwards compute in f32 (f64 for f64 inputs) and return gradients
in the inputs' dtypes.  `flash_bwd` and `ssd_intra_bwd` are looked up
when the backward runs, so a check can swap in a broken one.

On DTensors the forwards run through the ops' sharding rules, which
split the work only over independent (batch, chunk, head) slices, and
each backward runs on the local shards placed as the forward's output
(`_on_shards`), so a device's backward is the plain one on its slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sharding, ssd_scan
from repro_torch.kernels.ref import compute_dtype

#: query rows a block of the flash backward: its f32 scores are
#: (B, H, block, Sk)
FLASH_BWD_BLOCK = 512
#: elements of one (chunks, nh, Q, Q) f32 block of the SSD backward
SSD_BWD_ELEMENTS = 1 << 25


def flash_bwd(q, k, v, o, do, *, causal: bool, scale: float):
    """(dq, dk, dv) of softmax attention, blocked over query rows.

    q/o/do: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); GQA groups of H / KV
    query heads share a kv head, whose dk and dv sum over the group.
    Per block: S = q·kᵀ·scale (causal mask top-left aligned), P =
    softmax(S) over the whole key row, D = rowsum(dO ∘ O) with the
    forward's own O, dS = P ∘ (dO·vᵀ − D), dq = dS·k·scale, dk += dSᵀ·q
    ·scale, dv += Pᵀ·dO.  Memory is O(block × Sk) a (batch, head).
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    ct = compute_dtype(q.dtype)
    kf, vf = k.to(ct), v.to(ct)
    dq = torch.empty_like(q)
    dk = torch.zeros((B, Sk, KV, hd), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    keys = torch.arange(Sk, device=q.device)
    for i0 in range(0, Sq, FLASH_BWD_BLOCK):
        i1 = min(i0 + FLASH_BWD_BLOCK, Sq)
        n = i1 - i0
        qb = q[:, i0:i1].to(ct).reshape(B, n, KV, G, hd)
        ob = o[:, i0:i1].to(ct).reshape(B, n, KV, G, hd)
        dob = do[:, i0:i1].to(ct).reshape(B, n, KV, G, hd)
        s = torch.einsum("bqkgd,bjkd->bkgqj", qb, kf) * scale
        if causal:
            rows = torch.arange(i0, i1, device=q.device)
            s = s.masked_fill(rows[:, None] < keys[None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        d = (dob * ob).sum(-1).permute(0, 2, 3, 1)            # (B, KV, G, n)
        ds = p * (torch.einsum("bqkgd,bjkd->bkgqj", dob, vf) - d[..., None])
        dq[:, i0:i1] = (torch.einsum("bkgqj,bjkd->bqkgd", ds, kf) * scale
                        ).reshape(B, n, H, hd).to(q.dtype)
        dk += torch.einsum("bkgqj,bqkgd->bjkd", ds, qb) * scale
        dv += torch.einsum("bkgqj,bqkgd->bjkd", p, dob)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def ssd_intra_bwd(x, dt, dacs, b, c, dy):
    """(dx, d dt, d dacs, db, dc) of the intra-chunk SSD term
    Y_i = Σ_{j<=i} M_ij X_j, M = G ∘ L ∘ dt_j per head, G = C·Bᵀ of the
    head's group, L_ij = exp(dacs_i − dacs_j) for j <= i (else 0).

    dX = Mᵀ·dY and dM = dY·Xᵀ; dG = Σ over the group's heads of
    dM ∘ L ∘ dt_j, so dC = dG·B and dB = dGᵀ·C; d dt_j = Σ_i dM_ij G_ij
    L_ij; with W = dM ∘ M, d dacs_i += Σ_j W_ij and d dacs_j −= Σ_i W_ij.
    All in f32 (f64 for f64 inputs), blocked over chunks.  The card's
    kernels round M to x's dtype before M·X (as the reference's
    `_ssd_kernel` does); this backward does not.
    """
    BC, Q, nh, hd = x.shape
    g, ds = b.shape[-2:]
    hpg = nh // g
    ct = compute_dtype(x.dtype)
    dx = torch.empty_like(x)
    ddt = torch.empty(dt.shape, dtype=dt.dtype, device=x.device)
    ddacs = torch.empty(dacs.shape, dtype=dacs.dtype, device=x.device)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    upper = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    step = max(1, SSD_BWD_ELEMENTS // (nh * Q * Q))
    for z0 in range(0, BC, step):
        z = slice(z0, min(z0 + step, BC))
        n = z.stop - z.start
        xf = x[z].to(ct).reshape(n, Q, g, hpg, hd)
        dyf = dy[z].to(ct).reshape(n, Q, g, hpg, hd)
        bf, cf = b[z].to(ct), c[z].to(ct)                     # (n, Q, g, ds)
        da = dacs[z].to(ct).reshape(n, Q, g, hpg).permute(0, 2, 3, 1)
        dtj = dt[z].to(ct).reshape(n, Q, g, hpg).permute(0, 2, 3, 1)
        gm = torch.einsum("zigs,zjgs->zgij", cf, bf)          # (n, g, Q, Q)
        seg = (da[..., :, None] - da[..., None, :]).masked_fill(
            upper, float("-inf"))
        L = seg.exp()                                         # (n, g, hpg, Q, Q)
        gl = gm[:, :, None] * L
        m = gl * dtj[..., None, :]
        dm = torch.einsum("zighp,zjghp->zghij", dyf, xf)
        dx[z] = torch.einsum("zghij,zighp->zjghp", m, dyf).reshape(
            n, Q, nh, hd).to(x.dtype)
        w = dm * m
        ddacs[z] = (w.sum(-1) - w.sum(-2)).permute(0, 3, 1, 2).reshape(
            n, Q, nh).to(dacs.dtype)
        ddt[z] = (dm * gl).sum(-2).permute(0, 3, 1, 2).reshape(
            n, Q, nh).to(dt.dtype)
        dg = (dm * L * dtj[..., None, :]).sum(2)              # (n, g, Q, Q)
        dc[z] = torch.einsum("zgij,zjgs->zigs", dg, bf).to(c.dtype)
        db[z] = torch.einsum("zgij,zigs->zjgs", dg, cf).to(b.dtype)
    return dx, ddt, ddacs, db, dc


def _layout(out):
    """(mesh, placements) of a forward's DTensor output, else None."""
    return (out.device_mesh, out.placements) \
        if sharding.is_dtensor(out) else None


def _on_shards(fn, layout, *tensors, **kw):
    """fn(*tensors, **kw), or, under a forward output's `layout`, fn on
    the local shards of `tensors` each placed so, its results DTensors
    placed alike with the global shapes of the first `tensors`."""
    if layout is None:
        return fn(*tensors, **kw)
    _, place = layout
    return sharding.on_shards(lambda *t: fn(*t, **kw), tensors,
                              [place] * len(tensors),
                              [(place, t.shape) for t in tensors])


class FlashAttention(torch.autograd.Function):
    """`flash_attention_kernel` forward, `flash_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        out = fa.flash_attention_kernel(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.layout = _layout(out)
        ctx.causal = causal
        ctx.scale = q.shape[-1] ** -0.5 if scale is None else scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _on_shards(flash_bwd, ctx.layout, q, k, v, o, do,
                                causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


class SSDIntra(torch.autograd.Function):
    """`ssd_intra_kernel` forward, `ssd_intra_bwd` backward."""

    @staticmethod
    def forward(ctx, x, dt, dacs, b, c):
        ctx.save_for_backward(x, dt, dacs, b, c)
        y = ssd_scan.ssd_intra_kernel(x, dt, dacs, b, c)
        ctx.layout = _layout(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _on_shards(ssd_intra_bwd, ctx.layout, *ctx.saved_tensors, dy)


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` requires grad: the call must
    go through a Function to carry a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
