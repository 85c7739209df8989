"""Mamba2 (SSD -- state-space duality) blocks.

Prefill runs the chunked SSD algorithm (quadratic intra-chunk, linear
inter-chunk recurrence) through the kernel API's `ops.ssd`, whose
intra-chunk term is the SSD kernel on the card; `ssd_chunked` is the
reference's plain version of the whole scan.  Decode is the O(1)-state
recurrent step, in plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import compute_dtype
from repro_torch.models.common import dense_init, rms_norm


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
    """Depthwise causal conv as W shifted multiplies.  x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = b
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out


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
    """
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


def mamba_apply(cfg: ModelConfig, p, u):
    """Full-sequence Mamba2 mixer.  u: (B, S, d) (already normed).

    The SSD goes through `ops.ssd`: the intra-chunk kernel on the card,
    its plain version on the CPU, with the plain inter-chunk recurrence.
    The reference's `use_kernel` switch (its default the plain scan) has
    no counterpart.
    """
    B, S, _ = u.shape
    nh, hd, g, ds = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    proj = u @ p["in_proj"]
    z, xBC, dt_raw = _split_in_proj(cfg, proj)
    xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x, Bm, Cm = _split_xbc(cfg, xBC)
    x = x.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, g, ds)
    Cm = Cm.reshape(B, S, g, ds)
    # softplus in the compute dtype; dt is upcast to f32 inside the SSD
    dt = F.softplus(dt_raw + p["dt_bias"].to(dt_raw.dtype))
    A = -torch.exp(p["A_log"])
    y = ops.ssd(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + p["D"].to(y.dtype)[:, None] * x
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


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
