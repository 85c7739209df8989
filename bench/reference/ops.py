"""Plain PyTorch building blocks of the reference models, computed in f32.

Nothing here imports the program under test.  `Prec` decides how the
matrix products of the projections and the output head are computed:
"f32" (TF32 off, set by `strict_f32`) is the reference itself; "fp8"
rounds both operands of each such product to float8_e4m3fn with one
scale a tensor first, the control that the comparison has to reject.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def strict_f32() -> None:
    """f32 products in true f32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()          # rounded forward, straight-through


class Prec:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            a, w = _fp8(a), _fp8(w)
        return a @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """Rotate-half rotary embedding of x (B, S, heads, hd) at 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attn_rows(q, k, v):
    """Causal softmax attention of one batch row and a run of kv heads:
    q (S, KV, G, hd), k/v (S, KV, hd)."""
    S, hd = q.shape[0], q.shape[-1]
    s = torch.einsum("ikgd,jkd->kgij", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("kgij,jkd->ikgd", p, v)


def attention(q, k, v, kv_block: int):
    """q (B, S, H, hd), k/v (B, S, KV, hd); query head h reads kv head
    h // (H / KV).  Computed a batch row and `kv_block` kv heads at a
    time; under grad each piece is recomputed in the backward, so no
    (H, S, S) matrix outlives its piece."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    rows = []
    for b in range(B):
        parts = []
        for k0 in range(0, KV, kv_block):
            sl = slice(k0, min(k0 + kv_block, KV))
            args = (qg[b, :, sl], k[b, :, sl], v[b, :, sl])
            parts.append(checkpoint(_attn_rows, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _attn_rows(*args))
        rows.append(torch.cat(parts, dim=1))
    return torch.stack(rows).reshape(B, S, H, hd)


def gqa(c, p, x, prec):
    B, S, _ = x.shape
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = rope(prec.mm(x, p["wq"]).reshape(B, S, H, hd), c["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).reshape(B, S, KV, hd), c["rope_theta"])
    v = prec.mm(x, p["wv"]).reshape(B, S, KV, hd)
    o = attention(q, k, v, c.get("ref_kv_block", KV))
    return prec.mm(o.reshape(B, S, H * hd), p["wo"])


def gated_mlp(p, x, prec):
    return prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]), p["wo"])


def causal_conv(x, w, b):
    """Depthwise causal convolution: x (B, S, C), w (W, C), b (C,)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return b + sum(xp[:, i:i + S] * w[i] for i in range(W))


def ssd(x, dt, A, Bm, Cm, chunk: int):
    """Mamba2's state-space scan, y_t = Σ_{s<=t} (C_t·B_s) exp(Σ_{s<r<=t}
    dt_r A) dt_s x_s, by chunks: quadratic inside a chunk, a state
    carried between chunks.  x (B, S, nh, hd), dt (B, S, nh), A (nh,),
    Bm/Cm (B, S, g, ds); head h reads group h // (nh / g)."""
    Bz, S, nh, hd = x.shape
    g, ds = Bm.shape[2:]
    Q = min(chunk, S)
    nc = S // Q
    r = nh // g
    x = x.reshape(Bz, nc, Q, nh, hd)
    dt = dt.reshape(Bz, nc, Q, nh)
    Bg = Bm.reshape(Bz, nc, Q, g, ds)
    Cg = Cm.reshape(Bz, nc, Q, g, ds)
    acs = torch.cumsum(dt * A, dim=2)                       # (Bz, nc, Q, nh)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]     # i, j
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~mask[..., None], float("-inf")))
    cb = torch.einsum("bcigs,bcjgs->bcijg", Cg, Bg).repeat_interleave(r, -1)
    m = cb * decay * dt[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", m, x)
    del seg, decay, cb, m
    Bh = Bg.repeat_interleave(r, dim=3)                     # (Bz, nc, Q, nh, ds)
    Ch = Cg.repeat_interleave(r, dim=3)
    w = torch.exp(acs[:, :, -1:, :] - acs) * dt
    states = torch.einsum("bcjh,bcjhs,bcjhp->bchps", w, Bh, x)
    h = torch.zeros(Bz, nh, hd, ds, dtype=x.dtype, device=x.device)
    before = []
    for ci in range(nc):
        before.append(h)
        h = h * torch.exp(acs[:, ci, -1, :])[..., None, None] + states[:, ci]
    hp = torch.stack(before, dim=1)                         # (Bz, nc, nh, hd, ds)
    y = y + torch.einsum("bcihs,bchps,bcih->bcihp", Ch, hp, torch.exp(acs))
    return y.reshape(Bz, S, nh, hd)


def mamba(c, p, u, prec):
    """Mamba2 mixer of u (B, S, d), already normed."""
    B, S, _ = u.shape
    di = c["ssm_expand"] * c["d_model"]
    g, ds, hd = c["ssm_ngroups"], c["ssm_state"], c["ssm_head_dim"]
    nh = di // hd
    proj = prec.mm(u, p["in_proj"])
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * g * ds]
    dt = F.softplus(proj[..., 2 * di + 2 * g * ds:] + p["dt_bias"])
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(B, S, nh, hd)
    Bm = xbc[..., di:di + g * ds].reshape(B, S, g, ds)
    Cm = xbc[..., di + g * ds:].reshape(B, S, g, ds)
    y = ssd(xs, dt, -torch.exp(p["A_log"]), Bm, Cm, c["ssm_chunk"])
    y = (y + p["D"][:, None] * xs).reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], c["norm_eps"])
    return prec.mm(y, p["out_proj"])


def token_nll_sum(h, w, labels, prec):
    """Σ over rows of logsumexp(h·w) − (h·w)[label]; h (N, d), w (d, V)."""
    logits = prec.mm(h, w)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - ll).sum()
