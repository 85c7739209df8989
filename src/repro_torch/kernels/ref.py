"""Plain PyTorch versions of the kernels of the kernel API.

Each is the oracle its CUDA kernel is held to on the card, and what the
kernel's wrapper runs for a tensor that lies on the CPU.  They keep the
rounding points of the JAX package's oracles (`repro/kernels/ref.py`):
products of bf16 values are exact in f32 and are summed in f32 (int32
for int8), and the output is cast once.  The f32 products go through
`torch.matmul`/`einsum`, so on the card they are true f32 only while
`torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
"""
from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32, or f64 for f64 inputs (the gradient tests' precision)."""
    return torch.promote_types(dtype, torch.float32)


def ref_matmul(x: torch.Tensor, y: torch.Tensor):
    """x @ y, summed in f32 (exactly, in int32, for int8) and cast once
    to int32 for int8, else to x's dtype."""
    if x.dtype != torch.int8:
        return torch.matmul(x.float(), y.float()).to(x.dtype)
    # CUDA has no integer matmul: f64 is exact while K * 2^14 < 2^53
    wide = torch.int64 if x.device.type == "cpu" else torch.float64
    return torch.matmul(x.to(wide), y.to(wide)).to(torch.int32)


def ref_attention(q, k, v, *, causal: bool, scale=None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd), H % KV == 0.  Scores in
    f32 (f64 for f64 inputs), causal mask top-left aligned (query i sees
    keys j <= i), p cast to v's dtype before the PV product, output in
    q's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    ct = compute_dtype(q.dtype)
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg.to(ct), k.to(ct)) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bkgqd", p.to(v.dtype).to(ct), v.to(ct))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def ref_ssd_intra(x, dt, dacs, b, c) -> torch.Tensor:
    """Direct quadratic intra-chunk SSD, in f32 (f64 for f64 inputs).

    x: (BC, Q, nh, hd); dt/dacs: (BC, Q, nh); b/c: (BC, Q, g, ds) with
    nh % g == 0, head h reading group h // (nh / g) (g = nh is the
    reference's per-head layout).  Returns ((C·Bᵀ) ∘ L ∘ dt_j) · X in x's
    dtype, L = exp(dacs_i − dacs_j) for i >= j, else 0.
    """
    Q, nh = x.shape[1], x.shape[2]
    ct = compute_dtype(x.dtype)
    b, c = (t.repeat_interleave(nh // t.shape[2], dim=2) for t in (b, c))
    cb = torch.einsum("zqhd,zkhd->zhqk", c.to(ct), b.to(ct))
    da = dacs.to(ct).transpose(1, 2)                     # (BC, nh, Q)
    seg = da[:, :, :, None] - da[:, :, None, :]
    upper = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    # masked before exp: no inf above the diagonal for autograd to meet
    L = seg.masked_fill(upper, float("-inf")).exp()
    m = cb * L * dt.to(ct).transpose(1, 2)[:, :, None, :]
    y = torch.einsum("zhqk,zkhd->zqhd", m, x.to(ct))
    return y.to(x.dtype)


def flash_bwd_scales(q, k, v, o, do, *, causal: bool, scale: float,
                     block: int = 512):
    """The root-sum-square of each attention gradient element's summands,
    in f32 (f64 for f64 inputs): for dq_id, sqrt(Σ_j (dS_ij·k_jd·scale)²);
    for dk_jd, sqrt(Σ_(i, g) (dS_ij·q_id·scale)²); for dv_jd,
    sqrt(Σ_(i, g) (P_ij·dO_id)²), with P and dS as `grad.flash_bwd_plain`
    forms them, blocked over `block` query rows.

    A backward that rounds P or dS to bf16 before a product moves each
    summand by at most 2^-9 of itself, in no common direction, so the
    element by ~2^-9 of this root-sum-square: where the summands cancel
    (Σ_j dS_ij = 0 for every row), that is far more than 2^-9 of the
    element."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    ct = compute_dtype(q.dtype)
    kf, vf = k.to(ct), v.to(ct)
    sq = torch.empty(q.shape, dtype=ct, device=q.device)
    sk = torch.zeros(k.shape, dtype=ct, device=q.device)
    sv = torch.zeros(v.shape, dtype=ct, device=q.device)
    keys = torch.arange(Sk, device=q.device)
    for i0 in range(0, Sq, block):
        i1 = min(i0 + block, Sq)
        n = i1 - i0
        qb, ob, dob = (t[:, i0:i1].to(ct).reshape(B, n, KV, G, hd)
                       for t in (q, o, do))
        s = torch.einsum("bqkgd,bjkd->bkgqj", qb, kf) * scale
        if causal:
            rows = torch.arange(i0, i1, device=q.device)
            s = s.masked_fill(rows[:, None] < keys[None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        d = (dob * ob).sum(-1).permute(0, 2, 3, 1)
        ds2 = (p * (torch.einsum("bqkgd,bjkd->bkgqj", dob, vf)
                    - d[..., None])).square()
        sq[:, i0:i1] = torch.einsum("bkgqj,bjkd->bqkgd", ds2, kf.square()
                                    ).sqrt().reshape(B, n, H, hd) * scale
        sk += torch.einsum("bkgqj,bqkgd->bjkd", ds2, qb.square())
        sv += torch.einsum("bkgqj,bqkgd->bjkd", p.square(), dob.square())
    return sq, sk.sqrt() * scale, sv.sqrt()


def ssd_bwd_scales(x, dt, dacs, b, c, dy):
    """The root-sum-square of each SSD intra-chunk gradient element's
    summands, in f32 (f64 for f64 inputs), a chunk at a time, with M, dM,
    W and dG as `grad.ssd_intra_bwd_plain` forms them: for dx_jp,
    sqrt(Σ_i (M_ij·dy_ip)²); for d dt_j, sqrt(Σ_i (dM_ij·G_ij·L_ij)²);
    for d dacs_q, sqrt(Σ_j W_qj² + Σ_i W_iq²); for dc_is, sqrt(Σ_j
    (dG_ij·b_js)²); for db_js, sqrt(Σ_i (dG_ij·c_is)²).  A backward that
    rounds M or dG to bf16 before a product moves each summand by at most
    2^-9 of itself, so the element by ~2^-9 of this root-sum-square."""
    BC, Q, nh, hd = x.shape
    g = b.shape[2]
    hpg = nh // g
    ct = compute_dtype(x.dtype)
    outs = [torch.empty(t.shape, dtype=ct, device=x.device)
            for t in (x, dt, dacs, b, c)]
    upper = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    for z in range(BC):
        xf, dyf = (t[z].to(ct).reshape(Q, g, hpg, hd) for t in (x, dy))
        bf, cf = b[z].to(ct), c[z].to(ct)                      # (Q, g, ds)
        da, dtj = (t[z].to(ct).reshape(Q, g, hpg).permute(1, 2, 0)
                   for t in (dacs, dt))                        # (g, hpg, Q)
        gm = torch.einsum("igs,jgs->gij", cf, bf)
        L = (da[..., :, None] - da[..., None, :]).masked_fill(
            upper, float("-inf")).exp()
        gl = gm[:, None] * L
        m = gl * dtj[..., None, :]
        dm = torch.einsum("ighp,jghp->ghij", dyf, xf)
        w = dm * m
        outs[0][z] = torch.einsum("ghij,ighp->jghp", m.square(),
                                  dyf.square()).sqrt().reshape(Q, nh, hd)
        outs[1][z] = (dm * gl).square().sum(-2).sqrt().permute(
            2, 0, 1).reshape(Q, nh)
        outs[2][z] = (w.square().sum(-1) + w.square().sum(-2)).sqrt(
            ).permute(2, 0, 1).reshape(Q, nh)
        dg2 = (dm * L * dtj[..., None, :]).sum(1).square()     # (g, Q, Q)
        outs[4][z] = torch.einsum("gij,jgs->igs", dg2, bf.square()).sqrt()
        outs[3][z] = torch.einsum("gij,igs->jgs", dg2, cf.square()).sqrt()
    return tuple(outs)
