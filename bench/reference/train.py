"""The plain reference of a train step: next-token loss, its gradient by
autograd one unit at a time (each unit's forward runs again in the
backward, so only the residual stream between units is kept), and
AdamW with the configured moment storage, all arithmetic in f32.

Parameters and the first moment are stored in the dtypes the
configuration gives them (bf16 weights, no f32 master copy, a bf16
first moment): an update smaller than half a bf16 step of a weight
leaves that weight as it was, here as in a run of the configuration.
`fault` plants one of the faults the comparison has to catch.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from reference import models, ops
from reference.models import get, views

#: rows of the output head computed at a time
HEAD_ROWS = 4096


def lr_at(o: dict, step: int) -> float:
    if step < o["warmup_steps"]:
        return o["peak_lr"] * step / max(o["warmup_steps"], 1)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["decay_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["min_lr"] + 0.5 * (o["peak_lr"] - o["min_lr"]) \
        * (1 + math.cos(math.pi * prog))


def pieces(leaf, t):
    """(name, tensor) of each compared piece of a leaf: a layer of a
    stacked leaf, the whole tensor otherwise."""
    name = "/".join(leaf.path)
    if leaf.stacked:
        return [(f"{name}[{i}]", t[i]) for i in range(t.shape[0])]
    return [(name, t)]


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _slices(t, ndim: int):
    """The leaf's units of f32 work: its layers where it stacks them
    (ndim >= 3), else the whole; `t` is the leaf or one of its states."""
    return t.unbind(0) if ndim >= 3 else (t,)


class RefTrainer:
    def __init__(self, c: dict, opt: dict, params, prec: ops.Prec,
                 fault: str | None = None):
        self.c, self.o, self.params, self.prec = c, opt, params, prec
        self.fault = fault
        self.layout = models.layout(c)
        self.count = 0
        mdt = getattr(torch, opt["moment_dtype"])
        self.m, self.v = {}, {}
        for lf in self.layout:
            p = get(params, lf.path)
            self.m[lf.path] = torch.zeros_like(p, dtype=mdt)
            if opt["factored_v"] and _factored(p.shape):
                self.v[lf.path] = (
                    torch.zeros(p.shape[:-1], device=p.device),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], device=p.device))
            else:
                self.v[lf.path] = torch.zeros(p.shape, device=p.device)

    # -- loss and gradient ------------------------------------------------
    def grads(self, tokens, labels):
        """(loss, {leaf path: f32 gradient}) of one batch."""
        c, prec, params = self.c, self.prec, self.params
        tokens, labels = tokens.long(), labels.long()
        B, S = tokens.shape
        grads = {lf.path: torch.zeros(get(params, lf.path).shape,
                                      device=tokens.device)
                 for lf in self.layout}
        us = models.units(c)
        xs = []
        with torch.no_grad():
            x = e = params["embed"][tokens].float()
            for u in us:
                xs.append(x)
                x = u.fn(c, views(params, u), x, e, prec)
        # the head: the mean over the positions that have a next token
        # (half of them under the "half_batch" fault)
        rows, pos = B, S - 1
        if self.fault == "half_batch":
            rows, pos = (B // 2, S - 1) if B > 1 else (1, (S - 1) // 2)
        xf = x.requires_grad_()
        fn = params["final_norm"].detach().float().requires_grad_()
        w = models.head_weight(c, params).detach().float().requires_grad_()
        h = ops.rms_norm(xf, fn, c["norm_eps"])[:rows, :pos]
        h = h.reshape(-1, h.shape[-1])
        lab = labels[:rows, 1:pos + 1].reshape(-1)
        loss = sum(checkpoint(ops.token_nll_sum, h[i:i + HEAD_ROWS], w,
                              lab[i:i + HEAD_ROWS], prec, use_reentrant=False)
                   for i in range(0, h.shape[0], HEAD_ROWS)) / h.shape[0]
        loss.backward()
        grads[("final_norm",)] += fn.grad
        if c.get("tie_embeddings"):
            grads[("embed",)] += w.grad.T
        else:
            grads[("lm_head",)] += w.grad
        gx = xf.grad
        del xf, fn, w, h
        # the units that read the embedding's output e accumulate its
        # gradient in e.grad, which joins the stream's at the embedding
        e = e.detach().requires_grad_()
        for i in reversed(range(len(us))):
            u, xi = us[i], xs[i].requires_grad_()
            xs[i] = None
            ps = tuple(_leaves_requiring_grad(p) for p in views(params, u))
            u.fn(c, ps, xi, e, prec).backward(gx)
            for (path, layer), p in zip(u.sources, ps):
                _add_grads(grads, path, layer, p)
            gx = xi.grad
        if e.grad is not None:
            gx = gx + e.grad
        grads[("embed",)].index_add_(0, tokens.reshape(-1),
                                     gx.reshape(-1, gx.shape[-1]))
        return loss.detach(), grads

    # -- optimizer --------------------------------------------------------
    @torch.no_grad()
    def update(self, grads) -> float:
        """One AdamW step in place; returns the gradient's global norm."""
        o = self.o
        self.count += 1
        lr = lr_at(o, self.count)
        gn = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = min(1.0, o["clip_norm"] / (gn + 1e-9))
        c1, c2 = 1 - o["b1"] ** self.count, 1 - o["b2"] ** self.count
        for lf in self.layout:
            p = get(self.params, lf.path)
            v, n = self.v[lf.path], p.ndim
            vs = (zip(*(_slices(f, n) for f in v)) if isinstance(v, tuple)
                  else _slices(v, n))
            for ps, gs, ms, vi in zip(_slices(p, n),
                                      _slices(grads[lf.path], n),
                                      _slices(self.m[lf.path], n), vs):
                g = gs * scale
                m = ms.float() * o["b1"] + g * (1 - o["b1"])
                if isinstance(vi, tuple):
                    row, col = vi
                    g2 = g.square() + 1e-30
                    row.mul_(o["b2"]).add_(g2.mean(-1) * (1 - o["b2"]))
                    col.mul_(o["b2"]).add_(g2.mean(-2) * (1 - o["b2"]))
                    denom = row.mean(-1, keepdim=True).clamp_min(1e-30)
                    v_hat = row[..., None] * col[..., None, :] \
                        / denom[..., None] / c2
                else:
                    vi.mul_(o["b2"]).add_(g.square() * (1 - o["b2"]))
                    v_hat = vi / c2
                upd = (m / c1) / (v_hat.sqrt() + o["eps"])
                if p.ndim >= 2:
                    upd = upd + o["weight_decay"] * ps.float()
                ps.copy_(ps.float() - lr * upd)
                ms.copy_(m)
        return gn


def _leaves_requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaves_requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


def _add_grads(grads, path, layer, tree):
    """Add the .grad of each leaf of tree, the view of layer `layer` of
    the parameters at path, to its gradient."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _add_grads(grads, path + (k,), layer, v)
        return
    g = grads[path]
    (g if layer is None else g[layer]).add_(tree.grad)


def piece_norms(layout, tensor_of) -> dict:
    """{piece name: f32 norm} of `tensor_of(leaf)` for every leaf."""
    out = {}
    for lf in layout:
        for name, t in pieces(lf, tensor_of(lf)):
            out[name] = float(t.float().norm())
    return out
