"""The plain reference of the benchmark's models, from the sizes in a
configuration file's "as_run" group.

A model is its parameter layout (`layout`: the path, shape, dtype and
initial law of each tensor, which the harness draws from the seed and
hands to both sides) and a sequence of units (`units`): embedding, then
blocks that each map the residual stream (B, S, d) to itself, then the
head.  The embedding and the head are common to every model; what lies
between is its family's, in `families/<family>.py`, found by the name
the "as_run" group gives.  A family file defines

  leaves(c)                 the blocks' `Leaf`s, in a fixed order
  units(c)                  the blocks' `Unit`s, in the order they run
  flops_per_token(c, seq)   the blocks' matrix-product FLOPs a token of
                            a sequence of `seq` (`frozen/flops.py` adds
                            the head's)

`forward` runs them in f32; `train.py` differentiates them one unit at a
time.
"""
from __future__ import annotations

import functools
import importlib.util
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from reference import ops

#: the family files, `<family>.py` each
FAMILIES = Path(__file__).resolve().parent / "families"


@dataclass(frozen=True)
class Leaf:
    path: tuple          # keys into the parameter tree
    shape: tuple
    dtype: str           # "bfloat16" or "float32"
    init: str            # normal | ones | zeros | a_log | dt_bias
    std: float = 0.0
    stacked: bool = False    # its leading dim stacks the layers: compared
                             # a layer at a time


def mat(path, shape, dt, scale=1.0, stacked=False):
    return Leaf(path, shape, dt, "normal", scale / math.sqrt(shape[-2]),
                stacked)


@dataclass
class Unit:
    """One residual block: `fn(c, ps, x, e, prec)` maps the stream x to
    itself; ps holds the f32 view of each of `sources` (a (path, layer)
    pair: `sub(params at path, layer)`), e is the embedding's output
    (B, S, d), which a block may read beside x."""
    fn: object
    sources: tuple


@functools.cache
def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"reference_family_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(c):
    """The module of `families/<family>.py` for sizes c."""
    path = FAMILIES / f"{c['family']}.py"
    if not path.is_file():
        raise ValueError(f"no reference for family {c['family']!r}: "
                         f"{path} is missing")
    return _module(path)


def layout(c) -> list:
    """Every parameter tensor of the model, in a fixed order."""
    dt, d, V = c["dtype"], c["d_model"], c["vocab_size"]
    out = [Leaf(("embed",), (V, d), dt, "normal", 0.02),
           Leaf(("final_norm",), (d,), dt, "ones")]
    out += family(c).leaves(c)
    if not c.get("tie_embeddings", False):
        out.append(mat(("lm_head",), (d, V), dt))
    return out


def units(c) -> list:
    return family(c).units(c)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def sub(tree, i=None):
    """The f32 view of a parameter subtree, layer i of a stacked one."""
    if isinstance(tree, dict):
        return {k: sub(v, i) for k, v in tree.items()}
    return (tree if i is None else tree[i]).float()


def views(params, u: Unit) -> tuple:
    """The f32 view of each of u's sources."""
    return tuple(sub(get(params, path), layer) for path, layer in u.sources)


def head_weight(c, params):
    return params["embed"].T if c.get("tie_embeddings") else params["lm_head"]


def stream(c, params, tokens, prec):
    """The residual stream (B, S, d) after the last unit."""
    x = e = params["embed"][tokens.long()].float()
    for u in units(c):
        x = u.fn(c, views(params, u), x, e, prec)
    return x


@torch.no_grad()
def last_logits(c, params, tokens, prec):
    """f32 logits (B, V) at the last position of tokens (B, S)."""
    x = stream(c, params, tokens, prec)
    h = ops.rms_norm(x[:, -1], params["final_norm"].float(), c["norm_eps"])
    return prec.mm(h, head_weight(c, params).float())


@torch.no_grad()
def all_logits(c, params, tokens, prec, rows: int = 1024):
    """f32 logits (B, S, V) at every position, the head in row blocks."""
    x = stream(c, params, tokens, prec)
    h = ops.rms_norm(x, params["final_norm"].float(), c["norm_eps"])
    w = head_weight(c, params).float()
    B, S, d = h.shape
    h = h.reshape(B * S, d)
    return torch.cat([prec.mm(h[i:i + rows], w)
                      for i in range(0, B * S, rows)]).reshape(B, S, -1)
