"""What the benchmark makes from `--seed` and hands to both sides: the
weights, the prompts of a serving mix and, for the reference, the
token batches of a training mix.

Weights are drawn on the device, one generator call a tensor: leaf k of
the layout from a generator seeded by (seed, k), so a single leaf can be
drawn again alone (`leaf`), as the comparison does for the weights'
change.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.models import layout

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for a torch generator from `seed` and salts."""
    s = seed & _MASK
    for x in salt:
        s = ((s ^ (x + 1)) * _MIX) & _MASK
    return s


def leaf(lf, k: int, seed: int, device) -> torch.Tensor:
    """Leaf k of the layout, drawn as `weights` draws it."""
    dtype = getattr(torch, lf.dtype)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, k))
    if lf.init == "normal":
        return torch.randn(lf.shape, dtype=dtype, device=device,
                           generator=gen).mul_(lf.std)
    if lf.init == "ones":
        return torch.ones(lf.shape, dtype=dtype, device=device)
    if lf.init == "zeros":
        return torch.zeros(lf.shape, dtype=dtype, device=device)
    if lf.init == "a_log":
        a = torch.log(torch.linspace(1.0, 16.0, lf.shape[-1], device=device))
        return a.expand(lf.shape).to(dtype).contiguous()
    if lf.init == "dt_bias":
        # dt log-uniform in [1e-3, 1e-1], stored as softplus⁻¹(dt)
        u = torch.rand(lf.shape, device=device, generator=gen)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return torch.log(torch.expm1(dt)).to(dtype)
    raise ValueError(lf.init)


def weights(c: dict, seed: int, device) -> dict:
    """The parameter tree of configuration sizes `c`, drawn from `seed`."""
    tree: dict = {}
    for k, lf in enumerate(layout(c)):
        node = tree
        for key in lf.path[:-1]:
            node = node.setdefault(key, {})
        node[lf.path[-1]] = leaf(lf, k, seed, device)
    return tree


def train_batch(seed: int, step: int, B: int, S: int, V: int):
    """(tokens, labels) int32 (B, S) of training step `step`: uniform ids
    from NumPy's PCG64 seeded by (seed, step, 0), tokens drawn first.
    The program's data pipeline is held to the same rule."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0]))
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    return tokens, labels


def prompt_lengths(mix: dict, seed: int, n: int) -> list:
    """Lengths of the first n requests: blocks of the mix's multiset of
    lengths, each block in an order drawn from the seed."""
    block = [int(length) for length, count in mix["block"].items()
             for _ in range(count)]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    out = []
    while len(out) < n:
        out += [block[i] for i in rng.permutation(len(block))]
    return out[:n]


def prompts(mix: dict, seed: int, n: int, V: int, device):
    """(lengths, list of int32 token tensors) of the first n requests,
    the ids drawn on the device in one call."""
    lengths = prompt_lengths(mix, seed, n)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    ids = torch.randint(0, V, (sum(lengths),), generator=gen, device=device,
                        dtype=torch.int32)
    return lengths, list(torch.split(ids, lengths))
