"""The reference's parameters as the port's.

`params_from_jax` takes the JAX package's parameter pytree with its
leaves as NumPy arrays (`np.asarray(x, np.float32)` of each: NumPy has
no bfloat16) and returns the port's tree: the same keys and stacked
(L, ...) layout, so every weight stands under its reference name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

#: leaves the reference keeps in float32 whatever the model dtype: the MoE
#: router and the Mamba2 decay, skip and step-bias vectors
F32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def params_from_jax(tree, dtype, device=None):
    """tree: nested dicts of NumPy arrays; dtype: the model dtype (a
    torch dtype or its name).  Each leaf goes to `device` (the card when
    None) in `dtype`, or in float32 where the reference keeps one
    (`F32_LEAVES`); f32 -> bf16 of a bf16 value is exact."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    device = resolve_device(device)

    def conv(node, key):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        dt = torch.float32 if key in F32_LEAVES else dtype
        a = np.array(node, np.float32)       # a writable copy
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return conv(tree, None)
