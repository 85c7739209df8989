"""Sharding rules: parameter, optimizer-state and input specs.

Scheme (DESIGN.md §4):
  TP  — "model" axis: column-parallel in-projections (last dim), row-parallel
        out-projections (contracting dim), expert-parallel MoE (expert dim),
        vocab-parallel embeddings/head.
  FSDP— params/optimizer additionally sharded over the data axes (ZeRO-3).
  All rules are divisibility-guarded: a dim that doesn't divide its axis
  stays replicated (e.g. whisper's 12 heads on a 16-way model axis).

A spec is a tuple with one entry a dimension: None, an axis name, or a
tuple of names (the form `tuple()` of a jax `PartitionSpec` takes).  The
rules are pure functions over `launch.mesh.Mesh`.  `placements` turns a
spec into a DTensor's placements on the mesh, and `distribute_tree`
places a tree by a spec tree: each leaf becomes a DTensor whose local
tensor is this rank's shard (a fake tensor of the shard's shape for a
fake leaf, so a trace holds one device's bytes, never the global ones).
Trees are the port's dict trees; a leaf's path is written as the
reference's `keystr` writes it (`['mu']['embed']['m']`), which is what
the rules match.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, input_specs
from repro_torch.launch.mesh import Mesh

# leaf names -> parallelism class
_COL = {"wq", "wk", "wv", "wi", "wg", "wq_b", "wkv_b", "wkv_a", "wq_a",
        "in_proj", "router", "lm_head", "proj", "mm_connector"}
_ROW = {"wo", "out_proj"}


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _fit(dim: int, mesh: Mesh, axes):
    """Return axes if dim divides their product, else a divisible fallback."""
    if axes is None:
        return None
    if not isinstance(axes, str) and len(axes) == 1:
        axes = axes[0]   # canonical singleton: ('data',) == 'data' sharding
    if dim % _axis_size(mesh, axes) == 0:
        return axes
    if not isinstance(axes, str) and len(axes) > 1:
        # try the trailing axis alone (e.g. "data" without "pod")
        if dim % mesh.shape[axes[-1]] == 0:
            return axes[-1]
    return None


_WRAPPERS = {"mu", "m", "v", "row", "col", "count", "p", "s", "c"}


def param_spec(path: str, shape: tuple, mesh: Mesh, dp, tp: str,
               fsdp: bool = True, serving: bool = False) -> tuple:
    """The spec of one parameter leaf, by path naming convention.

    Optimizer-state paths (…['wq']['m'], …['wi']['v']['row']) inherit the
    underlying parameter's rule: wrapper keys are stripped before matching.

    serving=True (§Perf cell B): experts go expert-parallel over the FULL
    mesh (dp×tp) and no FSDP gathers happen per decode step; pass
    fsdp=True only when the non-expert weights don't fit
    TP-sharded-replicated.
    """
    keys = [k for k in re.findall(r"\['([^']+)'\]", path)
            if k not in _WRAPPERS]
    name = keys[-1] if keys else path
    nd = len(shape)
    spec = [None] * nd
    dp_ax = dp if fsdp else None

    def set_ax(i, axes):
        if i < 0 or i >= nd:
            return  # factored moments drop dims; skip out-of-range rules
        a = _fit(shape[i], mesh, axes)
        if a is not None:
            spec[i] = a

    if "experts" in path and nd >= 3:
        # (L, E, in, out): expert-parallel over tp (train) or the whole
        # mesh (serving EP², §Perf cell B)
        ep_axes = (tuple(dp) + (tp,) if (serving and tp is not None)
                   else tp)
        set_ax(nd - 3, ep_axes)
        if name in _ROW:
            set_ax(nd - 1, dp_ax)
        else:
            set_ax(nd - 2, dp_ax)
    elif name == "embed":
        set_ax(0, tp)       # vocab-parallel
        set_ax(1, dp_ax)
    elif name == "conv_w":
        set_ax(nd - 1, tp)
    elif name in _COL and nd >= 2:
        set_ax(nd - 1, tp)
        set_ax(nd - 2, dp_ax)
    elif name in _ROW and nd >= 2:
        set_ax(nd - 2, tp)
        set_ax(nd - 1, dp_ax)
    elif nd >= 2 and shape[-1] >= 1024:
        set_ax(nd - 1, dp_ax)  # misc large matrices: FSDP only
    return tuple(spec)


def _map_with_path(fn, tree, path: str = ""):
    """fn(path, leaf) over a dict tree, paths as the reference's keystr."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg: ModelConfig, abstract_params, mesh: Mesh, dp,
                    tp: str, fsdp: bool = True, serving: bool = False):
    """Spec tree matching the params tree."""
    return _map_with_path(
        lambda ps, x: param_spec(ps, tuple(x.shape), mesh, dp, tp, fsdp,
                                 serving), abstract_params)


def opt_state_shardings(opt_abstract, mesh: Mesh, dp, tp: str,
                        fsdp: bool = True):
    """Optimizer state inherits param shardings (wrapper keys stripped;
    divisibility-guarded for factored moments whose shapes drop a dim)."""
    return _map_with_path(
        lambda ps, x: param_spec(ps, tuple(x.shape), mesh, dp, tp, fsdp),
        opt_abstract)


def _spec(*axes) -> tuple:
    """A spec of these entries, a one-name tuple written as the name (as
    a jax `PartitionSpec` canonicalizes it)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, dp,
                    tp: str) -> dict:
    """Specs for every input in input_specs(cfg, shape)."""
    specs = input_specs(cfg, shape)
    B = shape.global_batch
    dp_fit = dp if B % _axis_size(mesh, dp) == 0 else None
    tp_size = mesh.shape[tp] if tp is not None else 0
    out = {}
    for k, s in specs.items():
        nd = len(s.shape)
        if k == "cache_index":
            out[k] = _spec()
        elif k in ("tokens", "labels"):
            out[k] = _spec(dp_fit, *([None] * (nd - 1)))
        elif k in ("patch_embeds", "frame_embeds", "encoder_out"):
            out[k] = _spec(dp_fit, None, None)
        elif k in ("k_cache", "v_cache"):
            # (L, B, S, KV, hd): heads over tp when divisible, else seq
            KV = s.shape[3]
            if tp is not None and KV % tp_size == 0:
                out[k] = _spec(None, dp_fit,
                               None if dp_fit else dp_seq(mesh, dp, s), tp,
                               None)
            else:
                out[k] = _spec(None, dp_fit, tp, None, None)
        elif k == "kv_cache":  # MLA latent (L, B, S, D)
            out[k] = _spec(None, dp_fit, tp, None)
        elif k == "ssm_state":  # (L, B, nh, hd, ds)
            nh = s.shape[2]
            out[k] = _spec(None, dp_fit,
                           tp if tp and nh % tp_size == 0 else None, None,
                           None)
        elif k == "conv_state":  # (L, B, W-1, conv_dim)
            cd = s.shape[3]
            out[k] = _spec(None, dp_fit, None,
                           tp if tp and cd % tp_size == 0 else None)
        else:
            out[k] = _spec(*([None] * nd))
    return out


def dp_seq(mesh: Mesh, dp, s):
    """Shard cache sequence over the idle data axes when batch can't use
    them (single-stream long-context decode)."""
    S = s.shape[2]
    return dp if S % _axis_size(mesh, dp) == 0 else None


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------
def placements(spec: tuple, mesh: Mesh) -> tuple:
    """A DTensor's placements for `spec` on `mesh`: `Shard(d)` on each
    mesh dimension of more than one device that the spec names for
    tensor dimension d, and `Replicate()` on the others.  A tuple of names shards one dimension
    over several mesh dimensions, the first named the major one, as a
    jax `PartitionSpec` does; it must name them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} names {names} out of the mesh's "
                             f"order {mesh.axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses axis "
                                 f"{mesh.axis_names[i]} twice")
            if mesh.axis_sizes[i] > 1:  # a split one way is no split
                out[i] = Shard(d)
    return tuple(out)


def local_shard(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the global tensor `t` under `spec`: a new
    fake (or meta) tensor of the shard's shape for a fake or meta `t`, a
    contiguous copy of its slice of `t` otherwise (a copy even where the
    slice is all of `t`: the DTensor never aliases it)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    dm = mesh.device_mesh
    with _disable_current_modes():          # integer math on the rank map
        shape, offset = compute_local_shape_and_global_offset(
            tuple(t.shape), dm, placements(spec, mesh))
    if is_fake(t) or t.is_meta:
        return t.new_empty(shape)
    index = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    return t[index].clone(memory_format=torch.contiguous_format)


def distribute(t: torch.Tensor, spec: tuple, mesh: Mesh):
    """`t` (the global tensor, on every rank) as a DTensor on `mesh`
    placed by `spec`, built from this rank's shard alone
    (`DTensor.from_local`): the global tensor is never sent anywhere."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(t, spec, mesh), mesh.device_mesh,
                              placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, specs, mesh: Mesh):
    """Every leaf of a dict tree as `distribute` places it by the leaf of
    `specs` (a spec tree of the same structure)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def shard_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes of one device's shards of a tree, from its shapes and specs
    alone: the first device's, which takes the larger part of a split
    that does not divide (`torch.chunk`'s, as DTensor splits)."""
    if isinstance(tree, dict):
        return sum(shard_bytes(tree[k], specs[k], mesh) for k in tree)
    n = tree.element_size()
    for i, dim in enumerate(tree.shape):
        axes = specs[i] if i < len(specs) else None
        ways = 1 if axes is None else _axis_size(mesh, axes)
        n *= -(-dim // ways)
    return n
