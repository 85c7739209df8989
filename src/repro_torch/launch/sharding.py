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
rules are pure functions over `launch.mesh.Mesh`; nothing places a
tensor: on one device every spec of the one-device mesh holds already.
Trees are the port's dict trees; a leaf's path is written as the
reference's `keystr` writes it (`['mu']['embed']['m']`), which is what
the rules match.
"""
from __future__ import annotations

import math
import re

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
