"""Atomic numpy-based checkpointing (fault-tolerance substrate), in the
reference's on-disk format.

Layout:  <dir>/step_<n>/ { manifest.json, 0000.npy, 0001.npy, ... }
Writes go to a temp dir + atomic rename, so a crash mid-save never corrupts
the restore point.  `keep` bounds disk usage; `latest_step` drives restart.
Leaves are numbered in the reference's order (dict keys sorted, as
`jax.tree_util` flattens) and named by its `keystr` paths
(`['mu']['layers']['in_proj']['m']`), so a checkpoint written by either
package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

# numpy's npy format has no bf16/fp8 descriptor: store as a same-width
# integer view and restore the logical dtype from the manifest.
_WIDE_VIEW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
              "float8_e5m2": np.uint8}
#: the torch and numpy dtypes that carry those bits across (torch has no
#: full uint16)
_BITS = {np.uint16: (torch.int16, np.int16), np.uint8: (torch.uint8, np.uint8)}


def _flatten(tree, path: str = "") -> list:
    """[(keystr path, leaf)] in `jax.tree_util`'s order: dict keys
    sorted, each level `[repr(key)]`."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(like, by_path: dict, path: str = ""):
    """`like`'s structure, in its key order, with the leaves of
    `by_path` (keystr path -> leaf)."""
    if isinstance(like, dict):
        return {k: _unflatten(v, by_path, f"{path}[{k!r}]")
                for k, v in like.items()}
    return by_path[path]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    view = _WIDE_VIEW.get(_dtype_name(t))
    if view is None:
        return t.numpy()
    return t.view(_BITS[view][0]).numpy().view(view)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    view = _WIDE_VIEW.get(dtype)
    if view is None:
        return torch.from_numpy(arr)
    return torch.from_numpy(arr.view(_BITS[view][1])).view(
        getattr(torch, dtype))


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        manifest = {"step": step, "leaves": []}
        for i, (path, val) in enumerate(_flatten(tree)):
            arr = _to_numpy(val)
            fn = f"{i:04d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"path": path, "file": fn, "dtype": _dtype_name(val),
                 "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of `like` (validates paths + shapes),
    each leaf on `like`'s device and in its dtype."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = {}
    for path, ref in _flatten(like):
        if path not in by_path:
            raise KeyError(f"{path} is not in the checkpoint {d}")
        m = by_path[path]
        arr = np.load(os.path.join(d, m["file"]))
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        out[path] = _from_numpy(arr, m["dtype"]).to(device=ref.device,
                                                    dtype=ref.dtype)
    return _unflatten(like, out)
