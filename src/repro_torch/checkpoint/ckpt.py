"""Step-atomic checkpointing in the reference's on-disk layout.

Counterpart of ``repro.checkpoint.ckpt``. Layout: ``<dir>/step_<N>/``
(N zero-padded to 8 digits) holding ``arrays.npz``, every leaf of the
tree under its '/'-joined path, and ``manifest.json`` ({"step", "keys"}).
Writes go to a ``.tmp`` directory renamed into place (atomic on POSIX),
so a crash mid-save never corrupts the newest checkpoint, and the
oldest are pruned to ``keep``. The format is mesh-agnostic (whole
arrays), so a checkpoint written on one mesh restores onto another
(:func:`restore_for_mesh`, elastic re-meshing).

Trees are nested dicts whose leaves are numpy arrays or tensors;
tensors are written from the host, bf16 as the two-byte ``|V2`` records
numpy writes for the reference's bf16 arrays. The trainer writes the
reference's tree (``models/convert.py``: parameters stacked on the
super-block axis), so a checkpoint of either package restores in the
other. :func:`restore` returns numpy arrays, as the reference's;
:func:`restore_for_device` puts every leaf on one device (what the
reference's ``restore_for_mesh(dir, None)`` does on one host);
:func:`restore_for_mesh` gives one device's blocks of every leaf under
a spec tree (launch/sharding.py).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.sharding import local_shard
from repro_torch.models.convert import as_tensor, host_array


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def save(ckpt_dir: str, step: int, tree: dict, keep: int = 3) -> str:
    """Atomically write ``tree`` as step_<step>; prune to ``keep`` newest.
    Returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: host_array(v) if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int | None = None) -> tuple[int, dict]:
    """(step, tree of numpy arrays) of step ``step`` (default the
    newest); raises ``FileNotFoundError`` where there is none."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return step, _unflatten(flat)


def restore_for_device(ckpt_dir: str,
                       device: str | torch.device | None = None,
                       step: int | None = None) -> tuple[int, dict]:
    """:func:`restore` with every leaf a tensor on ``device`` (CUDA
    unless named; ``|V2`` records as bf16)."""
    dev = resolve_device(device)
    step, tree = restore(ckpt_dir, step)
    flat = {k: as_tensor(v).to(dev) for k, v in _flatten(tree).items()}
    return step, _unflatten(flat)


def restore_for_mesh(ckpt_dir: str, spec_tree: dict | None,
                     mesh: ShardMesh, coords: dict,
                     device: str | torch.device | None = None,
                     step: int | None = None) -> tuple[int, dict]:
    """Restore for a (possibly different) mesh — elastic scaling: each
    leaf as the block that the device at ``coords`` (mesh axis → index)
    holds under its spec in ``spec_tree`` (a leaf the tree does not name
    comes whole, as the reference's leaves without a sharding), a tensor
    on ``device`` (CUDA unless named). Only the block is copied to the
    device."""
    dev = resolve_device(device)
    step, tree = restore(ckpt_dir, step)
    specs = _flatten(spec_tree) if spec_tree is not None else {}
    flat = {}
    for k, v in _flatten(tree).items():
        t = as_tensor(v)
        if k in specs:
            t = local_shard(t, specs[k], mesh, coords)
        flat[k] = t.to(dev, copy=True)
    return step, _unflatten(flat)
