"""Fault-tolerant checkpointing of tensor trees, in the reference's
on-disk format, so a checkpoint written by either package restores in
the other:

  - ``<dir>/step_%010d/`` holding ``arrays.npz`` (one array per leaf,
    keyed by ``core.tree.path_key``: ``segments/[0]/attn/wq``) and
    ``meta.json`` ({"step", "dtypes", "metadata"}); bf16 leaves are
    stored as their uint16 bits (numpy has no bfloat16);
  - atomic finalize: everything is written under ``step_….tmp`` with a
    ``COMMITTED`` marker, then renamed into place, so a crash mid-write
    never yields a "latest" that is unreadable;
  - a background writer (``AsyncCheckpointer``) so the train loop is not
    blocked on serialization;
  - keep-last-k GC.

``restore`` places the leaves on one ``device``, or, with ``shardings``
(a tree of DTensor placements) and ``mesh``, returns this rank's shards
as DTensors on that mesh: a checkpoint written at one world size resumes
at another (the elastic path).  Sharded states are written gathered
full, so the format does not depend on the mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, path_key, unflatten
from repro_torch.dist.sharding import shard_tree

COMMIT = "COMMITTED"


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array stored for a leaf, its dtype name in meta.json)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Synchronous checkpoint write with atomic commit."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        key = path_key(path)
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "dtypes": dtypes,
                   "metadata": metadata or {}}, f)
    with open(os.path.join(tmp, COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    _gc(ckpt_dir, keep)
    return d


class AsyncCheckpointer:
    """Double-buffered background writer: snapshot on the caller thread
    (a device -> host COPY of every leaf), serialize on a worker thread.

    The copy is a real one even for a CPU leaf (``.cpu()`` of a CPU tensor
    is the same storage): the optimizer updates the params and its state
    in place, and would otherwise change the snapshot while the worker
    writes it."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        host_tree = unflatten(tree, [
            leaf.detach().to("cpu", copy=True)
            for _, leaf in leaves_with_paths(tree)])      # snapshot now
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree, metadata,
                               self.keep), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _committed(ckpt_dir: str) -> list:
    """The committed ``step_%010d`` directory names, in step order.  A
    ``step_….tmp`` is never one, even holding its marker (a crash between
    the marker and the rename): the reference's ``int(d.split("_")[1])``
    raises on it."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d[5:].isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, d, COMMIT)))


def _gc(ckpt_dir: str, keep: int):
    for d in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed(ckpt_dir)
    return int(steps[-1][5:]) if steps else None


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None,
            device: Optional[torch.device | str] = None,
            shardings: Any = None, mesh: Any = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (the stored dtypes,
    bf16 bit for bit) on ``device``, by default each target leaf's own;
    returns (tree, the metadata saved with it).  A target leaf the
    checkpoint lacks, or holds at another shape, raises ValueError.

    ``shardings``: a tree of placement lists matching ``target_tree``, on
    the ``DeviceMesh`` ``mesh`` (``dist.sharding.placements_from_pspecs``):
    every leaf is then this rank's shard of the stored array, a DTensor
    (read whole, sliced locally; no communication)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore: shardings and mesh go together")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    new_leaves = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for path, old_leaf in leaves_with_paths(target_tree):
            key = path_key(path)
            if key not in arrays.files:
                raise ValueError(f"{d} holds no leaf {key}")
            arr = arrays[key]
            if arr.shape != tuple(old_leaf.shape):
                raise ValueError(f"{d}: leaf {key} has shape {arr.shape}, "
                                 f"the target {tuple(old_leaf.shape)}")
            if meta["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            new_leaves.append(t.to(device if device is not None
                                   else old_leaf.device))
    tree = unflatten(target_tree, new_leaves)
    if shardings is not None:
        tree = shard_tree(tree, shardings, mesh)
    return tree, meta["metadata"]
