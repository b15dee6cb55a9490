"""Random weights from the run's seed, made on the device in the port's
parameter layout.

The layout (every leaf's path, shape and type) is the port's own
``init_model`` tree, built once under ``FakeTensorMode`` (no memory, no
draws).  The values come from one ``normal_`` call per leaf type over one
flat buffer on the device, drawn by a ``torch.Generator`` there seeded
with the run's seed; each leaf is a view of its buffer.  Every matrix is
normal at the configuration's ``initializer_range``; a norm's ``scale`` is
1.  The same tensors go to the program and to the plain
reference.
"""
from __future__ import annotations

from typing import Dict

import torch


def layout(cfg):
    """The port's parameter tree of ``cfg`` as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_model
    with FakeTensorMode():
        return init_model(cfg, torch.Generator(device="cpu"), "cpu")


def make_params(cfg, conf: Dict, seed: int, device) -> Dict:
    from repro_torch.core.tree import leaves_with_paths, tree_map_with_path
    shape = layout(cfg)
    pos: Dict = {}
    sizes: Dict[torch.dtype, int] = {}
    for path, leaf in leaves_with_paths(shape):
        pos[path] = sizes.get(leaf.dtype, 0)
        sizes[leaf.dtype] = pos[path] + leaf.numel()
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for dtype, n in sorted(sizes.items(), key=lambda kv: str(kv[0])):
        flat[dtype] = torch.empty(n, dtype=dtype, device=device).normal_(
            0.0, conf["initializer_range"], generator=gen)

    def view(path, leaf):
        t = flat[leaf.dtype][pos[path]:pos[path] + leaf.numel()].view(
            leaf.shape)
        if path[-1] == "scale":
            t.fill_(1.0)
        return t
    return tree_map_with_path(view, shape)
