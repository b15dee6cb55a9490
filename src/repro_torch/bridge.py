"""Weight bridge: the reference's parameter pytree (and its optimizer
state) -> the port's.

The reference ``init_model`` returns nested dicts and lists whose leaves
are stacked per segment (one leading layer axis).  The port keeps the
SAME structure with torch tensors as leaves, so a test can hand both
packages identical weights.  This module takes the tree as numpy arrays
(``np.asarray`` of each leaf) and imports neither JAX nor ml_dtypes.

numpy has no native bfloat16: a bf16 leaf arrives with ml_dtypes'
``bfloat16`` dtype, which ``torch.from_numpy`` rejects.  Its bits go
across as 16-bit integers and are reinterpreted with ``.view(torch.bfloat16)``
— a bit-exact move, no rounding.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    arr = np.array(arr, order="C")         # a writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Map every numpy leaf of ``tree`` (dicts / lists / tuples) to a
    torch tensor on ``device``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)


def opt_state_from_jax(state: Any, device: torch.device | str = "cpu"
                       ) -> Any:
    """The reference's optimizer state ``{"master", "m", "v", "step"}``
    (numpy leaves) as the port's: the same trees of tensors (``step`` its
    int32 scalar) on ``device`` — so both packages can go on from the
    same state after k steps."""
    if set(state) != {"master", "m", "v", "step"}:
        raise ValueError(f"not an AdamW state: keys {sorted(state)}")
    return params_from_jax(state, device)
