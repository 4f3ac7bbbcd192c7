"""Padding for batched heterogeneous problem instances.

Counterpart of ``tinyopt_tpu.parallel.padding``.  A batch of instances
with different residual counts (circle fits with 8..17 observations each)
is padded to one shape before it is batched, with a weight mask; the
residual function drops the padded rows, so they contribute exactly zero
residual and zero Jacobian (the unpadded problem's cost and normal
equations).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


def pad_instances(data_list: Sequence[Any], pad_value: float = 0.0):
    """Stack per-instance pytrees with unequal leading axes.

    Each element of ``data_list`` is one instance's data pytree; every leaf
    is padded along axis 0 to the max count across instances, then stacked.
    Returns ``(stacked, mask)`` with ``mask`` float32 of shape (B, n_max):
    1.0 for real rows, 0.0 for padding (on the first leaf's device)."""
    if not data_list:
        raise ValueError("empty instance list")
    counts = [int(torch.as_tensor(pytree.tree_leaves(d)[0]).shape[0])
              for d in data_list]
    n_max = max(counts)

    def pad_leaf(a, n):
        a = torch.as_tensor(a)
        if a.shape[0] == n_max:
            return a
        fill = a.new_full((n_max - n,) + tuple(a.shape[1:]), pad_value)
        return torch.cat([a, fill])

    stacked = pytree.tree_map(
        lambda *leaves: torch.stack([pad_leaf(l, c)
                                     for l, c in zip(leaves, counts)]),
        *data_list)
    dev = torch.as_tensor(pytree.tree_leaves(data_list[0])[0]).device
    mask = torch.as_tensor(
        np.arange(n_max)[None, :] < np.asarray(counts)[:, None],
        dtype=torch.float32, device=dev)
    return stacked, mask


def masked_residuals(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded residual rows (apply inside the residual fn).

    ``r``: (n_max, ...) per-instance residuals, ``mask``: (n_max,).  A
    select, not a product: a residual that divides, logs or takes a root of
    its data gives inf / NaN on the padded rows, and NaN · 0 = NaN would
    poison the instance; the select drops the padded rows' values and
    their derivatives."""
    r = torch.as_tensor(r)
    m = mask.reshape((mask.shape[0],) + (1,) * (r.ndim - 1)) > 0
    return torch.where(m, r, torch.zeros((), dtype=r.dtype, device=r.device))
