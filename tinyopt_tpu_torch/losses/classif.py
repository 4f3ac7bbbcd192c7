"""Classification losses (reference: include/tinyopt/losses/classif.h:17-86).

Counterpart of ``tinyopt_tpu.losses.classif``: ``softmax`` and
``safe_softmax``, the ``*_with_jac`` variants with the dense Jacobian
``J[i,j] = sᵢ(δᵢⱼ − sⱼ)``.
"""

from __future__ import annotations

import torch


def softmax(x):
    """eˣⁱ / Σeˣ (classif.h:17-49) — un-shifted, can overflow for large x."""
    e = torch.exp(torch.as_tensor(x).reshape(-1))
    return e / torch.sum(e)


def safe_softmax(x):
    """Max-subtracted softmax (classif.h:53-86)."""
    x = torch.as_tensor(x).reshape(-1)
    e = torch.exp(x - torch.max(x))
    return e / torch.sum(e)


def _softmax_jac(s):
    return torch.diag(s) - torch.outer(s, s)


def softmax_with_jac(x):
    s = softmax(x)
    return s, _softmax_jac(s)


def safe_softmax_with_jac(x):
    s = safe_softmax(x)
    return s, _softmax_jac(s)
