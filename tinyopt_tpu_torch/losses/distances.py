"""Distances between parameter / feature vectors (reference:
include/tinyopt/distances.h:17-106).

Counterpart of ``tinyopt_tpu.losses.distances``.  ``*_with_jac`` variants
return ``(d, Ja, Jb)``, with ``Jb = −Ja`` for the distances of a
difference and the analytic pair for the cosine.
"""

from __future__ import annotations

import torch

from .mahalanobis import maha_norm as _maha_norm
from .mahalanobis import maha_norm_with_jac as _maha_norm_with_jac
from .norms import l1, l1_with_jac, l2, l2_with_jac, linf, linf_with_jac


def _diff(a, b):
    return torch.as_tensor(a) - torch.as_tensor(b)


def euclidean(a, b):
    """‖a − b‖ (distances.h:17-28)."""
    return l2(_diff(a, b))


def euclidean_with_jac(a, b):
    d, J = l2_with_jac(_diff(a, b))
    return d, J, -J


def manhattan(a, b):
    """Σ|aᵢ − bᵢ| (distances.h:36-47)."""
    return l1(_diff(a, b))


def manhattan_with_jac(a, b):
    d, J = l1_with_jac(_diff(a, b))
    return d, J, -J


def linf_dist(a, b):
    """max|aᵢ − bᵢ| (distances.h:55-66)."""
    return linf(_diff(a, b))


def linf_dist_with_jac(a, b):
    d, J = linf_with_jac(_diff(a, b))
    return d, J, -J


def _cos_parts(a, b, eps):
    a = torch.as_tensor(a).reshape(-1)
    b = torch.as_tensor(b).reshape(-1)
    if eps is None:
        eps = torch.finfo(a.dtype).eps
    an = torch.linalg.vector_norm(a)
    bn = torch.linalg.vector_norm(b)
    return a, b, an, bn, an * bn >= eps


def cosine(a, b, eps: float | None = None):
    """Cosine similarity a·b/(‖a‖‖b‖), 0 for near-zero inputs
    (distances.h:69-94)."""
    a, b, an, bn, ok = _cos_parts(a, b, eps)
    denom = torch.where(ok, an * bn, torch.ones_like(an))
    return torch.where(ok, torch.dot(a, b) / denom, torch.zeros_like(an))


def cosine_with_jac(a, b, eps: float | None = None):
    a, b, an, bn, ok = _cos_parts(a, b, eps)
    one = torch.ones_like(an)
    an_s = torch.where(ok, an, one)
    bn_s = torch.where(ok, bn, one)
    ab = torch.dot(a, b)
    d = torch.where(ok, ab / (an_s * bn_s), torch.zeros_like(an))
    Ja = torch.where(ok, b / (an_s * bn_s) - ab * a / (an_s ** 3 * bn_s),
                     torch.zeros_like(a))
    Jb = torch.where(ok, a / (an_s * bn_s) - ab * b / (an_s * bn_s ** 3),
                     torch.zeros_like(b))
    return d, Ja[None, :], Jb[None, :]


def maha_norm(a, b, cov_or_var):
    """‖a − b‖_Σ (distances.h:97-106)."""
    return _maha_norm(_diff(a, b), cov_or_var)


def maha_norm_with_jac(a, b, cov_or_var):
    d, J = _maha_norm_with_jac(_diff(a, b), cov_or_var)
    return d, J, -J
