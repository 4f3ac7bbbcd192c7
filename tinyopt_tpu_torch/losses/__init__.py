"""Losses, norms and robust M-estimators (reference: include/tinyopt/
losses/).

Counterpart of ``tinyopt_tpu.losses``: functions of ONE instance over
torch tensors, differentiable with ``torch.func`` (use them inside a
residual function, which the solvers map over the batch), each with an
analytic ``*_with_jac`` variant for manual accumulation functions.

    from tinyopt_tpu_torch.losses.robust_norms import huber, robust_whiten
    def fn(x):                      # per-residual Huber whitening
        return torch.func.vmap(
            lambda r: robust_whiten(r[None], huber, 0.09))(x[0] * t - y)
"""

from . import activations, classif, distances, mahalanobis, norms, robust_norms
from .norms import squared_l2, l1, l2, linf
from .robust_norms import (
    truncated, huber, tukey, arctan, cauchy, geman_mcclure, blake_zisserman,
    robust_cost,
    truncated_loss, huber_loss, tukey_loss, arctan_loss, cauchy_loss,
    geman_mcclure_loss, blake_zisserman_loss, robust_whiten,
    gnc_anneal, gnc_schedule,
)
from .mahalanobis import (
    maha_squared_norm, maha_norm, maha_whitened, maha_whitened_info_u,
)
from .activations import sigmoid, tanh, relu, leaky_relu
from .classif import softmax, safe_softmax

__all__ = [
    "activations", "classif", "distances", "mahalanobis", "norms",
    "robust_norms",
    "squared_l2", "l1", "l2", "linf",
    "truncated", "huber", "tukey", "arctan", "cauchy", "geman_mcclure",
    "blake_zisserman",
    "robust_cost",
    "truncated_loss", "huber_loss", "tukey_loss", "arctan_loss",
    "cauchy_loss", "geman_mcclure_loss", "blake_zisserman_loss",
    "robust_whiten",
    "gnc_anneal", "gnc_schedule",
    "maha_squared_norm", "maha_norm", "maha_whitened",
    "maha_whitened_info_u",
    "sigmoid", "tanh", "relu", "leaky_relu",
    "softmax", "safe_softmax",
]
