"""SE(3) rigid-transform manifold (rotation quaternion + translation).

Counterpart of ``tinyopt_tpu.manifolds.se3``: tangent dimension 6, layout
``[ρ (translation), ω (rotation)]``, retraction ``T ⊞ δ = T · exp(δ̂)``
(right-multiply, the Sophus convention).  Its stored values flatten to 7
a pose: ``rotation.wxyz`` then ``translation``.  The retraction does not
renormalize the quaternion, as the JAX package's does not.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from ..manifold import Manifold, register_manifold
from .se23 import _V_apply, _V_inv_apply
from .so3 import SO3, _exp_quat, _qmul


def _se3_exp(delta):
    """se(3) tangent (..., 6) -> (SO3, t), finite under differentiation at
    δ = 0."""
    rho = delta[..., :3]
    omega = delta[..., 3:]
    return SO3(_exp_quat(omega)), _V_apply(omega, rho)


@dataclasses.dataclass
class SE3:
    rotation: SO3
    translation: torch.Tensor  #: (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, batch=(), device=None) -> "SE3":
        return SE3(SO3.identity(dtype, batch, device),
                   torch.zeros(tuple(batch) + (3,), dtype=dtype,
                               device=device))

    @staticmethod
    def exp(delta) -> "SE3":
        R, t = _se3_exp(torch.as_tensor(delta))
        return SE3(R, t)

    def log(self):
        omega = self.rotation.log()
        rho = _V_inv_apply(omega, self.translation)
        return torch.cat([rho, omega], dim=-1)

    def apply(self, p):
        return self.rotation.apply(p) + self.translation

    def inverse(self) -> "SE3":
        rinv = self.rotation.inverse()
        return SE3(rinv, -rinv.apply(self.translation))

    def matrix(self):
        R = self.rotation.matrix()
        top = torch.cat([R, self.translation[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                              device=R.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(SO3(_qmul(self.rotation.wxyz, other.rotation.wxyz)),
                       self.rotation.apply(other.translation)
                       + self.translation)
        return self.apply(other)


pytree.register_pytree_node(
    SE3, lambda s: ([s.rotation, s.translation], None),
    lambda v, _: SE3(*v),
    serialized_type_name="tinyopt_tpu_torch.manifolds.SE3")


def _se3_dims(x: SE3) -> int:
    """6 a pose; leading batch axes multiply."""
    n = 1
    for s in x.translation.shape[:-1]:
        n *= int(s)
    return 6 * n


def _se3_retract(x: SE3, delta):
    d = SE3.exp(delta.reshape(x.translation.shape[:-1] + (6,))
                .to(x.translation.dtype))
    return SE3(SO3(_qmul(x.rotation.wxyz, d.rotation.wxyz)),
               x.rotation.apply(d.translation) + x.translation)


def _se3_local(x: SE3, y: SE3):
    return (x.inverse() @ y).log().reshape(-1)


register_manifold(SE3, Manifold(
    dims=_se3_dims,
    retract=_se3_retract,
    local=_se3_local,
))
