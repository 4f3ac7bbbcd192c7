"""SE₂(3) extended-pose manifold (rotation + velocity + position).

Counterpart of ``tinyopt_tpu.manifolds.se23``: tangent layout
``[ν (velocity), ρ (position), ω (rotation)]`` (9-dim), retraction
``X ⊞ δ = X · exp(δ)`` with the SO(3) left Jacobian V(ω) applied to both
translational parts.  ``_V_apply`` / ``_V_inv_apply`` are shared with
``se3.py``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from ..manifold import Manifold, register_manifold
from .so3 import SO3, _cross, _exp_quat, _qmul, _small, _sum3


def _V_apply(omega, rho):
    """V(ω)·ρ where V = I + a[ω]ₓ + b[ω]ₓ² (Taylor-guarded near 0)."""
    theta2 = _sum3(omega * omega)
    small = _small(theta2)
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    wx = _cross(omega, rho)
    wwx = _cross(omega, wx)
    return rho + a * wx + b * wwx


def _V_inv_apply(omega, t):
    """V(ω)⁻¹·t (Taylor-guarded)."""
    theta2 = _sum3(omega * omega)
    small = _small(theta2)
    one = torch.ones_like(theta2)
    theta = torch.sqrt(torch.where(small, one, theta2))
    half = 0.5 * theta
    cot = torch.cos(half) / torch.sin(torch.where(small, one, half))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * cot) / torch.where(small, one, theta2))
    wt = _cross(omega, t)
    wwt = _cross(omega, wt)
    return t - 0.5 * wt + c * wwt


@dataclasses.dataclass
class SE23:
    rotation: SO3
    velocity: torch.Tensor   #: (..., 3)
    position: torch.Tensor   #: (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, batch=(), device=None) -> "SE23":
        z = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
        return SE23(SO3.identity(dtype, batch, device), z, z.clone())

    @staticmethod
    def exp(delta) -> "SE23":
        """Tangent (..., 9) = [ν, ρ, ω] -> SE₂(3)."""
        delta = torch.as_tensor(delta)
        nu, rho, omega = delta[..., :3], delta[..., 3:6], delta[..., 6:]
        return SE23(SO3(_exp_quat(omega)), _V_apply(omega, nu),
                    _V_apply(omega, rho))

    def log(self) -> torch.Tensor:
        omega = self.rotation.log()
        nu = _V_inv_apply(omega, self.velocity)
        rho = _V_inv_apply(omega, self.position)
        return torch.cat([nu, rho, omega], dim=-1)

    def inverse(self) -> "SE23":
        rinv = self.rotation.inverse()
        return SE23(rinv, -rinv.apply(self.velocity),
                    -rinv.apply(self.position))

    def __matmul__(self, other: "SE23") -> "SE23":
        return SE23(
            SO3(_qmul(self.rotation.wxyz, other.rotation.wxyz)),
            self.rotation.apply(other.velocity) + self.velocity,
            self.rotation.apply(other.position) + self.position,
        )


pytree.register_pytree_node(
    SE23, lambda s: ([s.rotation, s.velocity, s.position], None),
    lambda v, _: SE23(*v),
    serialized_type_name="tinyopt_tpu_torch.manifolds.SE23")


def _se23_dims(x: SE23) -> int:
    n = 1
    for s in x.position.shape[:-1]:
        n *= int(s)
    return 9 * n


def _se23_retract(x: SE23, delta):
    d = SE23.exp(delta.reshape(x.position.shape[:-1] + (9,))
                 .to(x.position.dtype))
    return x @ d


def _se23_local(x: SE23, y: SE23):
    return (x.inverse() @ y).log().reshape(-1)


register_manifold(SE23, Manifold(
    dims=_se23_dims,
    retract=_se23_retract,
    local=_se23_local,
))
