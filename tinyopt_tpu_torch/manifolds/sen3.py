"""Generic SEₙ(3) group manifold: one rotation and n translational
3-vectors.

Counterpart of ``tinyopt_tpu.manifolds.sen3`` (reference: include/
tinyopt/3rdparty/traits/lieplusplus.h:17-53, ``SEn3<T, n>`` with
``Dims = 3 + 3n``); ``SE3`` and ``SE23`` are the n = 1 and n = 2 cases
with named fields.  Tangent layout ``[v₁, …, vₙ, ω]`` (translational parts
first, rotation last, as SE23's ``[ν, ρ, ω]``), dimension 3(n+1),
retraction ``X ⊞ δ = X · exp(δ)`` with the shared SO(3) left Jacobian
V(ω) applied to every translational part.  Stored values flatten to
4 + 3n an element: ``rotation.wxyz`` then ``vectors`` row by row.  Every
op broadcasts over leading axes and runs under ``torch.func``
transforms (Taylor-guarded near θ = 0).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from ..manifold import Manifold, register_manifold
from .se23 import _V_apply, _V_inv_apply
from .so3 import SO3, _exp_quat, _qmul


def _apply_n(rot: SO3, p):
    """Rotate (..., n, 3) points: the quaternion broadcast over n."""
    return SO3(rot.wxyz[..., None, :]).apply(p)


@dataclasses.dataclass
class SEn3:
    rotation: SO3
    vectors: torch.Tensor  #: (..., n, 3) — the n translational parts

    @staticmethod
    def identity(n: int, dtype=torch.float32, batch=(),
                 device=None) -> "SEn3":
        return SEn3(SO3.identity(dtype, batch, device),
                    torch.zeros(tuple(batch) + (n, 3), dtype=dtype,
                                device=device))

    @property
    def n(self) -> int:
        return self.vectors.shape[-2]

    @staticmethod
    def exp(delta) -> "SEn3":
        """Tangent (..., 3(n+1)) = [v₁, …, vₙ, ω] -> SEₙ(3)."""
        delta = torch.as_tensor(delta)
        n = delta.shape[-1] // 3 - 1
        omega = delta[..., 3 * n:]
        vs = delta[..., :3 * n].reshape(delta.shape[:-1] + (n, 3))
        # V(ω) is shared by the n parts: ω broadcast over the n axis
        return SEn3(SO3(_exp_quat(omega)), _V_apply(omega[..., None, :], vs))

    def log(self) -> torch.Tensor:
        omega = self.rotation.log()
        vs = _V_inv_apply(omega[..., None, :], self.vectors)
        flat = vs.reshape(vs.shape[:-2] + (3 * self.n,))
        return torch.cat([flat, omega], dim=-1)

    def inverse(self) -> "SEn3":
        rinv = self.rotation.inverse()
        return SEn3(rinv, -_apply_n(rinv, self.vectors))

    def __matmul__(self, other: "SEn3") -> "SEn3":
        return SEn3(SO3(_qmul(self.rotation.wxyz, other.rotation.wxyz)),
                    _apply_n(self.rotation, other.vectors) + self.vectors)


pytree.register_pytree_node(
    SEn3, lambda s: ([s.rotation, s.vectors], None),
    lambda v, _: SEn3(*v),
    serialized_type_name="tinyopt_tpu_torch.manifolds.SEn3")


def _sen3_dims(x: SEn3) -> int:
    """3(n+1) an element; leading batch axes multiply."""
    count = 1
    for s in x.vectors.shape[:-2]:
        count *= int(s)
    return 3 * (x.n + 1) * count


def _sen3_retract(x: SEn3, delta):
    d = SEn3.exp(delta.reshape(x.vectors.shape[:-2] + (3 * (x.n + 1),))
                 .to(x.vectors.dtype))
    return x @ d


def _sen3_local(x: SEn3, y: SEn3):
    return (x.inverse() @ y).log().reshape(-1)


register_manifold(SEn3, Manifold(
    dims=_sen3_dims,
    retract=_sen3_retract,
    local=_sen3_local,
))
