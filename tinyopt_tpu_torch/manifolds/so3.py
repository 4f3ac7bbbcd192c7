"""SO(3) rotation manifold (unit quaternion, wxyz), a pytree and a
registered manifold.

Counterpart of ``tinyopt_tpu.manifolds.so3``: tangent dimension 3,
retraction ``R ⊞ δ = R · exp(δ)`` (right-multiply), exp / log maps with
Taylor guards that keep values AND derivatives finite at θ = 0 (the
linearization point of every solve).  Every op broadcasts over leading
axes and has no data-dependent control flow, so it runs under
``torch.func.vmap`` / ``jvp`` / ``vjp``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from ..manifold import Manifold, register_manifold


def _small(theta2):
    """Small-angle guard threshold, dtype-aware (float32-safe)."""
    return theta2 < torch.finfo(theta2.dtype).eps ** 0.5


def _cross(a, b):
    """a × b over the last axis, broadcasting leading axes (written by
    components: the same arithmetic under ``torch.func`` transforms)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _sum3(v):
    """Sum over the last axis (3 entries), as ((v0 + v1) + v2)."""
    v0, v1, v2 = v.unbind(-1)
    return ((v0 + v1) + v2)[..., None]


def _qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _exp_quat(w):
    """so(3) -> unit quaternion, finite under differentiation at θ = 0.

    The where-guard idiom: the singular branch never sees θ = 0 (its
    operand is replaced by 1), and small angles take a Taylor series whose
    derivative is exact at 0."""
    theta2 = _sum3(w * w)
    small = _small(theta2)
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([qw, k * w], dim=-1)


def _log_quat(q):
    """Unit quaternion -> so(3) tangent (angle-axis), finite under
    differentiation."""
    qw = q[..., :1]
    qv = q[..., 1:]
    n2 = _sum3(qv * qv)
    small = _small(n2)
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(n, torch.abs(qw))
    # angle/n ≈ 2/|qw| · (1 − n²/(3qw²)) for small n (the sign(qw) factor
    # below handles the quaternion double cover)
    aqw = torch.clamp(torch.abs(qw), min=1e-3)
    scale = torch.where(small, 2.0 / aqw * (1.0 - n2 / (3.0 * aqw * aqw)),
                        angle / n)
    sign = torch.where(qw < 0, -torch.ones_like(qw), torch.ones_like(qw))
    return sign * scale * qv


@dataclasses.dataclass
class SO3:
    wxyz: torch.Tensor  #: (..., 4) unit quaternion, scalar-first

    @staticmethod
    def identity(dtype=torch.float32, batch=(), device=None) -> "SO3":
        q = torch.zeros(tuple(batch) + (4,), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return SO3(q)

    @staticmethod
    def exp(w) -> "SO3":
        return SO3(_exp_quat(torch.as_tensor(w)))

    @staticmethod
    def from_matrix(R) -> "SO3":
        """Rotation matrix -> quaternion (Shepperd's method, branchless):
        the largest of the four candidate traces anchors the
        reconstruction, so every rotation, 180° included, comes out
        right."""
        R = torch.as_tensor(R)
        m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
        m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
        m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
        t0 = 1.0 + m00 + m11 + m22
        t1 = 1.0 + m00 - m11 - m22
        t2 = 1.0 - m00 + m11 - m22
        t3 = 1.0 - m00 - m11 + m22
        ts = torch.stack([t0, t1, t2, t3], dim=-1)

        def cand(t, a, b, c):
            s = torch.sqrt(torch.clamp(t, min=1e-30))
            inv = 0.5 / s
            return s * 0.5, a * inv, b * inv, c * inv

        w0, x0, y0, z0 = cand(t0, m21 - m12, m02 - m20, m10 - m01)
        x1, w1, y1, z1 = cand(t1, m21 - m12, m01 + m10, m02 + m20)
        y2, w2, x2, z2 = cand(t2, m02 - m20, m01 + m10, m12 + m21)
        z3, w3, x3, y3 = cand(t3, m10 - m01, m02 + m20, m12 + m21)
        qs = torch.stack([
            torch.stack([w0, x0, y0, z0], dim=-1),
            torch.stack([w1, x1, y1, z1], dim=-1),
            torch.stack([w2, x2, y2, z2], dim=-1),
            torch.stack([w3, x3, y3, z3], dim=-1),
        ], dim=-2)                                    # (..., 4 cases, 4)
        k = torch.argmax(ts, dim=-1)
        idx = k[..., None, None].expand(k.shape + (1, 4))
        q = torch.take_along_dim(qs, idx, dim=-2)[..., 0, :]
        return SO3(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))

    def log(self):
        return _log_quat(self.wxyz)

    def matrix(self):
        w, x, y, z = self.wxyz.unbind(-1)
        row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                            2 * (x * z + w * y)], dim=-1)
        row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                            2 * (y * z - w * x)], dim=-1)
        row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                            1 - 2 * (x * x + y * y)], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def apply(self, p):
        """Rotate points p (..., 3)."""
        qv = self.wxyz[..., 1:]
        qw = self.wxyz[..., :1]
        t = 2.0 * _cross(qv, p)
        return p + qw * t + _cross(qv, t)

    def inverse(self) -> "SO3":
        sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=self.wxyz.dtype,
                            device=self.wxyz.device)
        return SO3(self.wxyz * sign)

    def __matmul__(self, other):
        if isinstance(other, SO3):
            return SO3(_qmul(self.wxyz, other.wxyz))
        return self.apply(other)

    def normalized(self) -> "SO3":
        return SO3(self.wxyz / torch.linalg.vector_norm(
            self.wxyz, dim=-1, keepdim=True))


pytree.register_pytree_node(
    SO3, lambda s: ([s.wxyz], None), lambda v, _: SO3(*v),
    serialized_type_name="tinyopt_tpu_torch.manifolds.SO3")


def _so3_dims(x: SO3) -> int:
    """3 a rotation; leading batch axes multiply (a batched SO3 leaf is a
    valid parameter block)."""
    n = 1
    for s in x.wxyz.shape[:-1]:
        n *= int(s)
    return 3 * n


def _so3_retract(x: SO3, delta):
    d = delta.reshape(x.wxyz.shape[:-1] + (3,)).to(x.wxyz.dtype)
    return SO3(_qmul(x.wxyz, _exp_quat(d)))


def _so3_local(x: SO3, y: SO3):
    return _log_quat(_qmul(x.inverse().wxyz, y.wxyz)).reshape(-1)


register_manifold(SO3, Manifold(
    dims=_so3_dims,
    retract=_so3_retract,
    local=_so3_local,
))
