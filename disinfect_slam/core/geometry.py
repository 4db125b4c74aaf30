"""Rigid transforms and pinhole camera models as JAX pytrees.

JAX counterparts of the reference's CUDA-side math:
  - SE3<T> quaternion+translation transform (utils/cuda/lie_group.cuh:8-45)
  - CameraIntrinsics / CameraParams        (utils/cuda/camera.cuh:13-68)

Everything is a frozen pytree of jnp arrays so transforms can be traced
through jit, vmapped over batches of points, and sharded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .pytree import pytree_dataclass, static_field


def _quat_mul(q1, q2):
    """Hamilton product, quaternions as (w, x, y, z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _quat_rotate(q, v):
    """Rotate vectors v[..., 3] by quaternion q[4] (w, x, y, z)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v' = v + 2w(u x v) + 2(u x (u x v))
    uv = jnp.cross(jnp.broadcast_to(u, v.shape), v)
    uuv = jnp.cross(jnp.broadcast_to(u, v.shape), uv)
    return v + 2.0 * (w * uv + uuv)


def _mat_to_quat(m):
    """Rotation matrix [3,3] -> quaternion (w, x, y, z). Shepperd's method."""
    m = jnp.asarray(m, jnp.float32)
    t = jnp.trace(m)
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]

    def case_w():
        s = jnp.sqrt(jnp.maximum(t + 1.0, 1e-12)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])

    def case_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])

    def case_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])

    def case_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    # idx indexes [trace, m00, m11, m22]; when t <= 0 the max is one of
    # the diagonal entries so idx directly selects case_x/y/z
    idx = jnp.argmax(jnp.stack([t, m00, m11, m22]))
    branch = jnp.where(t > 0.0, 0, jnp.clip(idx, 1, 3))
    return jax.lax.switch(
        branch.astype(jnp.int32),
        [case_w, case_x, case_y, case_z],
    )


@pytree_dataclass
class SE3:
    """Rigid transform: x' = R x + t, rotation stored as a unit quaternion.

    Mirrors the reference SE3<T> API (lie_group.cuh): apply, inverse,
    composition, identity.
    """

    q: jnp.ndarray  # [4] quaternion (w, x, y, z)
    t: jnp.ndarray  # [3]

    @classmethod
    def identity(cls) -> "SE3":
        return cls(
            q=jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32),
            t=jnp.zeros(3, jnp.float32),
        )

    @classmethod
    def from_matrix(cls, m) -> "SE3":
        """From a 3x4 or 4x4 row-major transform matrix."""
        m = jnp.asarray(m, jnp.float32)
        return cls(q=_mat_to_quat(m[:3, :3]), t=m[:3, 3])

    @classmethod
    def from_numpy(cls, m: np.ndarray) -> "SE3":
        return cls.from_matrix(np.asarray(m, np.float32))

    def matrix(self) -> jnp.ndarray:
        """As a 4x4 matrix."""
        w, x, y, z = self.q[0], self.q[1], self.q[2], self.q[3]
        r = jnp.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            jnp.float32,
        )
        top = jnp.concatenate([r, self.t[:, None]], axis=1)
        bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
        return jnp.concatenate([top, bottom], axis=0)

    def apply(self, pts: jnp.ndarray) -> jnp.ndarray:
        """Transform points [..., 3]."""
        return _quat_rotate(self.q, pts) + self.t

    def rotation_entries(self):
        """The 9 rotation-matrix scalars (r00..r22) from the quaternion.

        For SoA transform paths: wide sweeps (the per-entry visibility
        test runs over every hash entry each frame) transform component
        arrays instead of a stacked [..., 3] point array.
        """
        w, x, y, z = self.q[0], self.q[1], self.q[2], self.q[3]
        return (
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        )

    def apply_xyz(self, px, py, pz):
        """SoA transform: component arrays in, component arrays out."""
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = self.rotation_entries()
        return (
            r00 * px + r01 * py + r02 * pz + self.t[0],
            r10 * px + r11 * py + r12 * pz + self.t[1],
            r20 * px + r21 * py + r22 * pz + self.t[2],
        )

    def rotate_xyz(self, vx_, vy, vz):
        """SoA rotation (no translation): component arrays in/out."""
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = self.rotation_entries()
        return (
            r00 * vx_ + r01 * vy + r02 * vz,
            r10 * vx_ + r11 * vy + r12 * vz,
            r20 * vx_ + r21 * vy + r22 * vz,
        )

    def rotate(self, vecs: jnp.ndarray) -> jnp.ndarray:
        """Rotate vectors [..., 3] (no translation)."""
        return _quat_rotate(self.q, vecs)

    def inverse(self) -> "SE3":
        q_inv = self.q * jnp.array([1.0, -1.0, -1.0, -1.0], jnp.float32)
        return SE3(q=q_inv, t=_quat_rotate(q_inv, -self.t))

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply `other` first)."""
        return SE3(q=_quat_mul(self.q, other.q), t=_quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)


@pytree_dataclass
class CameraIntrinsics:
    """Pinhole intrinsics; mirrors CameraIntrinsics<T> (camera.cuh:13-52)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @classmethod
    def create(cls, fx, fy, cx, cy) -> "CameraIntrinsics":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return cls(fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy))

    def inverse(self) -> "CameraIntrinsics":
        """Closed-form inverse (camera.cuh:35-39)."""
        fx_inv = 1.0 / self.fx
        fy_inv = 1.0 / self.fy
        return CameraIntrinsics(
            fx=fx_inv, fy=fy_inv, cx=-self.cx * fx_inv, cy=-self.cy * fy_inv
        )

    def project(self, pts: jnp.ndarray) -> jnp.ndarray:
        """[..., 3] camera points -> homogeneous image coords (u*z, v*z, z)."""
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return jnp.stack([self.fx * x + self.cx * z, self.fy * y + self.cy * z, z], axis=-1)

    def unproject(self, uv1: jnp.ndarray) -> jnp.ndarray:
        """Apply as a linear map to homogeneous pixels [..., 3] (use on
        .inverse() to back-project, matching intrinsics_inv * (u,v,1))."""
        return self.project(uv1)

    def matrix(self) -> jnp.ndarray:
        z = jnp.zeros((), jnp.float32)
        o = jnp.ones((), jnp.float32)
        return jnp.array(
            [[self.fx, z, self.cx], [z, self.fy, self.cy], [z, z, o]], jnp.float32
        )


@pytree_dataclass
class CameraParams:
    """Intrinsics + inverse + static image size (camera.cuh:54-68).

    Height/width are static Python ints (pytree aux data) so image shapes
    stay compile-time constants.
    """

    intrinsics: CameraIntrinsics
    intrinsics_inv: CameraIntrinsics
    img_h: int = static_field()
    img_w: int = static_field()

    @classmethod
    def create(cls, intrinsics: CameraIntrinsics, img_h: int, img_w: int) -> "CameraParams":
        return cls(
            intrinsics=intrinsics,
            intrinsics_inv=intrinsics.inverse(),
            img_h=int(img_h),
            img_w=int(img_w),
        )
