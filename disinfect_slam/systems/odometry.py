"""Projective ICP visual odometry in JAX (built-in pose source).

The reference delegates pose tracking to external SLAM libraries
(OpenVSLAM via modules/slam_module.*, ORB_SLAM3 via disinfect_slam.cc);
the framework keeps that external-bridge interface (systems/slam.py) but
also ships this self-contained KinectFusion-style tracker so the full
online pipeline can run in JAX without any external dependency.

Method: frame-to-frame (or frame-to-model) point-to-plane ICP over an
image pyramid.  Each iteration is reduction-dominated — the 6x6 normal
equations are built with one big [N, 6] x [N, 6] contraction.

  residual r_i = n_i . (T v_i - p_i)
  J_i = [p x n | n]  (se3 generators),  solve (J^T J) dx = -J^T r,
  T <- exp(dx) T
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import CameraIntrinsics, CameraParams

# f32 matmuls at HIGHEST precision: on the GPU an f32 dot may otherwise
# run in TF32 (10-bit mantissa), which puts millimetre errors into the
# point transforms and degrades the 6x6 normal equations of each ICP
# step.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def vertex_map(depth: jnp.ndarray, cam: CameraParams) -> jnp.ndarray:
    """Depth [H, W] -> camera-space points [H, W, 3] (0-depth -> 0)."""
    u = jnp.arange(cam.img_w, dtype=jnp.float32)
    v = jnp.arange(cam.img_h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    dirs = cam.intrinsics_inv.project(jnp.stack([uu, vv, jnp.ones_like(uu)], -1))
    return dirs * depth[..., None]


def normal_map(verts: jnp.ndarray) -> jnp.ndarray:
    """Screen-space normals from a vertex map (cross of finite diffs)."""
    dx = jnp.roll(verts, -1, axis=1) - verts
    dy = jnp.roll(verts, -1, axis=0) - verts
    n = jnp.cross(dx, dy)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(nn == 0, 1.0, nn)


def _exp_se3(xi: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """se3 exp map: xi = (omega[3], v[3]) -> (R [3,3], t [3])."""
    omega = xi[:3]
    v = xi[3:]
    theta = jnp.linalg.norm(omega) + 1e-12
    k = omega / theta
    kx = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]], jnp.float32
    )
    s, c = jnp.sin(theta), jnp.cos(theta)
    r = jnp.eye(3) + s * kx + (1 - c) * _mm(kx, kx)
    vmat = (
        jnp.eye(3) + (1 - c) / theta * kx + (theta - s) / theta * _mm(kx, kx)
    )
    return r, _mm(vmat, v)


def _downsample(depth: jnp.ndarray) -> jnp.ndarray:
    """2x decimation keeping invalid zeros invalid."""
    return depth[::2, ::2]


class ICPResult(NamedTuple):
    cam_T_world: jnp.ndarray  # 4x4
    rmse: jnp.ndarray  # final inlier residual RMS
    inliers: jnp.ndarray  # inlier count at the finest level


def _icp_level(
    T0: jnp.ndarray,
    src_verts: jnp.ndarray,  # [H, W, 3] current frame, camera space
    ref_verts_w: jnp.ndarray,  # [H, W, 3] reference surface, world space
    ref_normals_w: jnp.ndarray,  # [H, W, 3] world space
    ref_valid: jnp.ndarray,  # [H, W]
    cam: CameraParams,
    ref_cam_T_world: jnp.ndarray,  # 4x4 of the reference view
    iters: int,
    dist_thresh: float,
    huber_delta: float,
):
    """Iterate point-to-plane ICP at one pyramid level.

    T0: initial world_T_cam estimate for the current frame (4x4).
    Returns refined world_T_cam.
    """
    h, w = src_verts.shape[:2]
    src = src_verts.reshape(-1, 3)
    src_valid = src[:, 2] > 0
    # pack vertex + normal + validity into ONE [N, 8] row array: the
    # per-iteration correspondence lookup becomes a single row gather
    # instead of three (N indices per gather regardless of row width)
    ref_pack = jnp.concatenate(
        [
            ref_verts_w.reshape(-1, 3),
            ref_normals_w.reshape(-1, 3),
            ref_valid.reshape(-1, 1).astype(jnp.float32),
            jnp.zeros((h * w, 1), jnp.float32),
        ],
        axis=1,
    )

    fx, fy = cam.intrinsics.fx, cam.intrinsics.fy
    cx, cy = cam.intrinsics.cx, cam.intrinsics.cy
    ref_R = ref_cam_T_world[:3, :3]
    ref_t = ref_cam_T_world[:3, 3]

    def body(_, carry):
        T, _, _ = carry
        r_mat = T[:3, :3]
        t_vec = T[:3, 3]
        p_w = _mm(src, r_mat.T) + t_vec  # current points in world

        # project into the reference view to find correspondences
        p_ref = _mm(p_w, ref_R.T) + ref_t
        z = p_ref[:, 2]
        u = fx * p_ref[:, 0] / z + cx
        v = fy * p_ref[:, 1] / z + cy
        ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, w - 1)
        vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, h - 1)
        idx = vi * w + ui
        in_img = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 0)

        g = ref_pack[idx]  # one row gather: vertex | normal | valid
        q = g[:, 0:3]
        n = g[:, 3:6]
        diff = p_w - q
        dist_ok = jnp.sum(diff * diff, axis=-1) < dist_thresh * dist_thresh
        valid = src_valid & in_img & (g[:, 6] > 0) & dist_ok
        r_res = jnp.sum(n * diff, axis=-1)

        # Huber IRLS weights: quadratic near zero, linear in the tails —
        # keeps outlier correspondences from dominating the normal
        # equations
        r_abs = jnp.abs(r_res)
        huber = jnp.minimum(1.0, huber_delta / jnp.maximum(r_abs, 1e-12))
        wgt = valid.astype(jnp.float32) * huber
        jac = jnp.concatenate([jnp.cross(p_w, n), n], axis=-1)  # [N, 6]
        jw = jac * wgt[:, None]
        # 6x6 normal equations + rhs
        jtj = _mm(jw.T, jac)
        jtr = _mm(jw.T, r_res)
        dx = jnp.linalg.solve(jtj + 1e-6 * jnp.eye(6), -jtr)
        r_up, t_up = _exp_se3(dx)
        T_new = jnp.eye(4)
        T_new = T_new.at[:3, :3].set(_mm(r_up, r_mat))
        T_new = T_new.at[:3, 3].set(_mm(r_up, t_vec) + t_up)
        inliers = valid.astype(jnp.float32)
        rmse = jnp.sqrt(
            jnp.sum(r_res * r_res * inliers) / jnp.maximum(jnp.sum(inliers), 1.0)
        )
        return T_new, rmse, jnp.sum(inliers)

    T, rmse, inl = jax.lax.fori_loop(
        0, iters, body, (T0, jnp.asarray(0.0), jnp.asarray(0.0))
    )
    return T, rmse, inl


class ICPOdometry:
    """Frame-to-frame projective ICP tracker with a pyramid schedule.

    feed(depth, timestamp) -> (cam_T_world 4x4, tracking_ok), mirroring
    the feed_*_w_feedback contract of the reference SLAM wrapper
    (slam_module.cc:100-142).
    """

    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        levels: int = 3,
        iters: Tuple[int, ...] = (4, 5, 10),
        dist_thresh: float = 0.25,
        max_rmse: float = 0.06,
        huber_delta: float = 0.05,
    ):
        self.levels = levels
        self.iters = iters
        self.dist_thresh = dist_thresh
        self.max_rmse = max_rmse
        self.huber_delta = huber_delta
        self.cams = []
        fx, fy, cx, cy = intrinsics
        h, w = img_h, img_w
        for lv in range(levels):
            scale = 2**lv
            self.cams.append(
                CameraParams.create(
                    CameraIntrinsics.create(fx / scale, fy / scale, cx / scale, cy / scale),
                    h // scale,
                    w // scale,
                )
            )
        self._prev = None  # (verts_w per level, normals_w per level, valid, pose)
        self.world_T_cam = np.eye(4, dtype=np.float32)

        @jax.jit
        def _prep(depth):
            out = []
            d = depth
            for lv in range(self.levels):
                verts = vertex_map(d, self.cams[lv])
                normals = normal_map(verts)
                valid = d > 0
                out.append((verts, normals, valid))
                if lv + 1 < self.levels:
                    d = _downsample(d)
            return out

        self._prep = _prep

        @jax.jit
        def _track(T0, pyr_cur, pyr_ref, ref_pose):
            T = T0
            rmse = jnp.asarray(0.0)
            inl = jnp.asarray(0.0)
            for lv in reversed(range(self.levels)):  # coarse to fine
                verts_c, _, _ = pyr_cur[lv]
                verts_r, normals_r, valid_r = pyr_ref[lv]
                # reference maps to world coordinates
                ref_world_T_cam = jnp.linalg.inv(ref_pose)
                rw = _mm(verts_r, ref_world_T_cam[:3, :3].T) + ref_world_T_cam[:3, 3]
                nw = _mm(normals_r, ref_world_T_cam[:3, :3].T)
                T, rmse, inl = _icp_level(
                    T,
                    verts_c,
                    rw,
                    nw,
                    valid_r,
                    self.cams[lv],
                    ref_pose,
                    self.iters[min(lv, len(self.iters) - 1)],
                    self.dist_thresh,
                    self.huber_delta,
                )
            return T, rmse, inl

        self._track = _track

    def feed(self, depth: np.ndarray, timestamp_ms: int = 0):
        """Track one depth frame; returns (cam_T_world, ok)."""
        d = jnp.asarray(depth, jnp.float32)
        pyr = self._prep(d)
        if self._prev is None:
            self._prev = (pyr, jnp.asarray(np.linalg.inv(self.world_T_cam)))
            return np.linalg.inv(self.world_T_cam), True
        prev_pyr, prev_pose = self._prev
        T0 = jnp.asarray(self.world_T_cam)
        T, rmse, inl = self._track(T0, pyr, prev_pyr, prev_pose)
        ok = bool(np.isfinite(float(rmse))) and float(rmse) < self.max_rmse and float(inl) > 100
        if ok:
            self.world_T_cam = np.asarray(T, np.float32)
        cam_T_world = np.linalg.inv(self.world_T_cam).astype(np.float32)
        self._prev = (pyr, jnp.asarray(cam_T_world))
        return cam_T_world, ok

    def feed_stereo(self, img_left, img_right, timestamp_ms, imu=None):
        raise NotImplementedError("ICPOdometry tracks depth frames; use feed()")
