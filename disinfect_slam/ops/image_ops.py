"""Batched image preprocessing as XLA ops.

JAX equivalents of the reference's OpenCV-based preprocessing:
  - stereo rectification remap (StereoRectifier::rectify, two cv::remap
    INTER_LINEAR calls over precomputed maps, stereo_rectifier.cc:72-76)
  - rectification map construction from raw stereo calibration
    (cv::stereoRectify + cv::initUndistortRectifyMap,
    stereo_rectifier.cc:10-48) — computed once on host with OpenCV when
    available, else with the pure-numpy fallback implementing the same
    Bouguet epipolar alignment
  - depth scaling / half-resolution resize (disinfect_slam.cc:37-43)

The per-frame path (remap/resize/scale) is pure jnp so it fuses into the
integrate step's program and runs on-device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def bilinear_remap(img: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray) -> jnp.ndarray:
    """cv::remap(..., INTER_LINEAR) equivalent.

    img [H, W] or [H, W, C]; map_x/map_y [Ho, Wo] give source pixel
    coords. Out-of-range samples clamp to the border (BORDER_REPLICATE
    behavior is close enough to OpenCV's default constant border for
    rectified interiors; the valid region is identical).
    """
    h, w = img.shape[:2]
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)

    def gather(yy, xx):
        return img[yy, xx]

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x1i)
    v10 = gather(y1i, x0i)
    v11 = gather(y1i, x1i)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def half_scale(img: jnp.ndarray) -> jnp.ndarray:
    """2x nearest downsample (the cv::resize(0.5) + pyrDown-ish path of
    disinfect_slam.cc:37-41 uses INTER_NEAREST-equivalent decimation)."""
    return img[::2, ::2]


def scale_depth(depth_raw: jnp.ndarray, depth_factor: float) -> jnp.ndarray:
    """u16 depth counts -> metres (convertTo 1/depthmap_factor)."""
    return depth_raw.astype(jnp.float32) / depth_factor


class RectifyMaps(NamedTuple):
    """Precomputed undistort-rectify maps for a stereo pair."""

    left_x: np.ndarray
    left_y: np.ndarray
    right_x: np.ndarray
    right_y: np.ndarray
    rectified_intrinsics: Tuple[float, float, float, float]


def _undistort_rectify_map(K, dist, R, P, size):
    """numpy initUndistortRectifyMap: for each rectified pixel, apply
    P^-1, rotate by R^-1, distort, project through K."""
    w, h = size
    fx_p, fy_p, cx_p, cy_p = P[0, 0], P[1, 1], P[0, 2], P[1, 2]
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (uu - cx_p) / fx_p
    y = (vv - cy_p) / fy_p
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(R).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = K[0, 0] * x_d + K[0, 2]
    map_y = K[1, 1] * y_d + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def build_rectify_maps(
    K_l: np.ndarray,
    D_l: np.ndarray,
    K_r: np.ndarray,
    D_r: np.ndarray,
    R_rl: np.ndarray,
    t_rl: np.ndarray,
    size: Tuple[int, int],
) -> RectifyMaps:
    """StereoRectifier construction (stereo_rectifier.cc:10-48).

    size = (width, height); R_rl/t_rl: right_R_left / right_t_left.
    Uses cv2.stereoRectify when available (exact OpenCV parity),
    otherwise a Bouguet-style numpy construction.
    """
    w, h = size
    try:
        import cv2

        R_l, R_r, P_l, P_r, Q, _, _ = cv2.stereoRectify(
            K_l, np.asarray(D_l, np.float64), K_r, np.asarray(D_r, np.float64),
            (w, h), np.asarray(R_rl, np.float64), np.asarray(t_rl, np.float64).reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
        )
    except Exception:
        # Bouguet: split the relative rotation, align epipolar lines with
        # the baseline direction
        from scipy.spatial.transform import Rotation

        r_half = Rotation.from_matrix(R_rl)
        rvec = r_half.as_rotvec()
        R_half_inv = Rotation.from_rotvec(-rvec / 2).as_matrix()
        t = R_half_inv @ np.asarray(t_rl, np.float64).reshape(3)
        e1 = t / np.linalg.norm(t)
        e2 = np.array([-t[1], t[0], 0.0])
        e2 /= np.linalg.norm(e2) if np.linalg.norm(e2) > 0 else 1.0
        e3 = np.cross(e1, e2)
        R_rect = np.stack([e1, e2, e3])
        R_l = R_rect @ R_half_inv
        R_r = R_rect @ Rotation.from_rotvec(rvec / 2).as_matrix()
        f = (K_l[0, 0] + K_l[1, 1] + K_r[0, 0] + K_r[1, 1]) / 4
        cx, cy = (w - 1) / 2, (h - 1) / 2
        P_l = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
        P_r = P_l.copy()
        P_r[0, 3] = f * np.linalg.norm(t_rl)

    lx, ly = _undistort_rectify_map(K_l, D_l, R_l, P_l, (w, h))
    rx, ry = _undistort_rectify_map(K_r, D_r, R_r, P_r, (w, h))
    return RectifyMaps(
        left_x=lx,
        left_y=ly,
        right_x=rx,
        right_y=ry,
        rectified_intrinsics=(
            float(P_r[0, 0]),
            float(P_r[1, 1]),
            float(P_r[0, 2]),
            float(P_r[1, 2]),
        ),
    )


class StereoRectifier:
    """API parity with utils/stereo_rectifier.h: rectify(left, right) via
    the precomputed maps, rectified intrinsics exposure."""

    def __init__(self, maps: RectifyMaps):
        self.maps = maps
        self._remap = jax.jit(
            lambda l, r: (
                bilinear_remap(l, jnp.asarray(maps.left_x), jnp.asarray(maps.left_y)),
                bilinear_remap(r, jnp.asarray(maps.right_x), jnp.asarray(maps.right_y)),
            )
        )

    @classmethod
    def from_yaml(cls, config: dict) -> "StereoRectifier":
        """YAML layout of configs/zed_native_stereo.yaml
        (stereo_rectifier.cc:50-68): Calibration.left/right fx..distortion
        + rotation (Rodrigues vector) + translation."""
        from scipy.spatial.transform import Rotation

        def mono(side):
            return (
                np.array(
                    [
                        [config[f"Calibration.{side}.fx"], 0, config[f"Calibration.{side}.cx"]],
                        [0, config[f"Calibration.{side}.fy"], config[f"Calibration.{side}.cy"]],
                        [0, 0, 1],
                    ],
                    np.float64,
                ),
                np.asarray(config[f"Calibration.{side}.distortion"], np.float64),
            )

        K_l, D_l = mono("left")
        K_r, D_r = mono("right")
        rot = np.asarray(config["Calibration.rotation"], np.float64)
        R_rl = Rotation.from_rotvec(rot).as_matrix()
        t_rl = np.asarray(config["Calibration.translation"], np.float64)
        size = (int(config["Camera.cols"]), int(config["Camera.rows"]))
        return cls(build_rectify_maps(K_l, D_l, K_r, D_r, R_rl, t_rl, size))

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        l, r = self._remap(
            jnp.asarray(img_l, jnp.float32), jnp.asarray(img_r, jnp.float32)
        )
        return np.asarray(l), np.asarray(r)

    def rectified_intrinsics(self) -> Tuple[float, float, float, float]:
        return self.maps.rectified_intrinsics
