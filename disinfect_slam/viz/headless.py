"""Headless visualization: raycast views to PNG, orbit videos.

Replaces the reference's GLFW/ImGui interactive viewer stack
(utils/gl/*, modules/renderer_module.*) for server hosts with no
display: the same raycast images (rgba + normal-shaded,
renderer_module.cc:104-109) are written to disk instead of a GL texture.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..io.png_io import write_image
from ..systems.tsdf_grid import TSDFGrid


def render_to_png(
    grid: TSDFGrid,
    out_dir: str,
    cam_T_world: np.ndarray,
    virtual_cam: Tuple[Tuple[float, float, float, float], int, int],
    max_depth: float = 10.0,
    prefix: str = "view",
    renderer: str = "raycast",
) -> Tuple[str, str]:
    """Render one virtual view; writes <prefix>_rgba.png and
    <prefix>_normal.png, returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    res = grid.ray_cast(max_depth, virtual_cam, cam_T_world, renderer=renderer)
    rgba_path = os.path.join(out_dir, f"{prefix}_rgba.png")
    normal_path = os.path.join(out_dir, f"{prefix}_normal.png")
    write_image(rgba_path, np.asarray(res.rgba))
    write_image(normal_path, np.asarray(res.normal))
    return rgba_path, normal_path


def orbit_poses(center, radius: float, n: int, height: float = 0.0):
    """Camera poses orbiting `center`, looking inward."""
    import math

    poses = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        eye = np.array(
            [
                center[0] + math.sin(ang) * radius,
                center[1] + height,
                center[2] - math.cos(ang) * radius,
            ]
        )
        poses.append(look_at(eye, center))
    return poses


def look_at(eye, target, up=(0, -1, 0)) -> np.ndarray:
    """cam_T_world for a camera at eye looking at target (+z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    world_T_cam = np.eye(4)
    world_T_cam[:3, 0] = right
    world_T_cam[:3, 1] = down
    world_T_cam[:3, 2] = fwd
    world_T_cam[:3, 3] = eye
    return np.linalg.inv(world_T_cam).astype(np.float32)
