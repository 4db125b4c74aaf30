"""ICP odometry tests: recover a known small camera motion on synthetic
depth frames."""

import numpy as np

from disinfect_slam.systems.odometry import ICPOdometry

from .scenes import look_at, render_sphere, render_wall

W, H = 160, 120
K = (131.7, 132.3, 79.7, 59.4)


def scene_depth(pose):
    d1 = render_sphere(W, H, K, pose, center=(0.2, 0.0, 1.6), radius=0.45)
    d2 = render_wall(W, H, K, pose, wall_z=2.4131)
    d3 = render_sphere(W, H, K, pose, center=(-0.5, 0.3, 1.9), radius=0.3)
    d = np.where(d1 > 0, d1, d2)
    return np.where(d3 > 0, d3, d).astype(np.float32)


def test_icp_recovers_translation():
    p0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
    p1 = look_at((0.02, 0.01, -0.49), (0.0, 0.0, 1.6))
    odo = ICPOdometry(K, H, W)
    c0, ok0 = odo.feed(scene_depth(p0))
    assert ok0
    c1, ok1 = odo.feed(scene_depth(p1))
    assert ok1
    # the tracker's world frame is the first camera; compare RELATIVE
    # motion cam1_T_cam0
    rel_est = c1 @ np.linalg.inv(c0)
    rel_true = p1 @ np.linalg.inv(p0)
    t_err = np.linalg.norm(rel_est[:3, 3] - rel_true[:3, 3])
    assert t_err < 0.005, (rel_est[:3, 3], rel_true[:3, 3])


def test_icp_recovers_small_rotation():
    from scipy.spatial.transform import Rotation

    p0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
    p1 = look_at((0.0, 0.0, -0.5), (0.05, 0.02, 1.6))  # ~1.4 deg rotation
    odo = ICPOdometry(K, H, W)
    c0, _ = odo.feed(scene_depth(p0))
    c1, ok = odo.feed(scene_depth(p1))
    assert ok
    rel_est = c1 @ np.linalg.inv(c0)
    rel_true = p1 @ np.linalg.inv(p0)
    r_err = Rotation.from_matrix(
        rel_est[:3, :3] @ rel_true[:3, :3].T
    ).magnitude() * 180 / np.pi
    assert r_err < 0.3, r_err


def test_icp_static_stays_put():
    p0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
    odo = ICPOdometry(K, H, W)
    c0, _ = odo.feed(scene_depth(p0))
    c1, ok = odo.feed(scene_depth(p0))
    assert ok
    drift = np.linalg.norm((c1 @ np.linalg.inv(c0))[:3, 3])
    assert drift < 1e-3


def test_icp_robust_to_outlier_patch():
    """A corrupted depth region (sensor glare / dynamic object) must not
    break tracking thanks to Huber weighting."""
    p0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
    p1 = look_at((0.02, 0.01, -0.49), (0.0, 0.0, 1.6))
    d0 = scene_depth(p0)
    d1 = scene_depth(p1)
    # corrupt a 24x30 patch with bogus near depth
    d1c = d1.copy()
    d1c[40:64, 60:90] = 0.3
    odo = ICPOdometry(K, H, W)
    c0, _ = odo.feed(d0)
    c1, ok = odo.feed(d1c)
    assert ok
    rel_est = c1 @ np.linalg.inv(c0)
    rel_true = p1 @ np.linalg.inv(p0)
    t_err = np.linalg.norm(rel_est[:3, 3] - rel_true[:3, 3])
    assert t_err < 0.012, t_err
