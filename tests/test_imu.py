"""Gyro preintegration tests."""

import numpy as np
from scipy.spatial.transform import Rotation

from disinfect_slam.systems.imu import (
    GyroPreintegrator,
    seed_pose_with_gyro,
)


def test_constant_rate_rotation():
    pre = GyroPreintegrator()
    # 0.5 rad/s about y for 1 s at 400 Hz
    for i in range(401):
        pre.add_raw(i * 2.5, gyro=(0.0, 0.5, 0.0))
    r = pre.relative_rotation(0.0, 1000.0)
    # camera rotated +0.5 rad about y -> world seen from camera rotates -0.5
    ang = Rotation.from_matrix(r).as_rotvec()
    np.testing.assert_allclose(ang, [0.0, -0.5, 0.0], atol=5e-3)


def test_bias_estimation():
    pre = GyroPreintegrator()
    rng = np.random.default_rng(0)
    bias = np.array([0.01, -0.02, 0.005])
    for i in range(400):
        pre.add_raw(i * 2.5, gyro=bias + rng.normal(0, 1e-4, 3))
    pre.estimate_bias(window_ms=1000.0)
    np.testing.assert_allclose(pre.bias, bias, atol=1e-3)
    r = pre.relative_rotation(0.0, 997.5)
    assert Rotation.from_matrix(r).magnitude() < 1e-2


def test_seed_pose():
    pre = GyroPreintegrator()
    for i in range(201):
        pre.add_raw(i * 2.5, gyro=(0.0, 0.0, 0.4))
    prev = np.eye(4)
    seeded = seed_pose_with_gyro(prev, pre, 0.0, 500.0)
    ang = Rotation.from_matrix(seeded[:3, :3]).as_rotvec()
    np.testing.assert_allclose(ang, [0.0, 0.0, 0.2], atol=5e-3)


def test_inertial_preintegration_constant_accel():
    from disinfect_slam.systems.imu import ImuPreintegrator

    # camera aligned with a gravity-aligned world, at rest, then a
    # constant specific force of 0.8 m/s^2 along camera x for 1 s:
    # delta_p = a t^2 / 2 = 0.4 m, v1 = 0.8 m/s
    pre = ImuPreintegrator()
    g = ImuPreintegrator.GRAVITY
    for i in range(401):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0), accel=(0.8, 0.0, g))
    r_rel, dp, v1 = pre.relative_motion(0.0, 1000.0, np.eye(3))
    np.testing.assert_allclose(r_rel, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(dp, [0.4, 0.0, 0.0], atol=2e-3)
    np.testing.assert_allclose(v1, [0.8, 0.0, 0.0], atol=2e-3)


def test_inertial_preintegration_stationary_rotating():
    from disinfect_slam.systems.imu import ImuPreintegrator

    # camera spinning in place about the world up axis: the measured
    # specific force is gravity rotated into the moving camera frame;
    # preintegration must cancel it (no net translation)
    g = ImuPreintegrator.GRAVITY
    w_z = 0.6  # rad/s about camera z (aligned with world up)
    pre = ImuPreintegrator()
    for i in range(401):
        pre.add_raw(i * 2.5, gyro=(0, 0, w_z), accel=(0.0, 0.0, g))
    r_rel, dp, v1 = pre.relative_motion(0.0, 1000.0, np.eye(3))
    ang = Rotation.from_matrix(r_rel).as_rotvec()
    np.testing.assert_allclose(ang, [0.0, 0.0, -w_z], atol=5e-3)
    np.testing.assert_allclose(dp, np.zeros(3), atol=1e-6)
    np.testing.assert_allclose(v1, np.zeros(3), atol=1e-6)


def test_inertial_preintegration_tilted_camera():
    from disinfect_slam.systems.imu import ImuPreintegrator

    # camera pitched down 30 degrees, static: with the correct attitude
    # supplied, gravity cancels exactly and nothing moves
    att = Rotation.from_euler("x", 30.0, degrees=True).as_matrix()
    g = ImuPreintegrator.GRAVITY
    up_cam = att.T @ np.array([0.0, 0.0, 1.0])
    pre = ImuPreintegrator()
    for i in range(201):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0), accel=g * up_cam)
    _, dp, v1 = pre.relative_motion(0.0, 500.0, att)
    np.testing.assert_allclose(dp, np.zeros(3), atol=1e-9)
    np.testing.assert_allclose(v1, np.zeros(3), atol=1e-9)


def test_seed_pose_with_imu_and_accel_bias():
    from disinfect_slam.systems.imu import (
        ImuPreintegrator,
        seed_pose_with_imu,
    )

    g = ImuPreintegrator.GRAVITY
    bias = np.array([0.05, -0.03, 0.02])
    pre = ImuPreintegrator()
    rng = np.random.default_rng(7)
    # 0.5 s static window (bias estimation), then 0.5 s of constant
    # 0.5 m/s^2 along camera y
    for i in range(401):
        t = i * 2.5
        extra = np.array([0.0, 0.5, 0.0]) if t > 500.0 else np.zeros(3)
        pre.add_raw(t, gyro=(0, 0, 0),
                    accel=np.array([0.0, 0.0, g]) + bias + extra
                    + rng.normal(0, 1e-4, 3))
    pre.estimate_accel_bias(window_ms=500.0)
    # transverse bias components are unobservable statically (they fold
    # into the gravity direction estimate — see estimate_accel_bias);
    # the along-gravity magnitude residual IS recovered
    np.testing.assert_allclose(pre.accel_bias[2], bias[2], atol=2e-3)

    # the consistency property that matters: with the SAME window's
    # gravity-aligned attitude anchoring the world frame, the static
    # half preintegrates to zero and the forced half to a t^2/2
    # gravity_aligned_pose returns world_T_cam0, so its rotation
    # block IS world_R_cam0
    att = pre.gravity_aligned_pose()[:3, :3]
    _, dp0, v0 = pre.relative_motion(0.0, 500.0, att)
    np.testing.assert_allclose(dp0, np.zeros(3), atol=1e-3)
    np.testing.assert_allclose(v0, np.zeros(3), atol=5e-3)

    prev = np.eye(4)
    prev[:3, :3] = att  # world_R_cam0 consistent with the bias split
    prev[:3, 3] = [1.0, 2.0, 3.0]
    seeded, v1 = seed_pose_with_imu(prev, pre, 500.0, 1000.0)
    # delta_p = 0.5 * 0.5 * 0.5^2 = 0.0625 m along y on top of prev
    # (the bias-tilt attitude error leaks force at second order only)
    np.testing.assert_allclose(
        seeded[:3, 3], [1.0, 2.0625, 3.0], atol=2e-3
    )
    np.testing.assert_allclose(v1, [0.0, 0.25, 0.0], atol=3e-3)
    np.testing.assert_allclose(seeded[:3, :3], att, atol=1e-6)


def test_mesh_ply_with_attributes(tmp_path):
    import os

    from disinfect_slam.ops.mesh import (
        compact_mesh,
        extract_mesh,
        merge_vertices,
        save_ply,
        vertex_attributes,
    )

    # build a tiny fused volume inline
    from .scenes import look_at, render_sphere
    from .test_integrate import CFG_DENSE, H, K, W, make_frame
    from .test_raycast import fuse_frames

    center, radius = (0.013, -0.021, 1.007), 0.613
    pose = look_at((0.0, 0.0, -1.5), center)
    depth = render_sphere(W, H, K, pose, center=center, radius=radius)
    ht = np.full((H, W), 0.9, np.float32)
    lt = np.full((H, W), 0.1, np.float32)
    vol, _ = fuse_frames([(make_frame(depth, ht=ht, lt=lt), pose)] * 3, cfg=CFG_DENSE)

    tris = compact_mesh(extract_mesh(vol, max_tris=1 << 16))
    verts, faces = merge_vertices(tris)
    rgb, prob = vertex_attributes(vol, verts)
    assert rgb.shape == (len(verts), 3)
    # fused ht=0.9 -> vertex probabilities high
    assert np.median(prob) > 0.7

    p = os.path.join(tmp_path, "m.ply")
    save_ply(p, verts, faces, rgb, prob)
    data = open(p, "rb").read()
    assert data.startswith(b"ply")
    assert b"ht_probability" in data[:400]
    assert len(data) > len(verts) * 19 + len(faces) * 13


def test_gravity_alignment_recovers_tilt():
    from disinfect_slam.systems.imu import ImuPreintegrator

    # camera tilted: rotate the world up vector into the camera frame
    # by a known attitude (roll 20 deg, pitch -35 deg)
    att = Rotation.from_euler("xy", [20.0, -35.0], degrees=True)
    up_cam = att.apply([0.0, 0.0, 1.0])
    pre = ImuPreintegrator()
    rng = np.random.default_rng(1)
    for i in range(200):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0),
                    accel=9.80665 * up_cam + rng.normal(0, 0.02, 3))
    up = pre.estimate_gravity()
    np.testing.assert_allclose(up, up_cam, atol=2e-3)
    w_T_c = pre.gravity_aligned_pose()
    # the recovered world rotation must map the measured up to world +z
    np.testing.assert_allclose(
        w_T_c[:3, :3] @ up_cam, [0.0, 0.0, 1.0], atol=2e-3
    )
    # orthonormal, right-handed
    np.testing.assert_allclose(
        w_T_c[:3, :3] @ w_T_c[:3, :3].T, np.eye(3), atol=1e-9
    )
    assert np.linalg.det(w_T_c[:3, :3]) > 0.99


def test_gravity_alignment_fail_open():
    from disinfect_slam.systems.imu import ImuPreintegrator

    pre = ImuPreintegrator()
    # no samples -> identity
    np.testing.assert_array_equal(pre.gravity_aligned_pose(), np.eye(4))
    # implausible magnitude (free fall) -> identity
    for i in range(100):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0), accel=(0.0, 0.0, 0.1))
    assert pre.estimate_gravity() is None
    np.testing.assert_array_equal(pre.gravity_aligned_pose(), np.eye(4))
    # antiparallel (camera exactly upside down) -> a 180-degree flip,
    # still orthonormal and mapping up to +z
    pre2 = ImuPreintegrator()
    for i in range(100):
        pre2.add_raw(i * 2.5, gyro=(0, 0, 0), accel=(0.0, 0.0, -9.80665))
    r = pre2.gravity_aligned_pose()[:3, :3]
    np.testing.assert_allclose(r @ [0, 0, -1.0], [0, 0, 1.0], atol=1e-9)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-9)


def test_relative_rotation_noncommuting_order():
    """Body rates compose on the right: a 90-deg x-spin followed by a
    90-deg y-spin must integrate to exp(X) @ exp(Y) (chronological),
    not the reversed chain — and must agree with relative_motion."""
    from disinfect_slam.systems.imu import ImuPreintegrator

    w = np.pi / 2  # rad/s, 1 s each phase
    pre = ImuPreintegrator()
    for i in range(801):
        t = i * 2.5
        gyro = (w, 0, 0) if t <= 1000.0 else (0, w, 0)
        pre.add_raw(t, gyro=gyro, accel=(0, 0, 0))
    r_rel = pre.relative_rotation(0.0, 2000.0)
    expected = (
        Rotation.from_rotvec([np.pi / 2, 0, 0])
        * Rotation.from_rotvec([0, np.pi / 2, 0])
    ).as_matrix().T  # cam1_R_cam0 = delta^T
    # midpoint rule smears one sample across the phase switch: ~1e-3
    np.testing.assert_allclose(r_rel, expected, atol=5e-3)
    # and the full-preintegration rotation agrees
    r_rel2, _, _ = pre.relative_motion(0.0, 2000.0, np.eye(3))
    np.testing.assert_allclose(r_rel2, r_rel, atol=1e-9)
