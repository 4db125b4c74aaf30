"""DenseSLAM (frame-to-model tracking + fusion) end-to-end test."""

import numpy as np

from disinfect_slam.systems.dense_slam import DenseSLAM

from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE

W, H = 160, 120
K = (131.7, 132.3, 79.7, 59.4)
CENTER = np.array([0.1, 0.0, 1.5])


def scene_depth(pose):
    d1 = render_sphere(W, H, K, pose, center=CENTER, radius=0.45)
    d2 = render_wall(W, H, K, pose, wall_z=2.4131)
    d3 = render_sphere(W, H, K, pose, center=(-0.5, 0.3, 1.9), radius=0.3)
    d = np.where(d1 > 0, d1, d2)
    return np.where(d3 > 0, d3, d).astype(np.float32)


SLAM_CFG = __import__("dataclasses").replace(
    CFG_DENSE,
    num_blocks_log2=12,
    max_candidates=8192,
    max_visible=4096,
    max_new_per_round=2048,
)


def test_dense_slam_tracks_orbit():
    slam = DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG)
    rgb = checker_rgb(W, H)

    # camera path: small lateral steps (frame-to-model tracking)
    angs = np.linspace(0, 0.12, 6)
    true_poses = []
    est_poses = []
    n_ok = 0
    for ang in angs:
        eye = (np.sin(ang) * 1.8, 0.01 * ang, -1.8 * np.cos(ang) + 0.3)
        pose = look_at(eye, CENTER)
        true_poses.append(pose)
        est, ok = slam.process_frame(rgb, scene_depth(pose))
        est_poses.append(est)
        n_ok += ok
    assert n_ok == len(angs)

    # estimated relative motion must match ground truth (the SLAM world
    # frame equals the first camera frame)
    rel_true = true_poses[-1] @ np.linalg.inv(true_poses[0])
    rel_est = est_poses[-1] @ np.linalg.inv(est_poses[0])
    t_err = np.linalg.norm(rel_true[:3, 3] - rel_est[:3, 3])
    # total motion is ~22 cm; tsdf-offset splats keep drift ~1 voxel
    assert t_err < 0.02, (t_err, rel_true[:3, 3], rel_est[:3, 3])

    # the fused model should be dense enough to render
    res = slam.render()
    assert float(np.asarray(res.hit).mean()) > 0.4

    # absolute trajectory error through the evaluation tool: drift over
    # the ~22 cm sweep stays within a voxel after rigid alignment
    from disinfect_slam.utils.trajectory_eval import ate

    gt_wc = np.stack([np.linalg.inv(p) for p in true_poses])
    est_wc = np.stack([np.linalg.inv(np.asarray(p)) for p in est_poses])
    a = ate(gt_wc, est_wc, align=True)
    assert a["rmse"] < 0.02, a


def test_dense_slam_trans_prior_recovers_fast_translation():
    """A lateral jump too large for projective ICP alone converges when
    the IMU translation prior (systems/imu.py relative_motion) seeds the
    step — the full-SE3-seed path of _track_fuse."""
    rgb = checker_rgb(W, H)
    step = 0.3  # m per frame — beyond the ICP basin at this scene
    pose0 = look_at((0.0, 0.0, -1.5), (0.0, 0.0, CENTER[2]))
    # the SLAM world frame is the FIRST CAMERA frame; a scene-world
    # vector maps into it through cam0_T_world's rotation (this is also
    # the live contract: the IMU preintegrates in the gravity-aligned
    # frame the tracker is anchored to)
    to_slam_world = pose0[:3, :3]
    true_step_sw = to_slam_world @ np.array([step, 0.0, 0.0])

    def run(with_prior: bool):
        slam = DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06,
                         cfg=SLAM_CFG)
        est, n_ok = [], 0
        xs = [0.0, 0.0, step, 2 * step]
        for i, x in enumerate(xs):
            pose = look_at((x, 0.0, -1.5), (x, 0.0, CENTER[2]))
            prior = true_step_sw.astype(np.float32) if (
                with_prior and i >= 2) else None
            p, ok = slam.process_frame(rgb, scene_depth(pose),
                                       trans_prior=prior)
            est.append(np.asarray(p))
            n_ok += int(np.asarray(ok))
        return est, n_ok

    def cam_pos_w(cam_T_world):
        return np.linalg.inv(cam_T_world)[:3, 3]

    est_p, ok_p = run(True)
    # with the prior every frame tracks and the recovered camera travel
    # matches the true 2*step (expressed in the SLAM world frame)
    assert ok_p == 4
    moved = cam_pos_w(est_p[3]) - cam_pos_w(est_p[1])
    drift = np.linalg.norm(moved - 2 * true_step_sw)
    assert drift < 0.03, (drift, moved, 2 * true_step_sw)

    est_n, _ = run(False)
    moved_n = cam_pos_w(est_n[3]) - cam_pos_w(est_n[1])
    drift_n = np.linalg.norm(moved_n - 2 * true_step_sw)
    # without the prior the same jump must do clearly worse (either the
    # gate rejects or ICP lands short) — this pins that the prior is
    # actually reaching the seed
    assert drift_n > 2 * drift, (drift_n, drift)


def test_dense_slam_single_dispatch_per_frame():
    """Dispatch audit (VERDICT r2 #8): the steady-state process_frame
    must be exactly ONE jitted call (_track_fuse) with no separate
    fuse dispatch and no forced host sync (returns device arrays)."""
    import jax.numpy as jnp

    slam = DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG)
    rgb = checker_rgb(W, H)
    calls = {"track_fuse": 0, "step": 0}
    orig_tf, orig_step = slam._track_fuse, slam._step

    def count_tf(*a, **k):
        calls["track_fuse"] += 1
        return orig_tf(*a, **k)

    def count_step(*a, **k):
        calls["step"] += 1
        return orig_step(*a, **k)

    slam._track_fuse = count_tf
    slam._step = count_step

    for ang in (0.0, 0.04, 0.08):
        pose, ok = slam.process_frame(rgb, scene_depth(look_at(
            (np.sin(ang) * 1.8, 0.0, -1.8 * np.cos(ang) + 0.3), CENTER)))
    # frame 0: bootstrap fuse; frames 1..2: one fused dispatch each
    assert calls["step"] == 1
    assert calls["track_fuse"] == 2
    # device-resident results: no implicit per-frame host conversion
    assert isinstance(pose, jnp.ndarray)
    assert isinstance(ok, jnp.ndarray)
    assert slam.lost_count == 0


def test_initial_pose_anchor():
    """set_initial_pose anchors the world frame (the gravity-alignment
    hook, systems/imu.py ImuPreintegrator.gravity_aligned_pose): frame 0
    must be fused at inv(world_T_cam0) and tracking continues from it."""
    from scipy.spatial.transform import Rotation

    from disinfect_slam.systems.imu import ImuPreintegrator

    # simulate a camera pitched 25 deg down at start: gravity alignment
    # recovers a level world frame from the accel window
    att = Rotation.from_euler("x", 25.0, degrees=True)
    up_cam = att.apply([0.0, 0.0, 1.0])
    pre = ImuPreintegrator()
    for i in range(100):
        pre.add_raw(i * 2.5, gyro=(0, 0, 0), accel=9.80665 * up_cam)
    w0 = pre.gravity_aligned_pose()

    slam = DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG)
    slam.set_initial_pose(w0)
    rgb = checker_rgb(W, H)
    pose = look_at((0.0, 0.0, -1.6), CENTER)
    est0, ok = slam.process_frame(rgb, scene_depth(pose))
    np.testing.assert_allclose(
        np.asarray(est0), np.linalg.inv(w0).astype(np.float32), atol=1e-6
    )
    # second frame (identical view) tracks in the anchored frame: pose
    # stays within ICP noise of the anchor (~1 voxel at this scale)
    est1, ok1 = slam.process_frame(rgb, scene_depth(pose))
    assert bool(ok1)
    np.testing.assert_allclose(np.asarray(est1), np.asarray(est0), atol=2.5e-2)
    # after frame 0 the anchor is frozen
    import pytest

    with pytest.raises(AssertionError):
        slam.set_initial_pose(np.eye(4))


def test_dense_slam_half_res_tracking():
    """track_res_scale=2 (model render + ICP at half res, fusion at full
    res): the tracking-cost knob for sensor-rate operation.  Accuracy on
    the orbit stays within ~1.5 voxels where full res holds ~1."""
    slam = DenseSLAM(
        K, H, W, voxel_size=0.02, truncation=0.06, cfg=SLAM_CFG,
        track_res_scale=2,
    )
    rgb = checker_rgb(W, H)
    angs = np.linspace(0, 0.12, 6)
    true_poses, est_poses = [], []
    n_ok = 0
    for ang in angs:
        eye = (np.sin(ang) * 1.8, 0.01 * ang, -1.8 * np.cos(ang) + 0.3)
        pose = look_at(eye, CENTER)
        true_poses.append(pose)
        est, ok = slam.process_frame(rgb, scene_depth(pose))
        est_poses.append(est)
        n_ok += ok
    assert n_ok == len(angs)
    rel_true = true_poses[-1] @ np.linalg.inv(true_poses[0])
    rel_est = np.asarray(est_poses[-1]) @ np.linalg.inv(np.asarray(est_poses[0]))
    t_err = np.linalg.norm(rel_true[:3, 3] - rel_est[:3, 3])
    assert t_err < 0.03, (t_err, rel_true[:3, 3], rel_est[:3, 3])
