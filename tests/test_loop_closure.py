"""Loop closure / relocalization / map persistence tests.

The reference inherits loop closing from ORB_SLAM3/OpenVSLAM
(disinfect_slam.cc:89, modules/slam_module.cc:100-120); these tests
cover the built-in tracker's JAX replacement
(systems/loop_closure.py): SE3 log/exp, the depth descriptor + matmul
matcher, pose-graph relaxation, the full drift-correction pipeline on a
synthetic out-and-back trajectory, relocalization, and the
save_map_database analogue.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from disinfect_slam.systems.loop_closure import (
    LoopClosureManager,
    _exp_se3_mat,
    _inv_rigid,
    _se3_log,
    depth_descriptor,
    _match_scores,
    optimize_pose_graph,
)

from .scenes import checker_rgb, look_at, render_sphere, render_wall

W, H = 160, 120
K = (131.7, 132.3, 79.7, 59.4)
CENTER = np.array([0.1, 0.0, 1.5])


def scene_depth(pose):
    d1 = render_sphere(W, H, K, pose, center=CENTER, radius=0.45)
    d2 = render_wall(W, H, K, pose, wall_z=2.4131)
    d3 = render_sphere(W, H, K, pose, center=(-0.5, 0.3, 1.9), radius=0.3)
    d = np.where(d1 > 0, d1, d2)
    return np.where(d3 > 0, d3, d).astype(np.float32)


# ----------------------------------------------------------------------
def test_se3_log_exp_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        xi = rng.normal(0, 0.3, 6).astype(np.float32)
        m = _exp_se3_mat(jnp.asarray(xi))
        back = np.asarray(_se3_log(m))
        np.testing.assert_allclose(back, xi, atol=1e-4)
    # near-zero branch
    xi = np.full(6, 1e-6, np.float32)
    back = np.asarray(_se3_log(_exp_se3_mat(jnp.asarray(xi))))
    np.testing.assert_allclose(back, xi, atol=1e-6)


def test_inv_rigid_matches_linalg_inv():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.5, 6).astype(np.float32)
    m = np.asarray(_exp_se3_mat(jnp.asarray(xi)))
    np.testing.assert_allclose(
        np.asarray(_inv_rigid(jnp.asarray(m))), np.linalg.inv(m), atol=1e-5
    )


# ----------------------------------------------------------------------
def test_depth_descriptor_discriminates():
    p0 = look_at((0.0, 0.0, -1.5), CENTER)
    p1 = look_at((0.6, 0.1, -1.3), CENTER)
    d0 = jnp.asarray(scene_depth(p0)[::2, ::2])
    d1 = jnp.asarray(scene_depth(p1)[::2, ::2])
    a, b = depth_descriptor(d0), depth_descriptor(d1)
    assert float(a @ a) == pytest.approx(1.0, abs=1e-4)  # unit norm
    assert float(a @ b) < 0.999  # different viewpoint scores lower
    # identical depth -> perfect score
    assert float(a @ depth_descriptor(d0)) == pytest.approx(1.0, abs=1e-5)


def test_match_scores_masks_recency_and_count():
    d = jnp.asarray(scene_depth(look_at((0, 0, -1.5), CENTER))[::2, ::2])
    desc = depth_descriptor(d)
    cap = 8
    db = jnp.zeros((cap, desc.shape[0]), jnp.float32).at[0].set(desc)
    db = db.at[1].set(desc)
    ids = jnp.full((cap,), -(10**9), jnp.int32).at[0].set(0).at[1].set(90)
    # recency gap excludes the recent slot 1 (gap 10 < 60)
    best, score = _match_scores(
        desc, db, ids, jnp.int32(2), jnp.int32(100), jnp.int32(60)
    )
    assert int(best) == 0 and float(score) > 0.999
    # count mask: only slot 0 live even though slot 1 holds a copy
    best, score = _match_scores(
        desc, db, ids, jnp.int32(1), jnp.int32(100), jnp.int32(60)
    )
    assert int(best) == 0
    # empty database -> masked scores everywhere
    best, score = _match_scores(
        desc, db, ids, jnp.int32(0), jnp.int32(100), jnp.int32(60)
    )
    assert float(score) < -1.0


# ----------------------------------------------------------------------
def test_pose_graph_closes_drifted_chain():
    """Chain 0..N with drifted odometry + one exact loop edge 0->N: the
    relaxed graph pulls node N back toward node 0 (gauge-anchored)."""
    n = 8
    true = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [0.1 * k, 0.0, 0.0]
        true.append(t)
    # estimates drift +4 mm/step in z
    est = []
    for k, t in enumerate(true):
        e = t.copy()
        e[2, 3] += 0.004 * k
        est.append(e)
    ei, ej, z, w = [], [], [], []
    for k in range(n - 1):  # odometry edges from the DRIFTED estimates
        ei.append(k)
        ej.append(k + 1)
        z.append(np.linalg.inv(est[k]) @ est[k + 1])
        w.append(1.0)
    # loop edge with the TRUE relative pose (ICP-verified in real use)
    ei.append(0)
    ej.append(n - 1)
    z.append(np.linalg.inv(true[0]) @ true[n - 1])
    w.append(4.0)
    opt, costs = optimize_pose_graph(
        jnp.asarray(np.stack(est)),
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
        jnp.asarray(np.stack(z).astype(np.float32)),
        jnp.asarray(w, jnp.float32),
    )
    opt = np.asarray(opt)
    assert float(costs[-1]) < float(costs[0])
    # gauge: node 0 unmoved
    np.testing.assert_allclose(opt[0], est[0], atol=1e-3)
    # endpoint error vs truth shrinks substantially
    err_before = np.linalg.norm(est[-1][:3, 3] - true[-1][:3, 3])
    err_after = np.linalg.norm(opt[-1][:3, 3] - true[-1][:3, 3])
    assert err_after < 0.35 * err_before, (err_before, err_after)


# ----------------------------------------------------------------------
def _out_and_back_keyframes():
    """12 keyframes out along +x and back to the start pose, with a
    growing injected world-frame drift on the estimates."""
    xs = [0.0, 0.06, 0.12, 0.18, 0.24, 0.30, 0.30, 0.24, 0.18, 0.12, 0.06, 0.0]
    true_poses, est_poses, depths = [], [], []
    for k, x in enumerate(xs):
        pose_cw = look_at((x, 0.0, -1.5), CENTER + np.array([x * 0.3, 0, 0]))
        wc = np.linalg.inv(pose_cw).astype(np.float32)  # world_T_cam
        drift = np.eye(4, dtype=np.float32)
        drift[:3, 3] = [0.006 * k, 0.0, 0.003 * k]
        true_poses.append(wc)
        est_poses.append((drift @ wc).astype(np.float32))
        depths.append(scene_depth(pose_cw))
    return true_poses, est_poses, depths


def _make_manager(**kw):
    args = dict(
        kf_every=1, min_gap_frames=50, sim_thresh=0.97,
        verify_max_rmse=0.05, verify_min_inliers=800, max_keyframes=64,
    )
    args.update(kw)
    return LoopClosureManager(K, H, W, **args)


def test_loop_closure_reduces_trajectory_error():
    true_poses, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager()
    corrections = []
    for k, (d, e) in enumerate(zip(depths, est_poses)):
        c = lc.add_keyframe(d, e, frame_id=10 * k)
        if c is not None:
            corrections.append((k, c))
    assert lc.closures >= 1, "revisit of the start pose must close a loop"
    # the scene stays in view along the whole path, so a closure may
    # legitimately fire before the geometric return — what matters is
    # that the ICP-verified constraints remove the injected drift below
    assert corrections and corrections[0][0] >= 5

    # keyframe-pose error vs truth: optimized beats drifted estimates
    err_est = np.mean([
        np.linalg.norm(e[:3, 3] - t[:3, 3])
        for e, t in zip(est_poses, true_poses)
    ])
    err_opt = np.mean([
        np.linalg.norm(o[:3, 3] - t[:3, 3])
        for o, t in zip(lc.kf_pose_opt, true_poses)
    ])
    assert err_opt < 0.6 * err_est, (err_est, err_opt)

    # retro-correction of a per-frame trajectory moves non-keyframes too
    fids = np.arange(0, 120, 5)
    cam_T_world = np.stack([
        np.linalg.inv(est_poses[min(f // 10, 11)]) for f in fids
    ]).astype(np.float32)
    corr = lc.correct_trajectory(fids, cam_T_world)
    assert corr.shape == cam_T_world.shape
    # the final frames (most drifted) get pulled back toward truth
    end_before = np.linalg.norm(
        np.linalg.inv(cam_T_world[-1])[:3, 3] - true_poses[-1][:3, 3]
    )
    end_after = np.linalg.norm(
        np.linalg.inv(corr[-1])[:3, 3] - true_poses[-1][:3, 3]
    )
    assert end_after < 0.6 * end_before, (end_before, end_after)


def test_relocalize_recovers_pose():
    _, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager()
    for k in range(6):  # only the outbound leg
        lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    # "lost" at a pose matching keyframe 3's view; the recovered pose
    # lives in the OPTIMIZED map frame (in-database closures may already
    # have corrected keyframe poses), so compare against kf_pose_opt
    t = lc.relocalize(depths[3])
    assert t is not None
    np.testing.assert_allclose(
        t[:3, 3], lc.kf_pose_opt[3][:3, 3], atol=0.005
    )
    # a view nothing in the database resembles is rejected
    far = look_at((0.0, -2.0, 0.2), (0.0, -2.0, 3.0))
    assert lc.relocalize(render_wall(W, H, K, far, wall_z=40.0)) is None


def test_map_save_load_roundtrip(tmp_path):
    _, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager()
    for k in range(6):
        lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    path = str(tmp_path / "map.npz")
    lc.save(path)

    lc2 = _make_manager()
    lc2.load(path)
    assert lc2.count == lc.count
    assert lc2.kf_frame_ids == lc.kf_frame_ids
    assert len(lc2.edges) == len(lc.edges)
    np.testing.assert_allclose(
        np.asarray(lc2.db_desc), np.asarray(lc.db_desc), atol=1e-6
    )
    # the reloaded map localizes a new session (the save_map_database
    # use case, run_zed_native.cc:88) — in the saved map's optimized frame
    t = lc2.relocalize(depths[3])
    assert t is not None
    np.testing.assert_allclose(
        t[:3, 3], np.asarray(lc.kf_pose_opt[3])[:3, 3], atol=0.005
    )


def test_cross_session_closure_after_load(tmp_path):
    """A NEW session (frame ids restarting at 0) can close loops against
    a loaded map: load() offsets incoming ids past the saved timeline."""
    _, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager(sim_thresh=0.99)
    for k in range(4):
        lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    path = str(tmp_path / "map.npz")
    lc.save(path)

    lc2 = _make_manager(sim_thresh=0.99)
    lc2.load(path)
    # session 2 starts at the pose of saved keyframe 1, frame id 0
    c = lc2.add_keyframe(depths[1], est_poses[1], frame_id=0)
    assert lc2.closures == 1, "loaded keyframes must be loop-eligible"
    assert c is not None


# ----------------------------------------------------------------------
def test_dense_slam_loop_closure_wiring():
    """DenseSLAM(loop_closure=True) builds keyframes at cadence and the
    trajectory-correction passthrough works."""
    import dataclasses

    from disinfect_slam.systems.dense_slam import DenseSLAM

    from .test_integrate import CFG_DENSE

    cfg = dataclasses.replace(
        CFG_DENSE, num_blocks_log2=12, max_candidates=8192,
        max_visible=4096, max_new_per_round=2048,
    )
    slam = DenseSLAM(
        K, H, W, voxel_size=0.02, truncation=0.06, cfg=cfg,
        loop_closure=True, kf_every=3,
        lc_kwargs=dict(min_gap_frames=1000, verify_min_inliers=800),
    )
    rgb = checker_rgb(W, H)
    angs = np.linspace(0, 0.1, 7)
    ids, poses = [], []
    for i, ang in enumerate(angs):
        eye = (np.sin(ang) * 1.8, 0.01 * ang, -1.8 * np.cos(ang) + 0.3)
        p, ok = slam.process_frame(rgb, scene_depth(look_at(eye, CENTER)))
        ids.append(i)
        poses.append(np.asarray(p))
    assert slam.lc.count == 3  # frames 0, 3, 6
    out = slam.correct_trajectory(np.asarray(ids), np.stack(poses))
    assert out.shape == (7, 4, 4)
    # no closure on this short arc -> correction is identity-ish
    np.testing.assert_allclose(out, np.stack(poses), atol=1e-5)


# ----------------------------------------------------------------------
def _texture(phase: float) -> np.ndarray:
    """Synthetic intensity image with cell-scale structure."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return (
        128.0
        + 100.0 * np.sin(xx / 11.0 + phase) * np.cos(yy / 7.0 + 2 * phase)
    ).astype(np.float32)


def test_perceptual_aliasing_rejected():
    """Two places with IDENTICAL geometry but different appearance (the
    repetitive-corridor case) must not close a loop; the same place seen
    again (same geometry AND texture) must.  This is what the intensity
    cells of the descriptor buy vs the r4 depth-only form — the
    reference's BoW matcher is appearance-based for the same reason."""
    pose = look_at((0.0, 0.0, -1.5), CENTER)
    depth = scene_depth(pose)
    tex_a, tex_b = _texture(0.0), _texture(1.7)

    # descriptor level: identical geometry, different texture -> well
    # under any sane threshold; same texture -> perfect score
    dh = jnp.asarray(depth[::2, ::2])
    da = depth_descriptor(dh, jnp.asarray(tex_a[::2, ::2]))
    db_ = depth_descriptor(dh, jnp.asarray(tex_b[::2, ::2]))
    assert float(da @ da) == pytest.approx(1.0, abs=1e-4)
    assert float(da @ db_) < 0.9, float(da @ db_)

    # manager level: room B (same geometry, different texture) must not
    # close against room A; revisiting room A itself must
    lc = _make_manager()
    wc = np.linalg.inv(pose).astype(np.float32)
    lc.add_keyframe(depth, wc, frame_id=0, intensity=tex_a)
    lc.add_keyframe(depth, wc, frame_id=100, intensity=tex_b)
    assert lc.closures == 0, "aliased place must not close"
    c = lc.add_keyframe(depth, wc, frame_id=200, intensity=tex_a)
    assert lc.closures == 1 and c is not None


def test_kf_every_enforced_inside_manager():
    """The manager itself gates the keyframe cadence (r4 verdict: the
    caller had to)."""
    _, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager(kf_every=10)
    for fid in range(12):  # submit EVERY frame
        lc.add_keyframe(depths[fid % len(depths)], est_poses[0], frame_id=fid)
    assert lc.count == 2, lc.count  # frames 0 and 10 only
    assert lc.kf_frame_ids == [0, 10]


def test_keyframe_cap_evicts_and_keeps_closing(caplog):
    """At max_keyframes the most redundant keyframe is merged away (r4:
    add_keyframe silently returned None forever): the database keeps its
    cap, the odometry chain stays connected, node 0 survives as the
    gauge anchor, a warning fires once, and a loop can STILL close after
    long operation past the cap."""
    import logging

    true_poses, est_poses, depths = _out_and_back_keyframes()
    lc = _make_manager(max_keyframes=8)
    with caplog.at_level(logging.WARNING):
        for k in range(len(depths)):
            lc.add_keyframe(depths[k], est_poses[k], frame_id=10 * k)
    assert lc.count == 8
    assert lc.evictions == len(depths) - 8
    assert any("cap" in r.message for r in caplog.records)
    # gauge anchor survives; the newest keyframe is the latest frame
    assert lc.kf_frame_ids[0] == 0
    assert lc.kf_frame_ids[-1] == 10 * (len(depths) - 1)
    # odometry chain connected: consecutive edges cover 0..count-1
    odo = sorted((i, j) for i, j, _z, _w in lc.edges if abs(i - j) == 1)
    assert [i for i, _ in odo] == list(range(lc.count - 1))
    # the out-and-back revisit still closed against the anchor region
    assert lc.closures >= 1
    # db arrays consistent with host lists after the shifts
    ids_dev = np.asarray(lc.db_ids)[: lc.count]
    np.testing.assert_array_equal(ids_dev, np.asarray(lc.kf_frame_ids))
