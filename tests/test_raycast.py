"""Raycast correctness: render a fused synthetic scene and validate hit
geometry, shading and semantic overlay against analytic expectations."""

import jax
import numpy as np

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops.integrate import integrate
from disinfect_slam.ops.raycast import raycast

from .scenes import look_at, render_sphere, render_wall
from .test_integrate import CFG, H, K, MAX_DEPTH, W, make_frame


def fuse_frames(frames_poses, cfg=CFG):
    vol = TSDFVolume.create(cfg)
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH), donate_argnums=0)
    for frame, pose in frames_poses:
        vol = step(vol, frame, SE3.from_matrix(pose))
    return vol, cam


def test_raycast_wall_depth():
    """Rays into a fused wall must hit near the true wall depth."""
    pose_np = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    wall_z = 2.0131
    depth = render_wall(W, H, K, pose_np, wall_z=wall_z)
    # fuse several times so tsdf is well-formed
    vol, cam = fuse_frames([(make_frame(depth), pose_np)] * 3)

    res = raycast(vol, cam, SE3.from_matrix(pose_np), MAX_DEPTH)
    hit = np.asarray(res.hit)
    # central region must hit
    assert hit[10:-10, 10:-10].mean() > 0.95
    d = np.asarray(res.depth)
    true_d = np.asarray(depth)
    # range vs z-depth: res.depth is distance along the ray; convert
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    fx, fy, cx, cy = K
    scale = np.sqrt(((uu - cx) / fx) ** 2 + ((vv - cy) / fy) ** 2 + 1.0)
    rng_true = true_d * scale
    sel = hit & (true_d > 0)
    err = np.abs(d[sel] - rng_true[sel])
    # within ~2 voxels of truth after refinement
    assert np.median(err) < 2.5 * CFG.voxel_size, np.median(err)


def test_raycast_miss_is_transparent():
    vol = TSDFVolume.create(CFG)  # empty volume
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    res = raycast(vol, cam, SE3.identity(), MAX_DEPTH)
    assert not bool(np.asarray(res.hit).any())
    assert np.asarray(res.rgba).sum() == 0  # (0,0,0,0) like voxel_tsdf.cu:305
    assert np.asarray(res.normal).sum() == 0


def test_raycast_semantic_overlay():
    """High ht probability must tint the rgba output red
    (alpha = max(p-0.5, 0)/0.5 overlay, voxel_tsdf.cu:293-296)."""
    pose_np = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_wall(W, H, K, pose_np, wall_z=2.0131)
    ht = np.full((H, W), 0.95, np.float32)
    lt = np.full((H, W), 0.05, np.float32)
    frames = [(make_frame(depth, ht=ht, lt=lt), pose_np)] * 3
    vol, cam = fuse_frames(frames)
    res = raycast(vol, cam, SE3.from_matrix(pose_np), MAX_DEPTH)
    rgba = np.asarray(res.rgba).astype(np.int32)
    hit = np.asarray(res.hit)
    # red channel dominates strongly where hit
    sel = hit[5:-5, 5:-5]
    r = rgba[5:-5, 5:-5, 0][sel]
    g = rgba[5:-5, 5:-5, 1][sel]
    assert (r > 200).mean() > 0.9
    assert (g < 60).mean() > 0.9


def test_raycast_normals_face_camera():
    """Diffuse shading: wall facing the camera head-on renders bright."""
    pose_np = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_wall(W, H, K, pose_np, wall_z=2.0131)
    vol, cam = fuse_frames([(make_frame(depth), pose_np)] * 3)
    res = raycast(vol, cam, SE3.from_matrix(pose_np), MAX_DEPTH)
    normal = np.asarray(res.normal).astype(np.int32)
    hit = np.asarray(res.hit)
    sel = hit[10:-10, 10:-10]
    lum = normal[10:-10, 10:-10, 0][sel]
    assert np.median(lum) > 150  # mostly facing the camera


def test_empty_space_skip_bit_identical():
    """Skipping marches a different step schedule but must produce the
    exact same images: skipped samples provably read the default +1."""
    import dataclasses

    pose_np = look_at((0.21, -0.33, -0.27), (0.05, 0.08, 1.4))
    depth = render_sphere(W, H, K, pose_np, center=(0.05, 0.08, 1.4), radius=0.37)
    depth = np.where(depth > 0, depth, render_wall(W, H, K, pose_np, wall_z=2.6))
    vol, cam = fuse_frames([(make_frame(depth.astype(np.float32)), pose_np)] * 2)

    pose = SE3.from_matrix(pose_np)
    fast = raycast(vol, cam, pose, MAX_DEPTH)

    vol_slow = dataclasses.replace(
        vol, cfg=dataclasses.replace(CFG, raycast_skip=False)
    )
    slow = raycast(vol_slow, cam, pose, MAX_DEPTH)

    np.testing.assert_array_equal(np.asarray(fast.hit), np.asarray(slow.hit))
    np.testing.assert_array_equal(np.asarray(fast.rgba), np.asarray(slow.rgba))
    np.testing.assert_array_equal(np.asarray(fast.normal), np.asarray(slow.normal))
    np.testing.assert_array_equal(np.asarray(fast.depth), np.asarray(slow.depth))
    assert bool(np.asarray(fast.hit).any())
