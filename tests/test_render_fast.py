"""Splat renderer tests: agreement with the parity raycaster on hit
coverage, depth, and semantic overlay."""

import numpy as np
import pytest

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops.raycast import raycast
from disinfect_slam.ops.render_fast import splat_render

from .scenes import look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W, make_frame
from .test_raycast import fuse_frames


def make_scene(ht_val=0.5, lt_val=0.5):
    pose_np = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_wall(W, H, K, pose_np, wall_z=2.0131)
    ht = np.full((H, W), ht_val, np.float32)
    lt = np.full((H, W), lt_val, np.float32)
    frames = [(make_frame(depth, ht=ht, lt=lt), pose_np)] * 3
    vol, cam = fuse_frames(frames, cfg=CFG_DENSE)
    return vol, cam, pose_np, depth


def test_splat_agrees_with_raycast_depth():
    vol, cam, pose_np, depth = make_scene()
    se3 = SE3.from_matrix(pose_np)
    rs = splat_render(vol, cam, se3, MAX_DEPTH)
    rr = raycast(vol, cam, se3, MAX_DEPTH)
    hit_s = np.asarray(rs.hit)
    hit_r = np.asarray(rr.hit)
    # splat coverage at least matches the raycaster in the interior
    inter = hit_s[8:-8, 8:-8] & hit_r[8:-8, 8:-8]
    assert inter.mean() > 0.9
    ds = np.asarray(rs.depth)[8:-8, 8:-8][inter]  # z depth
    # raycaster depth is range along ray; convert splat z to range
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    fx, fy, cx, cy = K
    scale = np.sqrt(((uu - cx) / fx) ** 2 + ((vv - cy) / fy) ** 2 + 1.0)[8:-8, 8:-8][
        inter
    ]
    dr = np.asarray(rr.depth)[8:-8, 8:-8][inter]
    err = np.abs(ds * scale - dr)
    assert np.median(err) < 2.0 * CFG_DENSE.voxel_size, np.median(err)


def test_splat_semantic_overlay_red():
    vol, cam, pose_np, _ = make_scene(ht_val=0.95, lt_val=0.05)
    rs = splat_render(vol, cam, SE3.from_matrix(pose_np), MAX_DEPTH)
    rgba = np.asarray(rs.rgba).astype(np.int32)
    hit = np.asarray(rs.hit)
    sel = hit[8:-8, 8:-8]
    r = rgba[8:-8, 8:-8, 0][sel]
    g = rgba[8:-8, 8:-8, 1][sel]
    assert (r > 200).mean() > 0.9
    assert (g < 60).mean() > 0.9


def test_splat_normals_bright_facing():
    vol, cam, pose_np, _ = make_scene()
    rs = splat_render(vol, cam, SE3.from_matrix(pose_np), MAX_DEPTH)
    normal = np.asarray(rs.normal).astype(np.int32)
    hit = np.asarray(rs.hit)
    sel = hit[8:-8, 8:-8]
    lum = normal[8:-8, 8:-8, 0][sel]
    assert np.median(lum) > 150


def _sphere_scene(eye):
    pose_np = look_at(eye, (0.05, 0.08, 1.4))
    depth = render_sphere(W, H, K, pose_np, center=(0.05, 0.08, 1.4), radius=0.37)
    depth = np.where(depth > 0, depth, render_wall(W, H, K, pose_np, wall_z=2.6))
    vol, cam = fuse_frames([(make_frame(depth.astype(np.float32)), pose_np)] * 2,
                           cfg=CFG_DENSE)
    return vol, cam, pose_np


@pytest.mark.parametrize("eye", [(0.21, -0.33, -0.27), (0.05, 0.1, 0.55)],
                         ids=["normal", "close"])
def test_surf_cap_filter_is_lossless_when_cap_holds(eye):
    """The surface-band prefilter must not change the rendered images
    while the cap covers every surface block (min/max merges are
    order-independent).  `close` puts the camera ~0.5 m from the sphere
    so block footprints are large."""
    vol, cam, pose_np = _sphere_scene(eye)
    pose = SE3.from_matrix(pose_np)
    a = splat_render(vol, cam, pose, MAX_DEPTH, surf_cap=None)
    b = splat_render(vol, cam, pose, MAX_DEPTH)  # default cap
    assert np.asarray(b.hit).mean() > 0.05
    for f in ("rgba", "depth", "hit", "normal"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def test_splat_empty_volume():
    vol = TSDFVolume.create(CFG_DENSE)
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    res = splat_render(vol, cam, SE3.identity(), MAX_DEPTH)
    assert not bool(np.asarray(res.hit).any())
    assert float(np.asarray(res.depth).sum()) == 0.0
