"""Raycast parity vs the numpy oracle transcription of ray_cast_kernel."""

import numpy as np

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.ops.raycast import raycast

from .oracle import oracle_raycast
from .scenes import look_at, render_sphere
from .test_integrate import CFG_DENSE, MAX_DEPTH, make_frame, run_oracle, run_ours

W, H = 64, 48
K = (52.7, 53.3, 31.71, 23.43)


def test_raycast_matches_oracle():
    center, radius = (0.013, -0.021, 1.007), 0.613
    frames = []
    for ang in (0.0, 0.2):
        eye = np.array([np.sin(ang) * 2.3 + 0.013, -0.021, -2.3 * np.cos(ang) + 1.007])
        pose = look_at(eye, center)
        depth = render_sphere(W, H, K, pose, center=center, radius=radius)
        ht = np.full((H, W), 0.8, np.float32)
        lt = np.full((H, W), 0.3, np.float32)
        frames.append((make_frame(depth, ht=ht, lt=lt), pose))

    vol = run_ours(frames, CFG_DENSE)
    ovol = run_oracle(frames, CFG_DENSE)

    view = frames[0][1]
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    res = raycast(vol, cam, SE3.from_matrix(view), MAX_DEPTH)
    o_rgba, o_normal, o_hit = oracle_raycast(ovol, K, H, W, view, MAX_DEPTH)

    hit = np.asarray(res.hit)
    agree = (hit == o_hit).mean()
    assert agree > 0.98, agree

    both = hit & o_hit
    # rgba: identical up to f32/f64 refinement landing on a neighboring
    # voxel at crossing boundaries
    d_rgba = np.abs(
        np.asarray(res.rgba).astype(int)[both] - o_rgba.astype(int)[both]
    )
    assert (d_rgba.max(-1) <= 2).mean() > 0.95
    d_norm = np.abs(
        np.asarray(res.normal).astype(int)[both] - o_normal.astype(int)[both]
    )
    assert np.median(d_norm.max(-1)) <= 8
