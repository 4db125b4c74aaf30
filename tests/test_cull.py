"""Occlusion culling: fusion output must be unchanged (the cull is
provably conservative), only the working set shrinks."""

import dataclasses

import jax
import numpy as np

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops.integrate import gather_visible, integrate

from .scenes import look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W, make_frame


def occluded_scene(pose):
    """Near sphere occluding a far wall."""
    d1 = render_sphere(W, H, K, pose, center=(0.013, -0.021, 0.8), radius=0.55)
    d2 = render_wall(W, H, K, pose, wall_z=2.4131)
    return np.where(d1 > 0, d1, d2).astype(np.float32)


def run(cfg, frames_poses):
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH))
    vol = TSDFVolume.create(cfg)
    for frame, pose in frames_poses:
        vol = step(vol, frame, SE3.from_matrix(pose))
    return vol


def test_cull_preserves_fusion():
    cfg_off = dataclasses.replace(CFG_DENSE, cull_occluded=False)
    cfg_on = dataclasses.replace(CFG_DENSE, cull_occluded=True)

    # two viewpoints so wall blocks behind the sphere get allocated from
    # one view and occluded in the other
    frames = []
    for eye in [(-0.6, 0.0, -1.3), (0.6, 0.05, -1.3)]:
        pose = look_at(eye, (0.013, -0.021, 1.2))
        frames.append((make_frame(occluded_scene(pose)), pose))
    frames = frames * 2

    vol_off = run(cfg_off, frames)
    vol_on = run(cfg_on, frames)

    # compare payloads of blocks live in both volumes, keyed by coord
    def block_map(vol):
        live = np.asarray(vol.entry_block) >= 0
        pos = np.asarray(vol.entry_pos)[live]
        pool = np.asarray(vol.entry_block)[live]
        t = np.asarray(vol.tsdf)[pool]
        w = np.asarray(vol.weight)[pool]
        return {tuple(p): (tv, wv) for p, tv, wv in zip(pos, t, w)}

    m_off = block_map(vol_off)
    m_on = block_map(vol_on)
    common = set(m_off) & set(m_on)
    assert len(common) > 20
    for key in common:
        np.testing.assert_array_equal(m_off[key][0], m_on[key][0])
        np.testing.assert_array_equal(m_off[key][1], m_on[key][1])
    # divergence limited to carve timing: blocks only in one map carry no
    # fused weight
    for key in set(m_off) ^ set(m_on):
        src = m_off.get(key) or m_on.get(key)
        assert src[1].max() == 0, key


def test_cull_actually_culls():
    cfg_on = dataclasses.replace(CFG_DENSE, cull_occluded=True)
    pose = look_at((0.013, -0.021, -1.3), (0.013, -0.021, 1.2))
    frame = make_frame(occluded_scene(pose))
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    se3 = SE3.from_matrix(pose)

    # build a volume where far wall blocks exist (wall-only first frame)
    wall_only = make_frame(render_wall(W, H, K, pose, wall_z=2.4131))
    vol = TSDFVolume.create(cfg_on)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH))
    vol = step(vol, wall_only, se3)

    from disinfect_slam.ops.integrate import depth_to_range

    d2r = depth_to_range(cam)
    vis_all = gather_visible(vol, cam, se3)
    vis_cull = gather_visible(vol, cam, se3, frame.depth, d2r)
    assert int(vis_cull.count) < int(vis_all.count), (
        int(vis_cull.count),
        int(vis_all.count),
    )
