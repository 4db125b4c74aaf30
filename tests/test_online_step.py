"""FusedOnlineStep: one-dispatch online fusion (systems/online_step.py).

Pins the sensor-format upload contract: u8 rgb + u16 depth counts
(l515.cc:9-13 delivery formats, scaled on device by depth_factor) must
produce the identical volume as pre-converted f32 inputs, and the
cfg.alloc_every alternation must run through the online path.
"""

import dataclasses

import numpy as np

from disinfect_slam.systems.online_step import FusedOnlineStep

from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE_FILTER, H, K, MAX_DEPTH, W

DEPTH_FACTOR = 5000.0


def _frames(n=3):
    rgb = checker_rgb(W, H).astype(np.uint8)
    out = []
    for i in range(n):
        pose = look_at((0.03 * i, -0.02, -1.5), (0.1, 0.0, 1.5))
        d1 = render_sphere(W, H, K, pose, center=(0.1, 0.0, 1.5), radius=0.45)
        d2 = render_wall(W, H, K, pose, wall_z=2.4131)
        depth = np.where(d1 > 0, d1, d2).astype(np.float32)
        depth_u16 = np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
        out.append((rgb, depth_u16, np.asarray(pose, np.float32)))
    return out


def test_sensor_format_matches_f32():
    cfg = dataclasses.replace(CFG_DENSE_FILTER, alloc_every=2)
    a = FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=DEPTH_FACTOR)
    b = FusedOnlineStep(cfg, K, H, W, MAX_DEPTH, depth_factor=DEPTH_FACTOR)
    for rgb_u8, depth_u16, pose in _frames():
        a.step(rgb_u8, depth_u16, pose)
        # pre-converted f32 twin: SAME f32 ops as the device conversion
        b.step(
            rgb_u8.astype(np.float32),
            depth_u16.astype(np.float32) / np.float32(DEPTH_FACTOR),
            pose,
        )
    a.block_until_ready()
    b.block_until_ready()
    assert a.num_active_blocks() == b.num_active_blocks()
    assert a.num_active_blocks() > 10
    # the u16 and f32 programs are separate XLA compilations whose fused
    # fma order differs -> ~2e-6 tsdf deviation (measured); the sensor
    # conversion itself is exact f32 math
    np.testing.assert_allclose(
        np.asarray(a.volume.tsdf), np.asarray(b.volume.tsdf), atol=1e-5
    )
    ra = np.asarray(a.volume.rgbw)
    rb = np.asarray(b.volume.rgbw)
    for shift in (0, 8, 16, 24):  # r, g, b, weight bytes within 1 count
        da = ((ra >> shift) & 0xFF).astype(np.int32)
        db = ((rb >> shift) & 0xFF).astype(np.int32)
        assert np.abs(da - db).max() <= 1
