"""Volume checkpoint roundtrip + resume-equivalence test."""

import os

import jax
import numpy as np

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.io.checkpoint import load_volume, save_volume
from disinfect_slam.ops.integrate import integrate

from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE, H, K, MAX_DEPTH, W, make_frame


def test_checkpoint_roundtrip_and_resume(tmp_path):
    pose = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    d1 = render_wall(W, H, K, pose, wall_z=2.0131)
    d2 = render_wall(W, H, K, pose, wall_z=2.1219)
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH))

    vol = TSDFVolume.create(CFG_DENSE)
    vol = step(vol, make_frame(d1), SE3.from_matrix(pose))

    path = os.path.join(tmp_path, "vol.npz")
    save_volume(path, vol)
    restored = load_volume(path)
    assert restored.cfg == vol.cfg
    np.testing.assert_array_equal(np.asarray(restored.tsdf), np.asarray(vol.tsdf))
    np.testing.assert_array_equal(
        np.asarray(restored.entry_block), np.asarray(vol.entry_block)
    )

    # resuming from the checkpoint must reproduce continued fusion exactly
    a = step(vol, make_frame(d2), SE3.from_matrix(pose))
    b = step(restored, make_frame(d2), SE3.from_matrix(pose))
    np.testing.assert_array_equal(np.asarray(a.tsdf), np.asarray(b.tsdf))
    np.testing.assert_array_equal(np.asarray(a.weight), np.asarray(b.weight))
    assert int(a.num_active_blocks) == int(b.num_active_blocks)
