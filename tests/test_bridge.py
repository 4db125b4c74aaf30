"""Reconstruction bridge test: periodic mesh + pose callbacks over the
full DISINF facade (the ROS-node analogue)."""

import time

import numpy as np

from disinfect_slam.ops.gather import BoundingCube
from disinfect_slam.systems.bridge import ReconstructionBridge
from disinfect_slam.systems.disinf_system import DISINFSystem

from .scenes import look_at, render_wall
from .test_integrate import CFG_DENSE, H, K, W


def test_bridge_callbacks():
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)

    meshes = []
    poses = []
    with DISINFSystem(
        K, depth_factor=1.0, voxel_size=0.05, truncation=0.15,
        cfg=CFG_DENSE, half_scale=False,
    ) as system:
        system.feed_pose(0, pose)
        for i in range(3):
            system.feed_rgbd_frame(rgb, depth, i * 33)
        system.tsdf.flush()

        bridge = ReconstructionBridge(
            system,
            BoundingCube(-3, 3, -3, 3, 0, 4),
            mesh_callback=lambda v, f: meshes.append((v, f)),
            pose_callback=lambda p: poses.append(p),
            mesh_period=0.3,
            pose_period=0.05,
        )
        with bridge:
            bridge.notify_frame(66)
            deadline = time.time() + 60
            while time.time() < deadline and (len(meshes) < 1 or len(poses) < 3):
                time.sleep(0.1)

    assert len(poses) >= 3
    np.testing.assert_allclose(poses[-1], np.linalg.inv(pose), atol=1e-5)
    assert len(meshes) >= 1
    verts, faces = meshes[-1]
    assert len(verts) > 50 and len(faces) > 50
    # mesh vertices near the wall plane
    assert abs(np.median(verts[:, 2]) - 2.0131) < 0.1


def test_bridge_budget_warning(caplog):
    """A mesh query slower than mesh_period must WARN that the 5 Hz
    publish contract is degrading (the ros_offline.cc:293-294 timing-log
    analogue), with exponential backoff."""
    import logging

    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    rgb = np.full((H, W, 3), 120, np.float32)
    with DISINFSystem(
        K, depth_factor=1.0, voxel_size=0.05, truncation=0.15,
        cfg=CFG_DENSE, half_scale=False,
    ) as system:
        system.feed_pose(0, pose)
        system.feed_rgbd_frame(rgb, depth, 0)
        system.tsdf.flush()

        def slow_cb(v, f):
            time.sleep(0.05)

        bridge = ReconstructionBridge(
            system,
            BoundingCube(-3, 3, -3, 3, 0, 4),
            mesh_callback=slow_cb,
            mesh_period=0.01,  # impossible budget: every cycle overruns
            pose_period=0.5,
        )
        with caplog.at_level(
            logging.WARNING, logger="disinfect_slam.systems.bridge"
        ):
            with bridge:
                deadline = time.time() + 60
                while time.time() < deadline and not any(
                    "budget" in r.message for r in caplog.records
                ):
                    time.sleep(0.05)
    assert any("budget" in r.message for r in caplog.records)
