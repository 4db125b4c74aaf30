"""Pose-source interface tests: trajectory replay, external bridge,
matched-trajectory export roundtrip."""

import os

import numpy as np

from disinfect_slam.io.dataset import LoggedReplay
from disinfect_slam.systems.slam import (
    ExternalSLAMBridge,
    TrajectorySource,
    save_matched_trajectory,
)


def pose_t(tx):
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = tx
    return m


def test_trajectory_source_nearest():
    src = TrajectorySource([100, 200, 300], [pose_t(1), pose_t(2), pose_t(3)])
    assert src.feed_stereo(None, None, 90)[0, 3] == 1
    assert src.feed_stereo(None, None, 210)[0, 3] == 2
    assert src.feed_stereo(None, None, 999)[0, 3] == 3


def test_external_bridge_tracking_lost():
    calls = []

    def tracker(l, r, ts, imu):
        calls.append(ts)
        return None if ts == 200 else pose_t(ts / 100.0)

    b = ExternalSLAMBridge(tracker)
    p0 = b.feed_stereo(None, None, 100)
    p1 = b.feed_stereo(None, None, 200)  # lost
    p2 = b.feed_stereo(None, None, 300)
    assert p0 is not None and p2 is not None
    assert p1 is None  # lost frames yield no pose (slam_module.cc:111-118)
    assert b.log[1][2] is False


def test_save_matched_trajectory_skips_lost_and_replays(tmp_path):
    # frames 0..3, frame 2 lost -> only 3 rows (slam_module.cc:49)
    poses = {0: pose_t(0.0), 1: pose_t(0.1), 2: None, 3: pose_t(0.3)}
    path = os.path.join(tmp_path, "trajectory.txt")
    n = save_matched_trajectory(path, poses, [0, 1, 2, 3])
    assert n == 3
    lines = open(path).read().splitlines()
    assert len(lines) == 3
    assert lines[0].split()[0] == "0"

    # the export is replayable by LoggedReplay given matching images
    from disinfect_slam.io.png_io import write_image

    for fid in (0, 1, 3):
        rgb = np.zeros((8, 8, 3), np.uint8)
        d = np.full((8, 8), 1000, np.uint16)
        write_image(os.path.join(tmp_path, f"{fid}_rgb.png"), rgb)
        write_image(os.path.join(tmp_path, f"{fid}_depth.png"), d)
    replay = LoggedReplay(str(tmp_path), depth_factor=1000.0)
    frames = list(replay)
    assert len(frames) == 3
    np.testing.assert_allclose(frames[1].cam_T_world, pose_t(0.1), atol=1e-6)
