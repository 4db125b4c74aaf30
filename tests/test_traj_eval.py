"""Trajectory evaluation (ATE/RPE) tests.

Pins: Umeyama recovery of known similarity transforms, ATE invariance
under rigid motion of the estimate, RPE drift accounting, TUM + matrix
file-format loading (round-trip through save_matched_trajectory), and
the CLI report.
"""

import json
import subprocess
import sys
import os

import numpy as np
import pytest

from disinfect_slam.utils import trajectory_eval as te
from disinfect_slam.systems.slam import save_matched_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _orbit_poses(n=40, radius=1.5):
    """world_T_cam poses on a circle, lookat origin-ish (orientation
    varies so RPE rotation terms are exercised)."""
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        m = np.eye(4)
        m[:3, :3] = _rot([0, 0, 1], th) @ _rot([1, 0, 0], 0.1 * np.sin(th))
        m[:3, 3] = [radius * np.cos(th), radius * np.sin(th), 0.2 * np.sin(2 * th)]
        poses.append(m)
    return np.stack(poses)


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    rot = _rot([0.3, -0.5, 0.8], 1.1)
    s_true, t_true = 1.7, np.array([0.4, -2.0, 0.9])
    dst = s_true * src @ rot.T + t_true
    s, r, t = te.umeyama_alignment(src, dst, with_scale=True)
    assert abs(s - s_true) < 1e-9
    np.testing.assert_allclose(r, rot, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)
    # rigid mode pins scale to 1
    s2, _, _ = te.umeyama_alignment(src, dst, with_scale=False)
    assert s2 == 1.0


def test_umeyama_reflection_guard():
    # mirrored points must still yield a proper rotation (det +1)
    rng = np.random.default_rng(1)
    src = rng.normal(size=(30, 3))
    dst = src * np.array([1.0, 1.0, -1.0])
    _, r, _ = te.umeyama_alignment(src, dst)
    assert np.linalg.det(r) > 0.99


def test_ate_zero_after_alignment():
    gt = _orbit_poses()
    rot = _rot([0, 1, 0], 0.7)
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] @ rot.T + np.array([3.0, -1.0, 2.0])
    est[:, :3, :3] = np.einsum("ij,njk->nik", rot, gt[:, :3, :3])
    a = te.ate(gt, est, align=True)
    assert a["rmse"] < 1e-9
    # without alignment the offset shows
    a2 = te.ate(gt, est, align=False)
    assert a2["rmse"] > 1.0


def test_ate_reports_noise_level():
    rng = np.random.default_rng(2)
    gt = _orbit_poses(n=200)
    est = gt.copy()
    noise = rng.normal(scale=0.01, size=(200, 3))
    est[:, :3, 3] += noise
    a = te.ate(gt, est, align=True)
    expected = np.sqrt((noise**2).sum(axis=1).mean())
    assert 0.5 * expected < a["rmse"] <= expected * 1.05


def test_rpe_drift():
    gt = _orbit_poses()
    # constant per-frame translational drift in the world frame: the
    # relative-error magnitude per step is then exactly `drift`
    est = gt.copy()
    drift = 0.002
    for i in range(len(est)):
        est[i, :3, 3] += np.array([drift * i, 0, 0])
    r = te.rpe(gt, est, delta=1)
    assert abs(r["trans"]["mean"] - drift) < 1e-12
    assert r["rot_rad"]["max"] < 1e-7
    r5 = te.rpe(gt, est, delta=5)
    assert abs(r5["trans"]["mean"] - 5 * drift) < 1e-12
    with pytest.raises(ValueError):
        te.rpe(gt, est, delta=len(gt))


def test_load_matrix_format_roundtrip(tmp_path):
    gt = _orbit_poses(n=12)
    # save_matched_trajectory writes cam_T_world rows
    cams = {i: np.linalg.inv(gt[i]).astype(np.float32) for i in range(12)}
    path = tmp_path / "traj.txt"
    n = save_matched_trajectory(str(path), cams, range(12))
    assert n == 12
    ts, poses = te.load_trajectory(str(path))
    np.testing.assert_array_equal(ts, np.arange(12))
    np.testing.assert_allclose(poses, gt, atol=1e-6)


def test_load_tum_format(tmp_path):
    path = tmp_path / "tum.txt"
    with open(path, "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n")
        f.write("0.0 1 2 3 0 0 0 1\n")
        # 90 deg about z
        s = np.sqrt(0.5)
        f.write(f"1.0 4 5 6 0 0 {s} {s}\n")
    ts, poses = te.load_trajectory(str(path))
    assert ts.tolist() == [0.0, 1.0]
    np.testing.assert_allclose(poses[0, :3, 3], [1, 2, 3])
    np.testing.assert_allclose(
        poses[1, :3, :3], _rot([0, 0, 1], np.pi / 2), atol=1e-12
    )


def test_associate_greedy_unique():
    ta = np.array([0.0, 1.0, 2.0, 3.0])
    tb = np.array([0.011, 1.5, 2.009, 2.991, 5.0])
    pairs = te.associate(ta, tb, max_dt=0.02)
    assert pairs == [(0, 0), (2, 2), (3, 3)]
    # each index used at most once even with two close candidates
    pairs2 = te.associate(np.array([0.0]), np.array([0.001, 0.002]), 0.01)
    assert pairs2 == [(0, 0)]


def test_evaluate_cli(tmp_path):
    gt = _orbit_poses(n=20)
    est = gt.copy()
    est[:, :3, 3] += 0.005
    gt_path, est_path = tmp_path / "gt.txt", tmp_path / "est.txt"
    for path, poses in ((gt_path, gt), (est_path, est)):
        cams = {
            i: np.linalg.inv(poses[i]).astype(np.float64)
            for i in range(len(poses))
        }
        save_matched_trajectory(str(path), cams, range(len(poses)))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", "evaluate.py"),
         str(gt_path), str(est_path), "--max-dt", "0.5"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["pairs"] == 20
    assert rep["ate"]["rmse"] < 1e-6  # constant offset absorbed by alignment
    # file rows carry 9 decimals, so expect quantization at ~1e-9/element
    assert rep["rpe"]["trans"]["rmse"] < 1e-7
