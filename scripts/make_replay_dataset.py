#!/usr/bin/env python
"""Produce the checked-in benchmark replay dataset (datasets/orbit_vga).

The reference's benchmark flow is record-then-replay: pseudo_online_capture
writes `{id}_rgb/_depth/_ht/_no_ht.png` + a matched trajectory.txt
(pseudo_online_capture.cc:52-65) and examples/tsdf/offline.cc replays it
deterministically.  TUM rgbd_1 — the BASELINE.md dataset — is unobtainable
on this rig (zero egress), so this script records the synthetic stand-in
workload (the exact bench.py orbit: sphere + back wall, 640x480, 60
frames) in that same logged-PNG layout, with ground-truth poses, at TUM's
depth_factor 5000 (u16 depth counts, 0.2 mm quantization).

The output is checked into git so every round replays the SAME frames;
bench.py prefers it over in-memory generation when present, and
tests/test_replay_dataset.py pins its integrity against this generator.

Deterministic: no RNG, no timestamps.  Regenerating must be a no-op diff.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

DATASET_DIR = os.path.join(REPO, "datasets", "orbit_vga")
W, H = 640, 480
K = (525.1, 525.3, 319.6, 239.7)
N_FRAMES = 60
DEPTH_FACTOR = 5000.0  # TUM rgbd_1 (configs/TUM_RGBD_rgbd_1.yaml)


def bench_orbit_frame(i, n_frames=N_FRAMES, w=W, h=H, K=K):
    """Frame i of the bench.py orbit (kept in exact sync with
    bench.make_orbit_frames): returns (pose, rgb u8, depth f32 m, ht, lt)."""
    from scenes import checker_rgb, look_at, render_sphere, render_wall

    rgb = checker_rgb(w, h)
    ang = 0.25 * np.sin(2 * np.pi * i / n_frames)
    eye = (
        np.sin(ang) * 1.9 + 0.013,
        -0.021 + 0.03 * np.sin(i * 0.4),
        -1.9 * np.cos(ang) + 1.0,
    )
    pose = look_at(eye, (0.013, -0.021, 1.007))
    d_sphere = render_sphere(w, h, K, pose, center=(0.013, -0.021, 1.007), radius=0.413)
    d_wall = render_wall(w, h, K, pose, wall_z=2.213)
    depth = np.where(d_sphere > 0, d_sphere, d_wall).astype(np.float32)
    ht = (0.5 + 0.4 * (d_sphere > 0)).astype(np.float32)
    lt = (1.0 - ht).astype(np.float32)
    return pose.astype(np.float32), rgb, depth, ht, lt


def main():
    from disinfect_slam.io.png_io import write_image

    os.makedirs(DATASET_DIR, exist_ok=True)
    traj_rows = []
    for i in range(N_FRAMES):
        pose, rgb, depth, ht, lt = bench_orbit_frame(i)
        base = os.path.join(DATASET_DIR, str(i))
        write_image(base + "_rgb.png", np.clip(rgb, 0, 255).astype(np.uint8))
        write_image(
            base + "_depth.png",
            np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16),
        )
        write_image(
            base + "_ht.png", np.clip(ht * 65535, 0, 65535).astype(np.uint16)
        )
        write_image(
            base + "_no_ht.png", np.clip(lt * 65535, 0, 65535).astype(np.uint16)
        )
        row = " ".join(f"{v:.9f}" for v in pose[:3, :4].reshape(-1))
        traj_rows.append(f"{i} {row}\n")
    with open(os.path.join(DATASET_DIR, "trajectory.txt"), "w") as f:
        f.writelines(traj_rows)
    with open(os.path.join(DATASET_DIR, "cam.yaml"), "w") as f:
        f.write(
            "# orbit_vga: checked-in synthetic benchmark replay "
            "(scripts/make_replay_dataset.py)\n"
            f"Camera.fx: {K[0]}\nCamera.fy: {K[1]}\n"
            f"Camera.cx: {K[2]}\nCamera.cy: {K[3]}\n"
            f"Camera.rows: {H}\nCamera.cols: {W}\n"
            f"depthmap_factor: {DEPTH_FACTOR}\n"
        )
    total = sum(
        os.path.getsize(os.path.join(DATASET_DIR, p))
        for p in os.listdir(DATASET_DIR)
    )
    print(f"wrote {N_FRAMES} frames to {DATASET_DIR} ({total / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
