#!/usr/bin/env python
"""DenseSLAM steady-state frame time on the default JAX backend.

  python scripts/bench_dense_slam.py [--track-scale N]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax


from bench import make_orbit_frames  # noqa: E402
from disinfect_slam.config import TSDFConfig  # noqa: E402
from disinfect_slam.systems.dense_slam import DenseSLAM  # noqa: E402
from disinfect_slam.utils import cache  # noqa: E402

cache.enable()

W, H = 640, 480
K = (525.1, 525.3, 319.6, 239.7)


def main():
    ts = 1
    if len(sys.argv) > 1 and sys.argv[1] == "--track-scale":
        ts = int(sys.argv[2])
    cfg = TSDFConfig(
        voxel_size=0.01, truncation=0.06,
        num_blocks_log2=16, max_candidates=32768, max_visible=16384,
        max_new_per_round=8192, backend="dense", grid_log2=8,
    )
    slam = DenseSLAM(K, H, W, voxel_size=0.01, truncation=0.06,
                     max_depth=4.0, cfg=cfg, track_res_scale=ts)
    frames = make_orbit_frames(40, W, H, K)
    print(f"backend={jax.default_backend()} track_scale={ts}", flush=True)
    # bootstrap + compile
    for f in frames[:3]:
        slam.process_frame(f[1], f[2])
    jax.block_until_ready(slam.volume.tsdf)
    t0 = time.perf_counter()
    for f in frames[3:]:
        slam.process_frame(f[1], f[2])
    jax.block_until_ready(slam.volume.tsdf)
    dt = time.perf_counter() - t0
    n = len(frames) - 3
    # accuracy axis for the track-scale A/B: final-pose error vs the
    # generator's ground-truth orbit pose
    gt = np.linalg.inv(frames[-1][0].astype(np.float64))
    est = slam.world_T_cam.astype(np.float64)
    terr = float(np.linalg.norm(gt[:3, 3] - est[:3, 3]))
    print(f"dense_slam steady state: {dt / n * 1e3:.1f} ms/frame "
          f"({n / dt:.2f} FPS), lost {slam.lost_count} of {n}, "
          f"final-pose err {terr * 100:.2f} cm", flush=True)


if __name__ == "__main__":
    main()
