#!/usr/bin/env python
"""Run the reconstruction HTTP service + interactive browser viewer.

  python apps/serve.py --port 8800 --mode slam --voxel 0.01
  # clients: POST /frame npz{rgb, depth, timestamp_ms[, pose]},
  #          GET /stats /pose /query /mesh /render

With a replay attached, http://host:port/ serves the interactive viewer
(orbit/zoom/pan, follow-cam, Start/Pause/Step, bbox query — the
renderer_module.cc parity surface):

  python apps/serve.py --replay /data/logdir --depth-factor 1000
  python apps/serve.py --synthetic 60        # built-in orbit scene demo
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--mode", choices=["disinf", "slam"], default="disinf")
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: follow the robot past the "
                         "coverage window edge (TSDFGrid.maybe_recenter)")
    ap.add_argument("--spill", action="store_true",
                    help="with --auto-recenter: spill blocks leaving the "
                         "window to host RAM and restore them on return "
                         "(systems/block_streaming.py)")
    ap.add_argument("--fx", type=float, default=517.3)
    ap.add_argument("--fy", type=float, default=516.5)
    ap.add_argument("--cx", type=float, default=318.6)
    ap.add_argument("--cy", type=float, default=255.3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--trunc", type=float, default=0.06)
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--replay", default=None,
                    help="logged dataset dir (trajectory.txt + PNGs) to "
                         "drive via the viewer's Start/Pause controls")
    ap.add_argument("--tum", action="store_true",
                    help="--replay dir uses the TUM RGB-D layout")
    ap.add_argument("--depth-factor", type=float, default=1000.0)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="attach an N-frame synthetic orbit replay (demo)")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="replay throttle (0 = as fast as fusion allows)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from disinfect_slam.utils.cache import enable as _cache

    _cache()

    from disinfect_slam.systems.server import ReconstructionService, make_server

    intr = (args.fx, args.fy, args.cx, args.cy)
    if args.mode == "slam":
        from disinfect_slam.systems.dense_slam import DenseSLAM

        system = DenseSLAM(
            intr, args.height, args.width,
            voxel_size=args.voxel, truncation=args.trunc, max_depth=args.max_depth,
            host_spill=args.spill,
        )
    else:
        from disinfect_slam.systems.disinf_system import DISINFSystem

        system = DISINFSystem(
            intr, voxel_size=args.voxel, truncation=args.trunc,
            max_depth=args.max_depth, half_scale=False,
            auto_recenter=args.auto_recenter, host_spill=args.spill,
        )

    svc = ReconstructionService(system, mode=args.mode,
                                auto_recenter=args.auto_recenter)

    replay = None
    if args.replay or args.synthetic:
        from disinfect_slam.systems.server import ReplayDriver

        frames = []
        if args.replay:
            from disinfect_slam.io.dataset import LoggedReplay, TUMReplay

            src = (
                TUMReplay(args.replay)
                if args.tum
                else LoggedReplay(args.replay, args.depth_factor)
            )
            for i, fr in enumerate(src):
                pose = None if args.mode == "slam" else fr.cam_T_world
                frames.append((fr.rgb, fr.depth, i * 33, fr.ht, fr.lt, pose))
        else:
            import bench  # repo-root synthetic orbit scene

            K = (args.fx, args.fy, args.cx, args.cy)
            for i, (pose, rgb, depth, ht, lt) in enumerate(
                bench.make_orbit_frames(args.synthetic, args.width, args.height, K)
            ):
                p = None if args.mode == "slam" else pose
                frames.append((rgb, depth, i * 33, ht, lt, p))
        replay = ReplayDriver(svc, frames, fps=args.fps)
        print(f"[serve] replay attached: {len(frames)} frames (paused; "
              f"press Start in the viewer)")

    httpd = make_server(svc, args.host, args.port, replay=replay)
    print(f"[serve] {args.mode} reconstruction on http://{args.host}:{args.port}")
    print(f"[serve] interactive viewer: http://{args.host}:{args.port}/")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
