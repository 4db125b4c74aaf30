#!/usr/bin/env python
"""Online semantic reconstruction pipeline (examples/tsdf/online.cc parity).

Three concurrent streams, like the reference's thread layout
(online.cc:23-70):
  - pose stream:  a pose source (replayed trajectory or external SLAM
    bridge) registers timestamped poses into the pose manager
  - depth stream: RGB-D frames -> (optional) segmentation -> enqueue into
    the async TSDFSystem, borrowing the nearest pose by timestamp
  - main thread:  periodic headless renders + stats

Without real cameras this app runs from a logged dataset directory (the
same layout `apps/offline.py` replays) but through the full asynchronous
system stack — the closest host-side equivalent of the live pipeline.
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", required=True)
    ap.add_argument("--config", help="camera YAML")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--trunc", type=float, default=0.2)
    ap.add_argument("--max-depth", type=float, default=4.0)
    ap.add_argument("--fps", type=float, default=30.0, help="playback rate")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop after N frames (0 = the whole replay)")
    ap.add_argument("--segment", action="store_true", help="run ht/lt segmentation")
    ap.add_argument("--seg-ckpt", help="segmentation checkpoint (npz, models/train.py save_checkpoint)")
    ap.add_argument("--seg-arch", default="unet", choices=["unet", "fast"],
                    help="segmentation model family: 'unet' (quality, "
                    "IoU .97/.99) or 'fast' (latency-first 2-resolution "
                    "trunk, IoU .90/.99, ~2x lower device time)")
    ap.add_argument(
        "--fused", action="store_true",
        help="one-dispatch online path: seg forward + fusion in a single "
        "jitted program per frame (systems/online_step.py) — no host "
        "round trip between segmentation and integration",
    )
    ap.add_argument(
        "--stereo", action="store_true",
        help="logdir holds {id}_left/_right.png stereo pairs; depth is "
        "computed by block matching instead of read from _depth.png",
    )
    ap.add_argument("--baseline", type=float, default=0.12,
                    help="stereo baseline in metres (ZED: 0.12)")
    ap.add_argument("--stereo-method", choices=("flat", "pyramid"),
                    default="flat",
                    help="block matcher: flat full cost volume or "
                    "coarse-to-fine pyramid (less work, more gathers)")
    ap.add_argument("--max-disp", type=int, default=64)
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: follow the camera past the "
                         "coverage window edge (TSDFGrid.maybe_recenter)")
    ap.add_argument("--render-dir")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--preset", choices=["full", "small"], default="full")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from disinfect_slam.utils.cache import enable as _cache

    _cache()

    from disinfect_slam.io.config_reader import (
        get_depth_factor,
        get_intrinsics,
        load_yaml,
    )
    from disinfect_slam.config import TSDFConfig
    from disinfect_slam.io.dataset import LoggedReplay
    from disinfect_slam.systems.disinf_system import DISINFSystem

    cfg = None
    if args.preset == "small":
        cfg = TSDFConfig(
            num_blocks_log2=12, max_candidates=8192, max_visible=4096,
            max_new_per_round=2048, grid_log2=7,
        )

    if args.config:
        cfg_yaml = load_yaml(args.config)
        intrinsics = get_intrinsics(cfg_yaml)
        depth_factor = get_depth_factor(cfg_yaml)
    else:
        intrinsics = (517.3, 516.5, 318.6, 255.3)
        depth_factor = 5000.0

    segmenter = None
    if args.segment:
        from disinfect_slam.models.segmentation import InferenceEngine, create_model
        from disinfect_slam.models.train import load_params

        model = create_model(arch=args.seg_arch)
        if args.seg_ckpt:
            params = load_params(args.seg_ckpt)
        else:
            from disinfect_slam.models.segmentation import load_default_params

            params = load_default_params(arch=args.seg_arch)
            if params is None:
                params = model.init(
                    jax.random.PRNGKey(0), np.zeros((1, 352, 640, 3), np.float32)
                )
                print("[online] WARNING: no shipped weights, using random init")
            else:
                print("[online] using shipped seg weights")
        # one engine per frame size: it resizes its ht/lt output
        # straight to the depth resolution
        engines = {}

        def segmenter(rgb):
            hw = rgb.shape[:2]
            if hw not in engines:
                engines[hw] = InferenceEngine(model, params, out_size=hw)
            ht, lt = engines[hw].infer_one(rgb)
            return ht, lt

    if args.stereo:
        # stereo-only sensor: depth from block matching on the rectified
        # pair (ops/stereo.py), rgb from the left view — no RGBD camera
        # needed (the reference requires an L515 here, online.cc:23-70)
        from disinfect_slam.io.dataset import LoggedStereoReplay, ReplayFrame
        from disinfect_slam.ops.stereo import StereoDepthEstimator

        stereo_replay = LoggedStereoReplay(args.logdir)
        est = StereoDepthEstimator(
            fx=intrinsics[0], baseline_m=args.baseline,
            max_disp=args.max_disp, max_depth=args.max_depth,
            method=args.stereo_method,
        )

        class _StereoAsRGBD:
            entries = stereo_replay.entries

            def __len__(self):
                return len(stereo_replay)

            def __iter__(self):
                for fr in stereo_replay:
                    depth = est(fr.left, fr.right)
                    rgb = fr.left
                    if rgb.ndim == 2:
                        rgb = np.repeat(rgb[..., None], 3, axis=-1)
                    pose = (
                        fr.cam_T_world
                        if fr.cam_T_world is not None
                        else np.eye(4, dtype=np.float32)
                    )
                    yield ReplayFrame(
                        fr.frame_id, pose, rgb, depth,
                        np.zeros_like(depth), np.ones_like(depth),
                    )

        replay = _StereoAsRGBD()
        print(f"[online] stereo replay: depth via block matching "
              f"(baseline {args.baseline} m, max_disp {args.max_disp})")
    else:
        replay = LoggedReplay(args.logdir, depth_factor)
    print(f"[online] {len(replay)} frames @ {args.fps} fps playback")

    if args.fused:
        # one-dispatch path: synchronous loop, each frame is a single
        # H2D + jitted seg+fuse program (the honest online FPS)
        import dataclasses as _dc

        from disinfect_slam.systems.online_step import FusedOnlineStep

        first = next(iter(replay))
        fh, fw = first.depth.shape
        ocfg = cfg if cfg is not None else TSDFConfig(
            voxel_size=args.voxel, truncation=args.trunc,
        )
        ocfg = _dc.replace(ocfg, voxel_size=args.voxel, truncation=args.trunc)
        seg_model = seg_params = None
        if args.segment:
            # reuse the model/params resolved above (honors --seg-ckpt;
            # the fused path previously reloaded the shipped defaults
            # and silently ignored a user checkpoint)
            seg_model, seg_params = model, params
            if seg_params is None:
                print("[online] WARNING: no seg weights; --fused runs seg-off")
                seg_model = None
        step = FusedOnlineStep(
            ocfg, intrinsics, fh, fw, args.max_depth,
            seg_model=seg_model, seg_params=seg_params,
        )
        t0 = time.perf_counter()
        n = 0
        for frame in replay:
            step.step(frame.rgb, frame.depth, frame.cam_T_world)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
        step.block_until_ready()
        wall = time.perf_counter() - t0
        print(
            f"[online] fused: {n} frames in {wall:.1f} s "
            f"({n / wall:.1f} FPS incl H2D+seg), "
            f"{step.num_active_blocks()} active blocks"
        )
        if args.render_dir:
            from disinfect_slam.systems.tsdf_grid import TSDFGrid
            from disinfect_slam.viz.headless import render_to_png

            grid = TSDFGrid(args.voxel, args.trunc, cfg=ocfg)
            grid.volume = step.volume
            last_pose = replay.entries[-1][1]
            if last_pose is None:  # stereo capture without trajectory rows
                last_pose = np.eye(4, dtype=np.float32)
            render_to_png(
                grid, args.render_dir, last_pose,
                (intrinsics, 360, 640), max_depth=args.max_depth,
            )
            print(f"[online] rendered final view to {args.render_dir}")
        return

    with DISINFSystem(
        intrinsics,
        depth_factor=1.0,  # replay loader already scales depth
        voxel_size=args.voxel,
        truncation=args.trunc,
        max_depth=args.max_depth,
        segmenter=segmenter,
        half_scale=False,
        cfg=cfg,
        auto_recenter=args.auto_recenter,
    ) as system:
        period = 1.0 / args.fps
        t_start = time.perf_counter()

        def pose_thread():
            # plays the trajectory as the "SLAM" stream, slightly ahead
            for i, (fid, pose) in enumerate(replay.entries):
                if pose is None:  # stereo capture without trajectory rows
                    continue
                system.feed_pose(int(i * 1000 * period), pose)
                time.sleep(period * 0.5)

        tp = threading.Thread(target=pose_thread, daemon=True)
        tp.start()

        n = 0
        for i, frame in enumerate(replay):
            system.feed_rgbd_frame(frame.rgb, frame.depth, int(i * 1000 * period))
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
            if n % 30 == 0:
                depth_q = system.tsdf.queue_depth()
                print(
                    f"[online] {n} frames, queue depth {depth_q}, "
                    f"{system.tsdf.tsdf.num_active_blocks()} blocks"
                )
            # pace playback
            t_next = t_start + (i + 1) * period
            dt = t_next - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        tp.join()
        system.tsdf.flush()
        wall = time.perf_counter() - t_start
        print(
            f"[online] done: {n} frames in {wall:.1f} s "
            f"({n / wall:.1f} FPS sustained), "
            f"{system.tsdf.tsdf.num_active_blocks()} active blocks"
        )

        if args.render_dir:
            from disinfect_slam.viz.headless import render_to_png

            last_pose = replay.entries[-1][1]
            render_to_png(
                system.tsdf.tsdf,
                args.render_dir,
                last_pose,
                (intrinsics, 360, 640),
                max_depth=args.max_depth,
            )
            print(f"[online] rendered final view to {args.render_dir}")


if __name__ == "__main__":
    main()
