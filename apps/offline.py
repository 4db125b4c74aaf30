#!/usr/bin/env python
"""Offline TSDF replay — the benchmark entry point (API parity with
examples/tsdf/offline.cc).

Replays a logged dataset (trajectory.txt + {id}_rgb/_depth[/_ht/_no_ht]
PNGs, or a TUM RGB-D sequence) through the TSDF engine with the same
parameters as the reference example (voxel 0.01 m, truncation 0.06 m,
offline.cc:90), reports per-stage latencies, and can dump the fused
volume (/tmp/data.bin semantics) and render orbit views headlessly.

Usage:
  python apps/offline.py --logdir DATA --config configs/cam.yaml \
      [--tum] [--voxel 0.01] [--trunc 0.06] [--max-depth 10] \
      [--save /tmp/data.bin] [--render-dir out/] [--mesh out.obj]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", required=True, help="dataset directory")
    ap.add_argument("--config", help="camera YAML (Camera.fx..., depthmap_factor)")
    ap.add_argument("--tum", action="store_true", help="TUM RGB-D layout")
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--trunc", type=float, default=0.06)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--save", help="dump VoxelSpatialTSDF binary here")
    ap.add_argument("--mesh", help="extract + save OBJ mesh here")
    ap.add_argument(
        "--mesh-q16", action="store_true",
        help="uint16 fixed-point mesh D2H (2x fewer bytes, max error "
             "1/32 voxel; ops/mesh.py extract_mesh_chunked)",
    )
    ap.add_argument("--render-dir", help="write raycast PNGs here")
    ap.add_argument("--renderer", choices=["raycast", "splat"],
                    default="raycast",
                    help="parity ray marcher or the scatter splat")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--preset", choices=["full", "small"], default="full",
        help="volume capacity preset (small: quick CPU runs)",
    )
    ap.add_argument("--grid-log2", type=int, default=0, metavar="L",
                    help="dense backend: 2^L blocks per axis of coverage "
                         "(window extent = 2^L * 8 * voxel metres); 0 = "
                         "preset default")
    ap.add_argument("--scatter-window", type=int, default=0, metavar="L",
                    help="route fuse payload write-backs through a 2^L-row "
                         "window around the live pool rows (bounded scatter "
                         "operand; 0 = plain full-pool scatter)")
    ap.add_argument("--auto-recenter", action="store_true",
                    help="dense backend: move the coverage window to "
                         "follow the camera when it nears the grid edge "
                         "(TSDFGrid.maybe_recenter) — long corridors map "
                         "fully instead of truncating at +-grid_side/2")
    ap.add_argument("--spill", action="store_true",
                    help="with --auto-recenter: spill blocks leaving the "
                         "coverage window to host RAM and restore them when "
                         "the window returns (unbounded scenes at bounded "
                         "HBM; systems/block_streaming.py)")
    ap.add_argument("--page-radius", type=float, default=0.0, metavar="M",
                    help="with --spill: pool-pressure paging at waypoint "
                         "cadence — evict blocks farther than M metres "
                         "from the camera when the pool nears exhaustion, "
                         "restore stored blocks within M on revisit "
                         "(TSDFGrid.maybe_page)")
    ap.add_argument("--prefetch", type=int, default=4, metavar="N",
                    help="decode N frames ahead of the device (0 = "
                         "synchronous reads, the reference's behavior)")
    ap.add_argument("--profile", metavar="DIR",
                    help="capture a jax.profiler trace of the replay to DIR")
    ap.add_argument("--save-dist", metavar="NPZ",
                    help="with --devices: elastic sharded checkpoint, "
                         "restorable onto ANY device count")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="shard the volume over N devices (DistributedTSDF "
                         "block-ownership sharding, e.g. 4 GPUs; on a CPU "
                         "host set XLA_FLAGS="
                         "--xla_force_host_platform_device_count=N for a "
                         "virtual mesh)")
    ap.add_argument("--debug", action="store_true",
                    help="verbose logging + volume invariant validation "
                         "after every frame (the sanitizer pass)")
    args = ap.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from disinfect_slam.utils.cache import enable as _cache

    _cache()

    from disinfect_slam.config import TSDFConfig
    from disinfect_slam.io.config_reader import (
        get_depth_factor,
        get_extrinsics,
        get_intrinsics,
        load_yaml,
    )
    from disinfect_slam.io.dataset import LoggedReplay, TUMReplay
    from disinfect_slam.ops.gather import dump_spatial_tsdf
    from disinfect_slam.systems.tsdf_grid import TSDFGrid
    from disinfect_slam.utils.timing import StageTimer

    if args.config:
        cfg_yaml = load_yaml(args.config)
        intrinsics = get_intrinsics(cfg_yaml)
        depth_factor = get_depth_factor(cfg_yaml)
        extrinsics = get_extrinsics(cfg_yaml)
    else:
        # TUM freiburg1 defaults (configs/TUM_RGBD_rgbd_1.yaml)
        intrinsics = (517.3, 516.5, 318.6, 255.3)
        depth_factor = 5000.0
        extrinsics = np.eye(4, dtype=np.float32)

    if args.tum:
        replay = TUMReplay(args.logdir, depth_factor)
    else:
        replay = LoggedReplay(args.logdir, depth_factor, extrinsics)
    print(f"[offline] {len(replay)} frames")
    if args.prefetch > 0:
        # decode ahead of the device (the reference imreads inside its
        # render loop, offline.cc:157-160; at accelerator frame times the
        # PNG decode would otherwise serialize with fusion)
        from disinfect_slam.io.dataset import PrefetchReplay

        replay = PrefetchReplay(replay, depth=args.prefetch)

    cfg = None
    if args.preset == "small":
        cfg = TSDFConfig(
            num_blocks_log2=12,
            max_candidates=8192,
            max_visible=4096,
            max_new_per_round=2048,
            grid_log2=7,
        )
    elif args.voxel < 0.008:
        # sub-8mm voxels at VGA put ~30k blocks in view; the default
        # capacities (16k visible / 2^16 blocks) silently saturate, so
        # scale up to the bench-class working set
        cfg = TSDFConfig(
            num_buckets_log2=19,
            num_blocks_log2=17,
            max_candidates=32768,
            max_visible=32768,
            max_new_per_round=8192,
        )
    if args.grid_log2:
        import dataclasses

        cfg = dataclasses.replace(cfg or TSDFConfig(), grid_log2=args.grid_log2)
    if args.scatter_window:
        import dataclasses

        cfg = dataclasses.replace(
            cfg or TSDFConfig(), scatter_window_log2=args.scatter_window
        )
    if args.devices:
        _run_distributed(args, replay, intrinsics, cfg)
        return
    grid = TSDFGrid(args.voxel, args.trunc, cfg=cfg, host_spill=args.spill)
    timer = StageTimer()

    n = 0
    last_pose = np.eye(4, dtype=np.float32)
    warned_intr = False
    if args.profile:
        jax.profiler.start_trace(args.profile)
    for frame in replay:
        if not warned_intr:
            fh, fw = frame.depth.shape[:2]
            # cx/cy near the image center is how the intrinsics and the
            # dataset agree on resolution; a big mismatch means a wrong
            # (or missing) --config and silently fuses almost nothing
            if abs(intrinsics[2] - fw / 2) > fw / 4 or abs(
                intrinsics[3] - fh / 2
            ) > fh / 4:
                print(
                    f"[offline] WARNING: intrinsics (cx={intrinsics[2]:.1f}, "
                    f"cy={intrinsics[3]:.1f}) look wrong for {fw}x{fh} frames "
                    "-- pass --config with the dataset's camera YAML"
                )
            warned_intr = True
        if args.auto_recenter or (args.spill and args.page_radius > 0):
            cam_pos = np.linalg.inv(frame.cam_T_world)[:3, 3]
            if args.auto_recenter and grid.maybe_recenter(
                cam_pos, max_depth=args.max_depth
            ):
                print(f"[offline] recentered coverage window at frame {n}")
            if args.spill and args.page_radius > 0 and n % 10 == 0:
                r, e = grid.maybe_page(cam_pos, radius_m=args.page_radius)
                if r or e:
                    print(f"[offline] paged at frame {n}: restored {r}, "
                          f"evicted {e}")
        with timer.span("integrate"):
            grid.integrate(
                frame.rgb,
                frame.depth,
                frame.ht,
                frame.lt,
                args.max_depth,
                intrinsics,
                frame.cam_T_world,
            )
        last_pose = frame.cam_T_world
        n += 1
        if args.debug:
            from disinfect_slam.utils.validate import validate_volume

            with timer.span("validate"):
                validate_volume(grid.snapshot())
        if n % 25 == 0:
            grid.block_until_ready()
            print(
                f"[offline] frame {n}: integrate {timer.mean_ms('integrate'):.1f} ms "
                f"({1e3 / max(timer.mean_ms('integrate'), 1e-6):.1f} FPS), "
                f"{grid.num_active_blocks()} active blocks"
            )
        if args.max_frames and n >= args.max_frames:
            break
    grid.block_until_ready()
    if args.profile:
        jax.profiler.stop_trace()
        print(f"[offline] profiler trace written to {args.profile}")
    total_ms = timer.mean_ms("integrate")
    print(
        f"[offline] done: {n} frames, integrate {total_ms:.2f} ms/frame "
        f"({1e3 / max(total_ms, 1e-6):.1f} FPS), {grid.num_active_blocks()} blocks"
    )
    if args.debug:
        print(f"[offline] volume invariants OK every frame "
              f"(validate {timer.mean_ms('validate'):.1f} ms/frame)")

    if args.save:
        with timer.span("gather"):
            st = grid.gather_valid()
            cnt = dump_spatial_tsdf(st, args.save)
        print(f"[offline] saved {cnt} voxels to {args.save} "
              f"({timer.mean_ms('gather'):.1f} ms)")
        if grid.spill_store is not None and len(grid.spill_store):
            # spilled blocks live in host RAM, not the device volume:
            # append their records so the dump covers the WHOLE map
            rec = grid.spill_store.spatial_records(grid.cfg)
            with open(args.save, "ab") as f:
                rec.astype("<f4").tofile(f)
            print(f"[offline] appended {rec.shape[0]} spilled voxels "
                  f"({len(grid.spill_store)} blocks from the host store)")

    if args.mesh and grid.spill_store is not None and len(grid.spill_store):
        print(f"[offline] WARNING: --mesh covers the on-device window only; "
              f"{len(grid.spill_store)} spilled blocks are in the host "
              "store (page them back in or mesh per-region)")
    if args.mesh:
        from disinfect_slam.ops.mesh import (
            extract_mesh_chunked,
            merge_vertices,
            save_obj,
        )

        with timer.span("mesh"):
            tris = extract_mesh_chunked(
                grid.volume,
                transfer="q16" if args.mesh_q16 else "f32",
            )
            verts, faces = merge_vertices(tris)
        save_obj(args.mesh, verts, faces)
        print(f"[offline] mesh: {len(verts)} verts, {len(faces)} faces "
              f"-> {args.mesh} ({timer.mean_ms('mesh'):.1f} ms)")

    if args.render_dir:
        from disinfect_slam.viz.headless import render_to_png

        h, w = 360, 640
        with timer.span("render"):
            paths = render_to_png(
                grid,
                args.render_dir,
                last_pose,
                (intrinsics, h, w),
                renderer=args.renderer,
                max_depth=args.max_depth,
                prefix="final",
            )
        print(f"[offline] rendered {paths} ({timer.mean_ms('render'):.1f} ms)")


def _run_distributed(args, replay, intrinsics, cfg):
    """Replay through the block-ownership-sharded volume
    (parallel/sharding.py) and print a per-shard scaling table."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp

    from disinfect_slam.config import TSDFConfig
    from disinfect_slam.ops.integrate import FrameInput
    from disinfect_slam.parallel.sharding import DistributedTSDF, make_mesh

    n_dev = args.devices
    avail = len(jax.devices())
    if avail < n_dev:
        print(f"[offline] ERROR: {n_dev} devices requested, {avail} available "
              "(set XLA_FLAGS=--xla_force_host_platform_device_count=N for a "
              "virtual CPU mesh)")
        sys.exit(2)
    base = cfg or TSDFConfig()
    base = dataclasses.replace(
        base, voxel_size=args.voxel, truncation=args.trunc
    )
    mesh = make_mesh(n_dev)
    dist = DistributedTSDF(base, mesh)
    print(f"[offline] distributed: {n_dev} shards, "
          f"{dist.sub_cfg.num_blocks} blocks/shard")

    n = 0
    t0 = time.perf_counter()
    for frame in replay:
        fr = FrameInput(
            rgb=jnp.asarray(frame.rgb, jnp.float32),
            depth=jnp.asarray(frame.depth, jnp.float32),
            ht=jnp.asarray(frame.ht, jnp.float32),
            lt=jnp.asarray(frame.lt, jnp.float32),
        )
        dist.integrate(fr, intrinsics, frame.cam_T_world, args.max_depth)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    jax.block_until_ready(dist.volume.tsdf)
    wall = time.perf_counter() - t0
    # per-shard table: active blocks per shard (the load balance of the
    # block-ownership hash)
    per_shard = np.asarray(dist.sub_cfg.num_blocks - dist.volume.num_free)
    print(f"[offline] distributed done: {n} frames in {wall:.1f} s "
          f"({n / wall:.1f} FPS), {int(per_shard.sum())} active blocks")
    print("[offline] shard | active blocks | share")
    for i, a in enumerate(per_shard):
        print(f"[offline]   {i:3d} | {int(a):13d} | {a / max(per_shard.sum(), 1):.3f}")

    if args.save:
        rec = dist.gather_all_tsdf()  # [N, 4] f32 records, all shards
        rec.astype("<f4").tofile(args.save)
        print(f"[offline] saved {rec.shape[0]} voxels to {args.save}")
    if args.save_dist:
        from disinfect_slam.parallel.sharding import save_distributed

        nb = save_distributed(args.save_dist, dist)
        print(f"[offline] elastic checkpoint: {nb} blocks -> "
              f"{args.save_dist} (restorable onto any device count via "
              "parallel.sharding.load_distributed)")


if __name__ == "__main__":
    main()
