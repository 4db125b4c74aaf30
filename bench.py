#!/usr/bin/env python
"""Benchmark: end-to-end semantic TSDF fusion throughput.

Replays a synthetic 640x480 RGB-D orbit (the TUM rgbd_1-like workload of
BASELINE.md) through the jitted integrate step at 4 mm voxels and prints
ONE JSON line:

  {"metric": "tsdf_fusion_fps", "value": N, "unit": "frames/s",
   "vs_baseline": N / 60.0}

vs_baseline is against the north star of 60 FPS (BASELINE.json); the
reference itself publishes no numbers.  The JSON line also carries the
platform and the secondary lines (online, render, seg, stereo); stage
detail goes to stderr.

On an accelerator every line must produce a number: a failing secondary
line raises and the process exits non-zero.  On the CPU (the test
suite's contract run) a failing secondary line prints null instead.
"""

import json
import os
import sys
import time

import numpy as np



def make_orbit_frames(n_frames, w, h, K):
    """Synthetic room scene: a sphere + floor + back wall, camera orbit."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from scenes import checker_rgb, look_at, render_sphere, render_wall

    frames = []
    rgb = checker_rgb(w, h)
    for i in range(n_frames):
        ang = 0.25 * np.sin(2 * np.pi * i / n_frames)
        eye = (np.sin(ang) * 1.9 + 0.013, -0.021 + 0.03 * np.sin(i * 0.4), -1.9 * np.cos(ang) + 1.0)
        pose = look_at(eye, (0.013, -0.021, 1.007))
        d_sphere = render_sphere(w, h, K, pose, center=(0.013, -0.021, 1.007), radius=0.413)
        d_wall = render_wall(w, h, K, pose, wall_z=2.213)
        depth = np.where(d_sphere > 0, d_sphere, d_wall).astype(np.float32)
        ht = (0.5 + 0.4 * (d_sphere > 0)).astype(np.float32)
        lt = (1.0 - ht).astype(np.float32)
        frames.append((pose.astype(np.float32), rgb, depth, ht, lt))
    return frames


def load_replay_frames(n_frames, w, h):
    """Load the checked-in logged replay (datasets/orbit_vga — the
    record/replay layout of examples/tsdf/offline.cc:45-83, produced by
    scripts/make_replay_dataset.py) if it matches the requested shape.
    Returns bench frame tuples or None.  Replaying the recorded u16
    PNGs (TUM depth_factor 5000) keeps the benchmark workload identical
    across rounds and machines, like the reference's offline replay."""
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "datasets", "orbit_vga")
    if not os.path.exists(os.path.join(logdir, "trajectory.txt")):
        return None
    try:
        from disinfect_slam.io.dataset import LoggedReplay

        replay = LoggedReplay(logdir, depth_factor=5000.0)
        if len(replay) < n_frames:
            return None
        frames = []
        for frame in replay:
            if frame.depth.shape != (h, w):
                return None
            frames.append((
                np.asarray(frame.cam_T_world, np.float32),
                np.asarray(frame.rgb, np.float32),
                np.asarray(frame.depth, np.float32),
                np.asarray(frame.ht, np.float32),
                np.asarray(frame.lt, np.float32),
            ))
            if len(frames) == n_frames:
                break
        return frames
    except Exception as e:  # fail open to the in-memory generator
        print(f"[bench] replay dataset unreadable ({e}); generating",
              file=sys.stderr)
        return None


def load_tum_frames(n_frames, w, h):
    """TUM-RGBD auto-detect: if the north-star benchmark
    sequence (configs/tum_rgbd_1.yaml) is ever placed on this machine —
    DSTPU_TUM_DIR, or any TUM-layout directory (rgb.txt + depth.txt +
    groundtruth.txt) under datasets/ — the bench replays IT instead of
    the recorded orbit, and the JSON `dataset` field records which ran.
    Returns (frames, name) or None.  ht/lt are neutral (0/1): TUM has no
    disinfection masks; the geometry+color workload is what the parity
    target needs."""
    import glob

    cands = []
    env = os.environ.get("DSTPU_TUM_DIR")
    if env:
        cands.append(env)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datasets")
    cands += sorted(
        os.path.dirname(p) for p in glob.glob(os.path.join(root, "*", "rgb.txt"))
    )
    for seqdir in cands:
        if not all(
            os.path.exists(os.path.join(seqdir, f))
            for f in ("rgb.txt", "depth.txt", "groundtruth.txt")
        ):
            continue
        try:
            from disinfect_slam.io.dataset import TUMReplay

            replay = TUMReplay(seqdir, depth_factor=5000.0)
            frames = []
            for frame in replay:
                if frame.depth.shape != (h, w):
                    break
                frames.append((
                    np.asarray(frame.cam_T_world, np.float32),
                    np.asarray(frame.rgb, np.float32),
                    np.asarray(frame.depth, np.float32),
                    np.asarray(frame.ht, np.float32),
                    np.asarray(frame.lt, np.float32),
                ))
                if len(frames) == n_frames:
                    return frames, os.path.basename(seqdir.rstrip("/"))
            if len(frames) >= max(10, n_frames // 2):
                return frames, os.path.basename(seqdir.rstrip("/"))
        except Exception as e:  # fail open to the recorded orbit
            print(f"[bench] TUM dir {seqdir} unreadable ({e})", file=sys.stderr)
    return None


def main():
    import jax

    from disinfect_slam.utils import cache as _cache

    _cache.enable()

    import jax.numpy as jnp

    from disinfect_slam.config import TSDFConfig
    from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam.core.state import TSDFVolume
    from disinfect_slam.ops.integrate import FrameInput, integrate
    from disinfect_slam.ops.raycast import raycast

    platform = jax.devices()[0].platform
    on_accel = platform not in ("cpu",)

    def secondary(name, fn):
        """Run one secondary bench line: on an accelerator a failure is
        fatal; on the CPU it reads NaN (printed as null)."""
        try:
            return fn()
        except Exception as e:
            if on_accel:
                raise
            print(f"[bench] {name} line failed: {e}", file=sys.stderr)
            return float("nan")

    w, h = (640, 480) if on_accel else (160, 120)
    K = (525.1, 525.3, 319.6, 239.7) if on_accel else (131.3, 131.3, 79.9, 59.9)
    n_frames = int(
        os.environ.get("DSTPU_BENCH_FRAMES", "60" if on_accel else "6")
    )

    # north-star config: 4 mm voxels (BASELINE.md).  Pool capacity 2^18
    # blocks = 134M voxels matches the reference exactly
    # (voxel_mem.cuh:11-20) at 12 B/voxel (1.61 GB of payload).
    # Allocation is lossless: every pixel's DDA, every frame
    # (alloc_stride=1, alloc_every=1).
    cfg = TSDFConfig(
        voxel_size=0.004,
        truncation=0.024,
        num_buckets_log2=19 if on_accel else 14,
        num_blocks_log2=18 if on_accel else 12,
        max_candidates=32768 if on_accel else 8192,
        max_visible=32768 if on_accel else 4096,
        max_new_per_round=8192 if on_accel else 2048,
        max_probe=16,
    )
    max_depth = 4.0

    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, h, w)
    # pose conversion happens INSIDE the jit: per-frame host work must be
    # one dispatch, not dozens of eager ops over the device link
    step = jax.jit(
        lambda v, f, m: integrate(v, f, cam, SE3.from_matrix(m), max_depth),
        donate_argnums=0,
    )
    rc = jax.jit(lambda v, m: raycast(v, cam, SE3.from_matrix(m), max_depth))

    # dataset preference: real TUM sequence if present >
    # checked-in recorded replay > in-memory generator
    tum = load_tum_frames(n_frames, w, h) if on_accel else None
    if tum is not None:
        frames, tum_name = tum
        n_frames = len(frames)
        dataset = f"TUM {tum_name} (auto-detected local sequence)"
    else:
        frames = load_replay_frames(n_frames, w, h)
        dataset = "orbit_vga (checked-in logged replay; TUM rgbd_1 unavailable: no egress)"
        if frames is None:
            frames = make_orbit_frames(n_frames, w, h, K)
            dataset = "synthetic-orbit (TUM rgbd_1 unavailable: no egress)"

    def stage(f):
        pose, rgb, depth, ht, lt = f
        return (
            FrameInput(
                rgb=jax.device_put(rgb),
                depth=jax.device_put(depth),
                ht=jax.device_put(ht),
                lt=jax.device_put(lt),
            ),
            jax.device_put(pose),
        )

    staged = [stage(f) for f in frames]

    # warmup / compile into a THROWAWAY volume, then reset: the timed
    # loop must replay every frame exactly once so the final volume
    # matches a real run
    vol = TSDFVolume.create(cfg)
    vol = step(vol, *staged[0])
    jax.block_until_ready(vol.tsdf)
    vol = TSDFVolume.create(cfg)
    jax.block_until_ready(vol.tsdf)

    profile_dir = os.environ.get("DSTPU_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    t0 = time.perf_counter()
    for fr, pose in staged:
        vol = step(vol, fr, pose)
    jax.block_until_ready(vol.tsdf)
    dt = time.perf_counter() - t0
    if profile_dir:
        jax.profiler.stop_trace()
        print(f"[bench] profile trace -> {profile_dir}", file=sys.stderr)
    fps = len(frames) / dt

    from disinfect_slam.ops.render_fast import splat_render

    def _render_ms(fn):
        r = fn(vol, staged[0][1])
        jax.block_until_ready(r.rgba)
        t0 = time.perf_counter()
        for i in range(5):
            r = fn(vol, staged[i % len(staged)][1])
        jax.block_until_ready(r.rgba)
        return (time.perf_counter() - t0) / 5 * 1e3

    sp = jax.jit(lambda v, m: splat_render(v, cam, SE3.from_matrix(m), max_depth))
    splat_ms = secondary("splat", lambda: _render_ms(sp))
    ray_ms = float("nan")
    if os.environ.get("DSTPU_BENCH_RAYCAST", "1") == "1":
        ray_ms = secondary("raycast", lambda: _render_ms(rc))

    # honest online metric: rgb+depth+pose from HOST numpy each frame
    # (H2D included), seg forward + fusion as ONE jitted dispatch
    # (systems/online_step.py) — the 30 Hz contract the reference's
    # online path targets (examples/tsdf/online.cc:23-70).  Frames are
    # in sensor format (u8 rgb + u16 depth counts, the L515 delivery
    # format l515.cc:9-13): 3.3x fewer H2D bytes than f32.
    host_frames = [
        (
            np.clip(f[1], 0, 255).astype(np.uint8),
            np.clip(f[2] * 5000.0, 0, 65535).astype(np.uint16),
            f[0],
        )
        for f in frames[: min(30, len(frames))]
    ]  # (rgb, depth, pose) numpy
    from disinfect_slam.models.segmentation import (
        InferenceEngine,
        create_model,
        load_default_params,
    )
    from disinfect_slam.systems.online_step import FusedOnlineStep

    def _online_fps(arch):
        online = FusedOnlineStep(
            cfg, K, h, w, max_depth,
            seg_model=create_model(arch=arch),
            seg_params=load_default_params(arch=arch),
            depth_factor=5000.0,
        )
        online.step(*host_frames[0])  # compile
        online.block_until_ready()
        t0 = time.perf_counter()
        for rgb_f, depth_f, pose_f in host_frames[1:]:
            online.step(rgb_f, depth_f, pose_f)
        online.block_until_ready()
        fps_ = (len(host_frames) - 1) / (time.perf_counter() - t0)
        print(f"[bench] online[{arch}] (H2D + seg + fuse, 1 dispatch/frame): "
              f"{fps_:.2f} FPS", file=sys.stderr)
        return fps_

    online_fps = secondary("online", lambda: _online_fps("unet"))
    online_fps_fast = float("nan")
    if on_accel:  # the CPU contract run skips the second seg arch
        online_fps_fast = secondary("online[fast]", lambda: _online_fps("fast"))

    # segmentation inference micro-bench (the reference's
    # examples/segmentation_inference/main.cc measures ms/image)
    seg_iters = int(os.environ.get("DSTPU_BENCH_SEG_ITERS", "10"))

    def _seg_ms():
        eng = InferenceEngine(create_model(), load_default_params())
        rgb_u8 = np.ascontiguousarray(frames[0][1]).astype(np.uint8)
        eng.infer_one(rgb_u8)  # compile
        t0 = time.perf_counter()
        for _ in range(seg_iters):
            eng.infer_one(rgb_u8)
        ms = (time.perf_counter() - t0) / seg_iters * 1e3
        # device-only time (input pre-staged, output chained into the
        # next input): network compute without the host transfers
        staged_img = jax.device_put(jnp.asarray(rgb_u8, jnp.float32))

        @jax.jit
        def _seg_step(img):
            probs = eng._forward(eng.params, img)
            return img + jnp.sum(probs) * 0.0, probs

        staged_img, probs = _seg_step(staged_img)
        jax.block_until_ready(probs)
        t0 = time.perf_counter()
        for _ in range(seg_iters):
            staged_img, probs = _seg_step(staged_img)
        jax.block_until_ready(probs)
        dev_ms = (time.perf_counter() - t0) / seg_iters * 1e3
        print(f"[bench] seg device-only {dev_ms:.2f} ms "
              f"(end-to-end {ms:.2f} incl transfer)", file=sys.stderr)
        return ms

    seg_ms = secondary("seg", _seg_ms)

    # stereo block-matching micro-bench: <= 33 ms at 64 disparities VGA
    # is the rate a ZED-native 30-60 FPS stereo stream needs
    # (cameras/zed_native.cc:24-33).  Each iteration's output feeds the
    # next input, so the loop cannot be collapsed.
    def _stereo_ms():
        from disinfect_slam.ops.stereo import block_match

        sl = np.ascontiguousarray(frames[0][1]).astype(np.float32).mean(axis=-1)
        sr = np.roll(sl, -13, axis=1)
        sl_d, sr_d = jax.device_put(sl), jax.device_put(sr)

        @jax.jit
        def _stereo_step(l, r):
            disp, valid = block_match(l, r, max_disp=64)
            return l + (jnp.sum(disp) + jnp.sum(valid)) * 0.0, disp

        sl_d, disp = _stereo_step(sl_d, sr_d)
        jax.block_until_ready(disp)
        iters = int(os.environ.get("DSTPU_BENCH_STEREO_ITERS", "10"))
        t0 = time.perf_counter()
        for _ in range(iters):
            sl_d, disp = _stereo_step(sl_d, sr_d)
        jax.block_until_ready(disp)
        ms = (time.perf_counter() - t0) / iters * 1e3
        print(f"[bench] stereo block match (64 disp, {w}x{h}): "
              f"{ms:.2f} ms", file=sys.stderr)
        return ms

    stereo_ms = secondary("stereo", _stereo_ms)

    print(
        f"[bench] platform={platform} img={w}x{h} voxel={cfg.voxel_size} "
        f"frames={n_frames} active_blocks={int(vol.num_active_blocks)} "
        f"integrate_fps={fps:.2f} raycast_ms={ray_ms:.2f} splat_ms={splat_ms:.2f} "
        f"seg_ms={seg_ms:.2f}",
        file=sys.stderr,
    )

    def num(x, nd=2):
        return None if x != x else round(x, nd)

    # platform/device/img make every run self-describing: a CPU number
    # can never pose as an accelerator metric.
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "tsdf_fusion_fps",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 60.0, 3),
                "platform": platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "img": f"{w}x{h}",
                "voxel_m": cfg.voxel_size,
                "online_fps": num(online_fps),
                "online_fps_fast": num(online_fps_fast),
                "splat_ms": num(splat_ms),
                "raycast_ms": num(ray_ms),
                "seg_ms": num(seg_ms),
                "stereo_ms": num(stereo_ms),
                # the TUM rgbd_1 sequence is not available offline, so
                # the workload is the checked-in recorded replay (or its
                # in-memory generator) of the same resolution/depth
                # statistics
                "dataset": dataset,
            }
        )
    )


if __name__ == "__main__":
    main()
