#!/usr/bin/env python
"""Offline volume viewer: load a checkpoint and render orbit views.

The reference's interactive GLFW/ImGui viewer (modules/renderer_module)
has no display to attach to on a server host; this renders the same rgba +
normal-shaded views (and optionally a mesh) from an orbit of virtual
cameras into PNGs.

  python apps/view_volume.py --volume vol.npz --out views/ --frames 12
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--volume", required=True, help="checkpoint from io.checkpoint")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.0, help="orbit radius (0=auto)")
    ap.add_argument("--fx", type=float, default=525.0)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--renderer", choices=["splat", "raycast"], default="splat")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from disinfect_slam.utils.cache import enable as _cache

    _cache()

    import jax.numpy as jnp

    from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
    from disinfect_slam.io.checkpoint import load_volume
    from disinfect_slam.io.png_io import write_image
    from disinfect_slam.ops.raycast import raycast
    from disinfect_slam.ops.render_fast import splat_render
    from disinfect_slam.viz.headless import look_at

    vol = load_volume(args.volume)
    print(f"[view] volume: {int(vol.num_active_blocks)} blocks, "
          f"voxel {vol.cfg.voxel_size} m")

    # scene bounds from live blocks
    live = np.asarray(vol.entry_block) >= 0
    bp = np.asarray(vol.entry_pos)[live]
    centers = (bp * vol.cfg.block_len + vol.cfg.block_len / 2) * vol.cfg.voxel_size
    center = centers.mean(axis=0)
    extent = np.abs(centers - center).max()
    radius = args.radius or float(extent * 2.5 + 0.5)

    w, h = (int(x) for x in args.size.split("x"))
    cam = CameraParams.create(
        CameraIntrinsics.create(args.fx, args.fx, (w - 1) / 2, (h - 1) / 2), h, w
    )
    render = splat_render if args.renderer == "splat" else raycast
    fn = jax.jit(lambda v, m: render(v, cam, SE3.from_matrix(m), args.max_depth))

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        ang = 2 * np.pi * i / args.frames
        eye = center + np.array([np.sin(ang), -0.3, -np.cos(ang)]) * radius
        pose = look_at(eye, center)
        res = fn(vol, jnp.asarray(pose))
        write_image(os.path.join(args.out, f"orbit_{i:03d}_rgba.png"), np.asarray(res.rgba))
        write_image(
            os.path.join(args.out, f"orbit_{i:03d}_normal.png"), np.asarray(res.normal)
        )
        print(f"[view] frame {i}: hit {float(np.asarray(res.hit).mean()):.2%}")


if __name__ == "__main__":
    main()
