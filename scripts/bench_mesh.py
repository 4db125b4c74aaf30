#!/usr/bin/env python
"""Mesh-export wall-clock (target: full-volume OBJ in < 3 s).

Builds the bench-scale volume (30 replay frames, 4 mm voxels), then
times:
  1. extract_mesh_chunked f32 transfer
  2. extract_mesh_chunked q16 transfer
  3. full OBJ save (extract + merge_vertices + save_obj)
  4. a 2 m-bbox extraction at 5 Hz bridge cadence (the
     reconstTimerCallback workload, ros_offline.cc:320-350)

  python scripts/bench_mesh.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


from bench import load_replay_frames, make_orbit_frames  # noqa: E402
from disinfect_slam.config import TSDFConfig  # noqa: E402
from disinfect_slam.core.geometry import (  # noqa: E402
    SE3, CameraIntrinsics, CameraParams,
)
from disinfect_slam.core.state import TSDFVolume  # noqa: E402
from disinfect_slam.ops import integrate as I  # noqa: E402
from disinfect_slam.ops.mesh import (  # noqa: E402
    extract_mesh_chunked, merge_vertices, save_obj,
)

W, H = 640, 480
K = (525.1, 525.3, 319.6, 239.7)
MAX_DEPTH = 4.0
CFG = TSDFConfig(
    voxel_size=0.004, truncation=0.024,
    num_buckets_log2=19, num_blocks_log2=18,
    max_candidates=32768, max_visible=32768, max_new_per_round=8192,
)


def main():
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    frames = load_replay_frames(30, W, H) or make_orbit_frames(30, W, H, K)
    step = jax.jit(
        lambda v, f, m: I.integrate(v, f, cam, SE3.from_matrix(m), MAX_DEPTH),
        donate_argnums=0,
    )
    vol = TSDFVolume.create(CFG)
    print("populating volume (30 frames)...", flush=True)
    for f in frames:
        fr = I.FrameInput(rgb=jnp.asarray(f[1]), depth=jnp.asarray(f[2]),
                          ht=jnp.asarray(f[3]), lt=jnp.asarray(f[4]))
        vol = step(vol, fr, jnp.asarray(f[0]))
    jax.block_until_ready(vol.tsdf)
    print(f"active blocks: {int(vol.num_active_blocks)}", flush=True)

    # 1+2: chunked extraction, both transfer modes (first call compiles;
    # report the second, warm call — the bridge reuses the programs)
    for mode in ("f32", "q16"):
        tris = extract_mesh_chunked(vol, transfer=mode)  # warm/compile
        t0 = time.perf_counter()
        tris = extract_mesh_chunked(vol, transfer=mode)
        dt = time.perf_counter() - t0
        print(f"extract_mesh_chunked[{mode}]: {dt:.2f} s "
              f"({tris.shape[0]} tris)", flush=True)

    # 3: the full OBJ artifact (extract + weld + write)
    t0 = time.perf_counter()
    tris = extract_mesh_chunked(vol, transfer="q16")
    verts, faces = merge_vertices(tris, tol=CFG.voxel_size / 16.0)
    out = os.path.join(os.path.dirname(__file__), "..", ".bench_mesh.obj")
    save_obj(out, verts, faces)
    dt = time.perf_counter() - t0
    sz = os.path.getsize(out) / 1e6
    os.remove(out)
    print(f"full-volume OBJ: {dt:.2f} s ({len(verts)} verts, "
          f"{len(faces)} faces, {sz:.1f} MB)", flush=True)

    # 4: bridge cadence — 2 m bbox around the camera at 5 Hz
    from disinfect_slam.ops.gather import BoundingCube, gather_voxels

    # center the box 1.5 m ahead of the camera — an eye-centered box sits
    # in free space (the camera orbits OUTSIDE the geometry) and gathers
    # 0 voxels
    w2c = np.linalg.inv(frames[0][0])
    ctr = w2c[:3, 3] + w2c[:3, 2] * 1.5
    bbox = BoundingCube(ctr[0] - 1, ctr[0] + 1, ctr[1] - 1, ctr[1] + 1,
                        ctr[2] - 1, ctr[2] + 1)
    gq = jax.jit(lambda v: gather_voxels(v, bbox))
    st = gq(vol)
    jax.block_until_ready(st.tsdf)
    t0 = time.perf_counter()
    for _ in range(10):
        st = gq(vol)
        n = int(st.count)  # the bridge reads the count (host sync)
    dt = (time.perf_counter() - t0) / 10
    print(f"2 m-bbox query: {dt * 1e3:.1f} ms ({n} voxels) -> "
          f"{'OK for 5 Hz' if dt < 0.2 else 'TOO SLOW for 5 Hz'}",
          flush=True)


if __name__ == "__main__":
    main()
