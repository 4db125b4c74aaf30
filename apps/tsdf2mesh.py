"""Mesh a VoxelSpatialTSDF binary dump (the /tmp/data.bin artifact).

The reference dumps (x, y, z, tsdf) float32 records
(offline.cc:184-190, renderer_module.cc:90-101) and tells users to mesh
them with the external TSDF2Mesh tool (README.md:69, 91).  This makes
the framework self-contained: rebuild a volume from the dump and run
the marching-tetrahedra extractor.

    python apps/tsdf2mesh.py data.bin out.obj [--voxel 0.004]
        [--max-tris N] [--cpu]

The voxel size is inferred from record spacing when not given.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump", help="VoxelSpatialTSDF binary (from --save)")
    ap.add_argument("out", help="output mesh (.obj or .ply)")
    ap.add_argument(
        "--voxel", type=float, help="voxel size in metres (default: infer)"
    )
    ap.add_argument(
        "--max-tris",
        type=int,
        default=1 << 18,
        help="triangle capacity per extraction chunk",
    )
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--q16", action="store_true",
        help="uint16 fixed-point D2H (2x fewer bytes, max error 1/32 "
             "voxel), for links where the transfer dominates export "
             "time",
    )
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from disinfect_slam.ops.gather import (
        load_spatial_tsdf,
        volume_from_spatial_records,
    )
    from disinfect_slam.ops.mesh import (
        extract_mesh_chunked,
        merge_vertices,
        save_obj,
        save_ply,
        vertex_attributes,
    )

    rec = load_spatial_tsdf(args.dump)
    print(f"[tsdf2mesh] {rec.shape[0]} records from {args.dump}")
    vol = volume_from_spatial_records(rec, voxel_size=args.voxel)
    print(
        f"[tsdf2mesh] volume: {int(vol.num_active_blocks)} blocks, "
        f"voxel {vol.cfg.voxel_size*1000:.2f} mm"
    )
    tris = extract_mesh_chunked(
        vol, max_tris_per_chunk=args.max_tris,
        transfer="q16" if args.q16 else "f32",
    )
    verts, faces = merge_vertices(tris)
    if args.out.lower().endswith(".ply"):
        rgb, prob = vertex_attributes(vol, verts)
        save_ply(args.out, verts, faces, rgb=rgb, prob=prob)
    else:
        save_obj(args.out, verts, faces)
    print(f"[tsdf2mesh] {len(verts)} verts / {len(faces)} faces -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
