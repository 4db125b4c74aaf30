"""Voxel export + bbox query + dump format tests (GatherValid /
GatherVoxels / VoxelSpatialTSDF parity, voxel_tsdf.cu:399-472)."""

import os

import numpy as np
import pytest

from disinfect_slam.ops.gather import (
    BoundingCube,
    dump_spatial_tsdf,
    gather_valid,
    gather_voxels,
    load_spatial_tsdf,
    to_numpy_records,
)

from .scenes import look_at, render_wall
from .test_integrate import H, K, W, make_frame
from .test_raycast import fuse_frames


@pytest.fixture(scope="module")
def fused():
    pose = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    vol, cam = fuse_frames([(make_frame(depth), pose)] * 2)
    return vol


def test_gather_valid_counts(fused):
    st = gather_valid(fused)
    n_blocks = int(fused.num_active_blocks)
    assert int(st.count) == n_blocks * fused.cfg.block_volume
    rec = to_numpy_records(st)
    assert rec.shape == (n_blocks * 512, 4)
    # positions laid out on the voxel grid
    assert np.allclose(rec[:, :3] / fused.cfg.voxel_size,
                       np.round(rec[:, :3] / fused.cfg.voxel_size), atol=1e-4)


def test_gather_voxels_bbox_subset(fused):
    full = to_numpy_records(gather_valid(fused))
    bbox = BoundingCube(-0.5, 0.5, -0.5, 0.5, 1.5, 2.5)
    sub = to_numpy_records(gather_voxels(fused, bbox))
    assert 0 < sub.shape[0] < full.shape[0]
    # every record inside the bbox (block-granular: the reference keeps
    # whole blocks fully inside the bound, check_bound_kernel)
    assert sub[:, 0].min() >= -0.5 - 1e-6 and sub[:, 0].max() <= 0.5 + 1e-6
    assert sub[:, 2].min() >= 1.5 - 1e-6 and sub[:, 2].max() <= 2.5 + 1e-6


def test_dump_roundtrip(tmp_path, fused):
    st = gather_valid(fused)
    path = os.path.join(tmp_path, "data.bin")
    n = dump_spatial_tsdf(st, path)
    back = load_spatial_tsdf(path)
    assert back.shape == (n, 4)
    rec = to_numpy_records(st)
    np.testing.assert_array_equal(back, rec)
    # binary layout: 16 bytes per record, little-endian f32 (x, y, z, tsdf)
    assert os.path.getsize(path) == n * 16


def test_surface_band_has_small_tsdf(fused):
    """Voxels near the wall surface must carry |tsdf| << 1."""
    rec = to_numpy_records(gather_valid(fused))
    near = np.abs(rec[:, 2] - 2.0131) < fused.cfg.voxel_size
    assert near.sum() > 50
    assert np.abs(rec[near, 3]).mean() < 0.3


def test_volume_from_records_roundtrip(fused):
    """Rebuilding a volume from dump records reproduces the records
    exactly (the TSDF2Mesh-role consumer, apps/tsdf2mesh.py)."""
    from disinfect_slam.ops.gather import (
        infer_voxel_size,
        volume_from_spatial_records,
    )

    rec = to_numpy_records(gather_valid(fused))
    # inference recovers the size up to f32 position quantization; the
    # exact-roundtrip check below passes the true size explicitly
    assert abs(infer_voxel_size(rec) - fused.cfg.voxel_size) < 1e-6
    vol2 = volume_from_spatial_records(rec, voxel_size=fused.cfg.voxel_size)
    assert int(vol2.num_active_blocks) == int(fused.num_active_blocks)
    rec2 = to_numpy_records(gather_valid(vol2))
    # same record set, block order may differ (hash layout vs original)
    a = rec[np.lexsort(rec[:, :3].T)]
    b = rec2[np.lexsort(rec2[:, :3].T)]
    np.testing.assert_array_equal(a, b)


def test_mesh_from_dump_records(fused):
    """Meshing the rebuilt volume puts vertices on the dumped surface."""
    from disinfect_slam.ops.gather import volume_from_spatial_records
    from disinfect_slam.ops.mesh import extract_mesh_chunked

    rec = to_numpy_records(gather_valid(fused))
    vol2 = volume_from_spatial_records(rec)
    tris = extract_mesh_chunked(vol2)
    assert tris.shape[0] > 100
    # the fused scene is a wall at z ~= 2.0131: vertices sit within one
    # voxel of the plane
    z = np.asarray(tris).reshape(-1, 3)[:, 2]
    assert np.abs(z - 2.0131).max() < 2 * fused.cfg.voxel_size
