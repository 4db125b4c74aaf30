"""End-to-end pipeline: record -> replay -> fuse -> export -> resume.

The framework-level integration test the reference approximates with its
pseudo_online_capture + offline pair (SURVEY.md §4)."""

import numpy as np

from disinfect_slam.io.checkpoint import load_volume, save_volume
from disinfect_slam.io.dataset import LoggedReplay
from disinfect_slam.io.logger import FrameLogger
from disinfect_slam.ops.gather import (
    BoundingCube,
    dump_spatial_tsdf,
    load_spatial_tsdf,
)
from disinfect_slam.ops.mesh import extract_mesh_chunked, merge_vertices
from disinfect_slam.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_sphere, render_wall
from .test_integrate import CFG_DENSE, H, K, W

CENTER = (0.013, -0.021, 1.007)


def record_dataset(root, n=6):
    lg = FrameLogger(root, depth_factor=5000.0)
    rgb = checker_rgb(W, H).astype(np.uint8)
    for i, ang in enumerate(np.linspace(0, 0.5, n)):
        eye = (np.sin(ang) * 1.8 + 0.013, -0.021, -1.8 * np.cos(ang) + 1.007)
        pose = look_at(eye, CENTER)
        d = render_sphere(W, H, K, pose, center=CENTER, radius=0.413)
        d = np.where(d > 0, d, render_wall(W, H, K, pose, wall_z=2.213))
        lg.log_data((i, rgb, d.astype(np.float32), pose))
    lg.close()


def test_record_replay_fuse_export_resume(tmp_path):
    root = str(tmp_path / "ds")
    record_dataset(root)

    replay = LoggedReplay(root, depth_factor=5000.0)
    assert len(replay) == 6

    grid = TSDFGrid(0.05, 0.15, cfg=CFG_DENSE)
    for frame in replay:
        grid.integrate(
            frame.rgb, frame.depth, frame.ht, frame.lt, 4.0, K, frame.cam_T_world
        )
    grid.block_until_ready()
    n_blocks = grid.num_active_blocks()
    assert n_blocks > 30

    # voxel dump roundtrip (TSDF2Mesh consumer format)
    st = grid.gather_valid()
    dump = str(tmp_path / "data.bin")
    n_rec = dump_spatial_tsdf(st, dump)
    back = load_spatial_tsdf(dump)
    assert back.shape == (n_rec, 4) and n_rec == n_blocks * 512

    # bbox query stays within bounds
    sub = grid.gather_voxels(BoundingCube(-1, 1, -1, 1, 0.2, 2.0))
    assert 0 < int(sub.count) < n_rec

    # mesh has sphere + wall geometry
    tris = extract_mesh_chunked(grid.volume, chunk=64)
    verts, faces = merge_vertices(tris)
    assert len(verts) > 200
    r = np.linalg.norm(verts - np.asarray(CENTER), axis=-1)
    assert (np.abs(r - 0.413) < 0.08).sum() > 100  # sphere shell present
    assert (np.abs(verts[:, 2] - 2.213) < 0.08).sum() > 100  # wall present

    # checkpoint -> resume -> render works and volumes agree
    ckpt = str(tmp_path / "vol.npz")
    save_volume(ckpt, grid.volume)
    restored = load_volume(ckpt)
    np.testing.assert_array_equal(
        np.asarray(restored.tsdf), np.asarray(grid.volume.tsdf)
    )
    res = grid.ray_cast(4.0, (K, H, W), replay.entries[0][1], renderer="splat")
    assert float(np.asarray(res.hit).mean()) > 0.5
