"""Scene-extent behavior: off-center grids, OOB truncation warning,
unbounded hash backend.

The reference's spatial hash maps unbounded block coordinates
(voxel_hash.cuh:13-25).  The dense backend here is bounded by
[grid_origin, grid_origin + grid_side), so (a) the grid must be
placeable off-center to cover a driven corridor, and (b) dropping
out-of-coverage candidates must warn loudly instead of silently
truncating the map (VERDICT r2 #4).
"""

import dataclasses
import logging

import numpy as np
import pytest

from disinfect_slam.config import TINY, TSDFConfig
from disinfect_slam.systems.tsdf_grid import TSDFGrid
from .scenes import checker_rgb, look_at, render_wall

W, H = 80, 60
K = (60.0, 60.0, 39.5, 29.5)
VOXEL, TRUNC = 0.05, 0.2  # block = 0.4 m


def _corridor_frames(n, spacing=0.5):
    """Camera marching +z, always looking at a wall 1.5 m ahead."""
    rgb = checker_rgb(W, H)
    out = []
    for i in range(n):
        z = i * spacing
        pose = look_at((0.0, 0.0, z), (0.0, 0.0, z + 2.0))
        depth = render_wall(W, H, K, pose, wall_z=z + 1.5)
        out.append((pose.astype(np.float32), rgb, depth))
    return out


def _drive(grid, frames):
    for pose, rgb, depth in frames:
        grid.integrate(rgb, depth, None, None, 4.0, K, pose)
    grid.block_until_ready()


def test_offset_grid_covers_corridor():
    """A 10 m corridor at 5 cm voxels outruns the centered 32-block
    (+/-6.4 m) grid; shifting grid_origin along +z covers it fully."""
    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
        grid_origin=(-16, -16, -4),  # z covers [-1.6 m, 11.2 m)
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    # walls out to z = 10.0; with +truncation overshoot the DDA stays
    # inside the grid's [-1.6, 11.2) z-extent
    frames = _corridor_frames(18, spacing=0.5)
    _drive(grid, frames)
    assert int(np.asarray(grid.volume.oob_count)) == 0
    st = grid.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    # the map must span (almost) the whole corridor of wall hits
    assert pos[:, 2].max() > 9.5
    assert pos[:, 2].min() < 2.0


def test_centered_grid_truncates_and_warns(caplog):
    """Same corridor on the centered grid: allocation past +6.4 m drops,
    oob_count goes nonzero, and TSDFGrid warns loudly (once)."""
    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    frames = _corridor_frames(20, spacing=0.5)
    with caplog.at_level(logging.WARNING, "disinfect_slam.tsdf_grid"):
        _drive(grid, frames)
        # watchdog polls every 30 frames; push past the next tick
        for _ in range(12):
            grid.integrate(frames[-1][1], frames[-1][2], None, None, 4.0,
                           K, frames[-1][0])
        grid.block_until_ready()
    assert int(np.asarray(grid.volume.oob_count)) > 0
    warnings = [r for r in caplog.records if "OUTSIDE the mapped extent" in r.message]
    assert len(warnings) == 1  # loud, and only once
    st = grid.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    assert pos[:, 2].max() < 6.8  # truncated at the grid boundary


def test_hash_backend_maps_beyond_any_grid():
    """The hash backend (reference-parity) has no grid bound: far
    coordinates within the packed coord range allocate fine."""
    cfg = dataclasses.replace(
        TINY, voxel_size=VOXEL, truncation=TRUNC, coord_bits=10,
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    # z = 40 m -> block z = 100: far outside any dense grid here
    pose = look_at((0.0, 0.0, 38.5), (0.0, 0.0, 40.5))
    depth = render_wall(W, H, K, pose, wall_z=40.0)
    grid.integrate(checker_rgb(W, H), depth, None, None, 4.0, K,
                   pose.astype(np.float32))
    grid.block_until_ready()
    assert int(np.asarray(grid.volume.oob_count)) == 0
    assert grid.num_active_blocks() > 0
    st = grid.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    assert abs(pos[:, 2].mean() - 40.0) < 1.0


def test_checkpoint_roundtrip_with_origin(tmp_path):
    from disinfect_slam.io.checkpoint import load_volume, save_volume

    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=10, max_candidates=2048, max_visible=512,
        max_new_per_round=512, backend="dense", grid_log2=5,
        grid_origin=(-16, -16, -4),
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    _drive(grid, _corridor_frames(2))
    p = str(tmp_path / "vol.npz")
    save_volume(p, grid.volume)
    vol2 = load_volume(p)
    assert vol2.cfg.grid_origin == (-16, -16, -4)
    np.testing.assert_array_equal(
        np.asarray(vol2.oob_count), np.asarray(grid.volume.oob_count)
    )
    np.testing.assert_array_equal(
        np.asarray(vol2.tsdf), np.asarray(grid.volume.tsdf)
    )


def test_recenter_follows_corridor():
    """Driving the corridor WITH recentering: the centered grid that
    test_centered_grid_truncates_and_warns proves truncates at +6.4 m
    keeps mapping when the window follows the camera (ops/hash.py
    recenter_dense via TSDFGrid.recenter)."""
    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    frames = _corridor_frames(20, spacing=0.5)
    moved = 0
    for pose, rgb, depth in frames:
        cam_pos = np.linalg.inv(pose)[:3, 3]
        moved += int(grid.recenter(cam_pos))
        grid.integrate(rgb, depth, None, None, 4.0, K, pose)
    grid.block_until_ready()
    assert moved >= 2  # the window actually chased the camera
    st = grid.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    # the final window is centered ~z=9.5: the wall out at 11 m mapped,
    # far behind the camera the blocks were released
    assert pos[:, 2].max() > 9.5


def test_recenter_preserves_kept_blocks_and_releases_dropped():
    """Recentering is a pure directory move: voxel payloads of kept
    blocks are bit-identical, dropped blocks return to the free list,
    and a recenter back is a no-op for still-covered content."""
    import dataclasses as dc

    import jax.numpy as jnp

    from disinfect_slam.ops.hash import lookup, recenter_dense

    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg)
    frames = _corridor_frames(6, spacing=0.5)
    _drive(grid, frames)
    vol0 = grid.snapshot()
    active0 = int(np.asarray(vol0.num_active_blocks))
    st0 = grid.gather_valid()
    rec0 = {
        tuple(p): t
        for p, t in zip(
            np.asarray(st0.position)[np.asarray(st0.mask)],
            np.asarray(st0.tsdf)[np.asarray(st0.mask)],
        )
    }

    # shift the window +8 blocks (+3.2 m) along z: near-camera blocks
    # (z < -1.6 m is empty; z in [-6.4, -3.2) drops out of coverage)
    vol1 = recenter_dense(vol0, (-16, -16, -8))
    # every block whose coord fits the new window must still look up
    live = np.asarray(vol1.entry_block) >= 0
    pos_live = np.asarray(vol1.entry_pos)[live]
    hit = np.asarray(lookup(vol1, jnp.asarray(pos_live)))
    assert (hit >= 0).all()
    # payloads untouched (same arrays, same pool rows)
    np.testing.assert_array_equal(np.asarray(vol1.tsdf), np.asarray(vol0.tsdf))
    dropped = active0 - int(np.asarray(vol1.num_active_blocks))
    assert dropped >= 0

    # gather through the moved window: every still-covered voxel
    # identical to before
    from disinfect_slam.ops import gather as gather_ops

    st1 = gather_ops.gather_valid(vol1)
    rec1 = {
        tuple(p): t
        for p, t in zip(
            np.asarray(st1.position)[np.asarray(st1.mask)],
            np.asarray(st1.tsdf)[np.asarray(st1.mask)],
        )
    }
    for p, t in rec1.items():
        assert p in rec0 and rec0[p] == t
    # and nothing in-window was lost
    g = vol1.cfg.grid_side
    org = vol1.cfg.grid_origin
    bs = cfg.block_len
    for p, t in rec0.items():
        bp = tuple(int(np.floor(c / bs)) for c in p)
        if all(org[i] <= bp[i] < org[i] + g for i in range(3)):
            assert p in rec1

    # same-origin recenter: exact no-op
    vol2 = recenter_dense(vol1, (-16, -16, -8))
    assert vol2 is vol1


def test_disinf_system_auto_recenter_corridor():
    """The facade path (DISINFSystem -> async TSDFSystem -> TSDFGrid)
    follows the robot with auto_recenter=True: the corridor that
    truncates at the centered window's +6.4 m maps to its far end."""
    from disinfect_slam.systems.disinf_system import DISINFSystem

    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    with DISINFSystem(
        K, depth_factor=1.0, voxel_size=VOXEL, truncation=TRUNC,
        max_depth=4.0, cfg=cfg, half_scale=False, auto_recenter=True,
    ) as sys_:
        for i, (pose, rgb, depth) in enumerate(_corridor_frames(20, 0.5)):
            ts = i * 100
            sys_.feed_pose(ts, pose)
            sys_.feed_rgbd_frame(rgb, depth, ts)
        sys_.tsdf.flush()
        st = sys_.tsdf.tsdf.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    assert pos[:, 2].max() > 9.5  # past the centered window's +6.4 m


def test_dense_slam_maybe_recenter():
    """DenseSLAM's own window follow: a tracked camera near the window
    edge triggers the directory move; payload arrays untouched."""
    import dataclasses as dc

    from .scenes import checker_rgb as _rgb
    from disinfect_slam.systems.dense_slam import DenseSLAM

    cfg = TSDFConfig(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    slam = DenseSLAM(K, H, W, voxel_size=VOXEL, truncation=TRUNC,
                     max_depth=4.0, cfg=cfg)
    rgb = _rgb(W, H)
    # centered start: camera at origin is >margin from every edge at
    # this window (32 blocks, margin = ceil(4.0/0.4) = 10)
    pose0, _, depth0 = _corridor_frames(1)[0]
    slam.process_frame(rgb, depth0)
    assert slam.maybe_recenter() is False
    # teleport the tracked pose near the +z edge (anchor pose moves the
    # SLAM world; simpler: fake the tracked pose directly)
    w_T_c = np.eye(4, dtype=np.float32)
    w_T_c[2, 3] = 4.0  # 10 blocks from center, window edge at 6.4 m
    slam.world_T_cam = w_T_c
    t0 = np.asarray(slam.volume.tsdf)
    assert slam.maybe_recenter() is True
    org = slam.volume.cfg.grid_origin
    assert org is not None and org[2] > -16
    np.testing.assert_array_equal(np.asarray(slam.volume.tsdf), t0)
