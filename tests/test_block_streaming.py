"""Host-RAM block streaming (systems/block_streaming.py): blocks evicted
by dense-window recentering spill to a host store and come back
voxel-for-voxel when the window returns — the reference's
reserved-but-unbuilt CPU streaming mode (voxel_mem.cuh:76-77)."""

import logging

import numpy as np

from disinfect_slam.config import TSDFConfig
from disinfect_slam.systems.tsdf_grid import TSDFGrid

from .scenes import checker_rgb, look_at, render_wall

W, H = 80, 60
K = (60.0, 60.0, 39.5, 29.5)
VOXEL, TRUNC = 0.05, 0.2  # block = 0.4 m


def _cfg(**kw):
    base = dict(
        voxel_size=VOXEL, truncation=TRUNC,
        num_blocks_log2=12, max_candidates=8192, max_visible=2048,
        max_new_per_round=1024, backend="dense", grid_log2=5,
    )
    base.update(kw)
    return TSDFConfig(**base)


def _fuse_wall(grid, wall_z=1.5, cam_z=0.0, n=2):
    rgb = checker_rgb(W, H)
    pose = look_at((0.0, 0.0, cam_z), (0.0, 0.0, cam_z + 2.0)).astype(
        np.float32
    )
    depth = render_wall(W, H, K, pose, wall_z=wall_z)
    for _ in range(n):
        grid.integrate(rgb, depth, None, None, 4.0, K, pose)
    grid.block_until_ready()
    return pose


def _rows(grid):
    st = grid.gather_valid()
    m = np.asarray(st.mask)
    rows = np.concatenate(
        [np.asarray(st.position)[m],
         np.asarray(st.tsdf)[m][:, None],
         np.asarray(st.weight)[m][:, None],
         np.asarray(st.prob)[m][:, None]], axis=1)
    return rows[np.lexsort(rows[:, :3].T[::-1])]


def test_spill_restore_roundtrip():
    """Recenter away (everything spills), recenter back (everything
    restores): the volume must be voxel-for-voxel what it was."""
    grid = TSDFGrid(VOXEL, TRUNC, cfg=_cfg(), host_spill=True)
    _fuse_wall(grid)
    before = _rows(grid)
    n_before = grid.num_active_blocks()
    assert n_before > 8

    # window to z in [1.6, 14.4) m: the wall band around z=1.5 leaves
    assert grid.recenter((0.0, 0.0, 8.0))
    assert len(grid.spill_store) > 0
    spilled = len(grid.spill_store)
    assert grid.num_active_blocks() == n_before - spilled

    # window back over the origin: everything returns
    assert grid.recenter((0.0, 0.0, 0.0))
    assert len(grid.spill_store) == 0
    assert grid.num_active_blocks() == n_before
    np.testing.assert_array_equal(before, _rows(grid))


def test_corridor_loop_keeps_map_only_with_spill():
    """Drive out past the window, come back: with host_spill the early
    corridor is still mapped; without it, recentering forgot it."""
    def run(host_spill):
        grid = TSDFGrid(VOXEL, TRUNC, cfg=_cfg(), host_spill=host_spill)
        # out: camera 0 -> 9 m, then back to 0, recentering as we go;
        # no new frames once heading back, so the far geometry can only
        # survive through the store
        rgb = checker_rgb(W, H)
        for z in np.arange(0.0, 9.5, 1.0):
            grid.recenter((0.0, 0.0, float(z)))
            pose = look_at((0.0, 0.0, z), (0.0, 0.0, z + 2.0)).astype(
                np.float32
            )
            depth = render_wall(W, H, K, pose, wall_z=z + 1.5)
            grid.integrate(rgb, depth, None, None, 4.0, K, pose)
        for z in np.arange(9.0, -0.1, -1.0):
            grid.recenter((0.0, 0.0, float(z)))
        grid.block_until_ready()
        # at z=0 the far geometry is off-device either way; drive back
        # out and see whether it comes back
        grid.recenter((0.0, 0.0, 9.0))
        st = grid.gather_valid()
        m = np.asarray(st.mask)
        return np.asarray(st.position)[m], np.asarray(st.weight)[m]

    pos_s, w_s = run(True)
    far_blocks_spill = (pos_s[:, 2] > 8.0).sum()
    # the z > 8 m geometry left the window on the way back and was
    # RESTORED from the host store on the final recenter
    assert far_blocks_spill > 0
    assert (w_s > 0).any()

    pos_n, _ = run(False)
    far_blocks_plain = (pos_n[:, 2] > 8.0).sum() if pos_n.size else 0
    # without the store, recentering released it for good
    assert far_blocks_plain == 0
    assert far_blocks_spill > far_blocks_plain


def test_restore_conflict_merges_not_clobbers():
    """A stored block whose coordinate is live on device again MERGES
    weight-proportionally; an unobserved stored copy (w=0) leaves the
    live payload bit-for-bit untouched."""
    grid = TSDFGrid(VOXEL, TRUNC, cfg=_cfg(), host_spill=True)
    _fuse_wall(grid)
    before = _rows(grid)
    live = np.asarray(grid.volume.entry_block) >= 0
    assert live.any()
    # block coord of some live entry; stored copy has weight 0 (the
    # rgbw word's top byte), so the merge must keep live bits verbatim
    coord = tuple(int(c) for c in np.asarray(grid.volume.entry_pos)[live][0])
    v = grid.cfg.block_volume
    grid.spill_store._store[coord] = (
        np.full((v,), 0.123, np.float32),
        np.full((v,), 7, np.uint32),
        np.full((v,), 0.9, np.float32),
    )
    vol, restored = grid.spill_store.restore_into_window(grid.volume)
    grid.volume = vol
    assert restored == 1  # the conflict was consumed (merged)
    assert len(grid.spill_store) == 0
    np.testing.assert_array_equal(before, _rows(grid))


def test_merge_rows_formulas():
    """_merge_rows mirrors the engine's weighted fusion: weights add
    (clamped), tsdf/rgb are weight-proportional, one-sided voxels pass
    through bit-exact."""
    from disinfect_slam.systems.block_streaming import _merge_rows

    def word(r, g, b, w):
        return np.uint32(r | (g << 8) | (b << 16) | (w << 24))

    t_l = np.array([[0.5, -0.25, 1.0, 0.125]], np.float32)
    c_l = np.array([[word(100, 50, 200, 4), word(10, 20, 30, 2),
                     word(0, 0, 0, 0), word(255, 255, 255, 38)]], np.uint32)
    p_l = np.array([[0.5, 0.25, 0.5, 0.75]], np.float32)
    t_s = np.array([[-0.5, 0.75, 0.5, 0.375]], np.float32)
    c_s = np.array([[word(50, 150, 100, 4), word(0, 0, 0, 0),
                     word(40, 60, 80, 8), word(1, 2, 3, 6)]], np.uint32)
    p_s = np.array([[0.5, 0.125, 0.25, 0.25]], np.float32)

    t, c, p = _merge_rows(t_l, c_l, p_l, t_s, c_s, p_s, max_weight=40.0)
    # voxel 0: equal weights -> midpoints; weight 4+4=8
    assert t[0, 0] == 0.0
    assert (c[0, 0] >> 24) == 8
    assert (c[0, 0] & 0xFF) == 75  # (100*4 + 50*4)/8
    # voxel 1: stored unobserved -> live bits verbatim
    assert t[0, 1] == t_l[0, 1] and c[0, 1] == c_l[0, 1] and p[0, 1] == p_l[0, 1]
    # voxel 2: live unobserved -> stored bits verbatim
    assert t[0, 2] == t_s[0, 2] and c[0, 2] == c_s[0, 2] and p[0, 2] == p_s[0, 2]
    # voxel 3: weight clamps at max_weight (38+6 -> 40)
    assert (c[0, 3] >> 24) == 40
    # prob fuses in log-odds space: equal-weight voxel 0 keeps 0.5
    assert abs(p[0, 0] - 0.5) < 1e-6


def test_store_npz_roundtrip(tmp_path):
    from disinfect_slam.systems.block_streaming import HostBlockStore

    grid = TSDFGrid(VOXEL, TRUNC, cfg=_cfg(), host_spill=True)
    _fuse_wall(grid)
    grid.recenter((0.0, 0.0, 8.0))
    assert len(grid.spill_store) > 0
    p = str(tmp_path / "store.npz")
    grid.spill_store.save_npz(p)
    loaded = HostBlockStore.load_npz(p)
    assert len(loaded) == len(grid.spill_store)
    for k, (t, c, pr) in grid.spill_store._store.items():
        t2, c2, p2 = loaded.payload(k)
        np.testing.assert_array_equal(t, t2)
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(pr, p2)


def test_dense_slam_recenter_spills_and_restores():
    """DenseSLAM(host_spill=True): maybe_recenter routes departing
    blocks through the store and brings them back when the tracked
    camera returns."""
    from disinfect_slam.systems.dense_slam import DenseSLAM

    cfg = _cfg(grid_log2=4)  # 16 blocks * 0.4 m: +-3.2 m window
    slam = DenseSLAM(
        K, H, W, voxel_size=VOXEL, truncation=TRUNC, cfg=cfg,
        host_spill=True,
    )
    rgb = checker_rgb(W, H)
    pose = look_at((0.0, 0.0, 0.0), (0.0, 0.0, 2.0)).astype(np.float32)
    depth = render_wall(W, H, K, pose, wall_z=1.5)
    slam.process_frame(rgb, depth)
    n0 = int(np.asarray(slam.volume.num_active_blocks))
    assert n0 > 4

    # teleport the tracked pose far +z: window follows, wall spills
    slam.world_T_cam = np.array(np.linalg.inv(
        look_at((0.0, 0.0, 6.0), (0.0, 0.0, 8.0))), np.float32)
    assert slam.maybe_recenter()
    assert len(slam.spill_store) > 0

    # and back: the wall restores voxel-for-voxel
    slam.world_T_cam = np.eye(4, dtype=np.float32)
    assert slam.maybe_recenter()
    assert len(slam.spill_store) == 0
    assert int(np.asarray(slam.volume.num_active_blocks)) == n0


def test_pool_pressure_paging_unbounded_drive():
    """A 128-block pool cannot hold a long sweep along a persistent
    wall.  The reference just stops allocating when the pool exhausts;
    with maybe_page the farthest blocks evict to host RAM, the sweep
    keeps mapping, and a revisit restores the start voxel-for-voxel."""
    def cfg_small():
        return TSDFConfig(
            voxel_size=VOXEL, truncation=TRUNC,
            num_buckets_log2=12, num_blocks_log2=7, max_probe=16,
            max_candidates=4096, max_visible=512, max_new_per_round=128,
            insert_rounds=4, backend="hash",
        )

    # camera sweeps +x along a FIXED wall at z=2 (persistent geometry:
    # mapped patches leave the frustum but are never observed empty, so
    # carving cannot recycle the pool)
    xs = np.arange(0.0, 8.5, 1.0)

    def drive(paging):
        grid = TSDFGrid(VOXEL, TRUNC, cfg=cfg_small(), host_spill=paging)
        rgb = checker_rgb(W, H)
        for x in xs:
            if paging:
                grid.maybe_page((float(x), 0.0, 0.0), radius_m=3.0)
            pose = look_at((x, 0.0, 0.0), (x, 0.0, 2.0)).astype(np.float32)
            depth = render_wall(W, H, K, pose, wall_z=2.0)
            grid.integrate(rgb, depth, None, None, 4.0, K, pose)
        grid.block_until_ready()
        return grid

    plain = drive(False)
    st = plain.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    # pool exhausted mid-sweep: the far end never allocated
    assert int(np.asarray(plain.volume.num_free)) == 0
    plain_max_x = pos[:, 0].max()
    assert plain_max_x < xs[-1]

    paged = drive(True)
    st = paged.gather_valid()
    pos = np.asarray(st.position)[np.asarray(st.mask)]
    # the far end IS mapped — eviction made room
    assert pos[:, 0].max() > plain_max_x
    assert len(paged.spill_store) > 0

    # snapshot what the store holds for the sweep start, then revisit
    start_keys = [k for k in paged.spill_store._store
                  if (k[0] * 8 + 4) * VOXEL < 2.0]
    assert start_keys, "sweep start should be in the store"
    # restore is nearest-first and row-capped: check the nearest key
    key = min(start_keys, key=lambda k: sum(((c * 8 + 4) * VOXEL) ** 2
                                            for c in k))
    stored_tsdf = paged.spill_store.payload(key)[0].copy()
    restored, evicted = paged.maybe_page((0.0, 0.0, 0.0), radius_m=3.0)
    assert restored > 0
    assert key not in paged.spill_store
    # the restored block's payload is bit-identical to what was evicted
    from disinfect_slam.ops.hash import lookup
    import jax.numpy as jnp

    row = int(np.asarray(lookup(
        paged.volume, jnp.asarray(np.array([key], np.int32))
    ))[0])
    assert row >= 0
    np.testing.assert_array_equal(
        stored_tsdf, np.asarray(paged.volume.tsdf[row])
    )


def test_store_spatial_records_match_device_dump():
    """spatial_records emits the same (x, y, z, tsdf) rows for spilled
    blocks as the device dump produced while they were live — so
    offline --save can append the host store and cover the whole map."""
    from disinfect_slam.ops.gather import gather_valid, to_numpy_records

    grid = TSDFGrid(VOXEL, TRUNC, cfg=_cfg(), host_spill=True)
    _fuse_wall(grid)
    before = to_numpy_records(gather_valid(grid.volume))
    n_blocks = grid.num_active_blocks()

    grid.recenter((0.0, 0.0, 8.0))  # spills the low-z part of the band
    assert 0 < len(grid.spill_store) < n_blocks
    rec = grid.spill_store.spatial_records(grid.cfg)
    assert rec.shape[0] == len(grid.spill_store) * grid.cfg.block_volume

    # restrict the pre-spill dump to the rows of spilled blocks
    blk = np.floor(
        np.round(before[:, :3] / VOXEL) / grid.cfg.block_len
    ).astype(int)
    spilled = np.array(
        [tuple(b) in grid.spill_store for b in blk]
    )
    expect = before[spilled]
    assert expect.shape == rec.shape

    def sort(a):
        return a[np.lexsort(a[:, :3].T[::-1])]

    np.testing.assert_array_equal(sort(expect), sort(rec))
