"""Golden-parity tests of the integration pipeline vs the numpy oracle
(tests/oracle.py, a direct transcription of voxel_tsdf.cu semantics)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from disinfect_slam.config import TSDFConfig
from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops.integrate import FrameInput, integrate

from .oracle import OracleVolume, volume_metrics
from .scenes import checker_rgb, look_at, render_sphere, render_wall

# Small but non-trivial test configurations (both index backends).
CFG = TSDFConfig(
    voxel_size=0.05,
    truncation=0.15,
    num_buckets_log2=12,
    num_blocks_log2=10,
    max_probe=16,
    max_candidates=2048,
    max_visible=1024,
    max_new_per_round=512,
    insert_rounds=4,
    backend="hash",
)
CFG_DENSE = TSDFConfig(
    voxel_size=0.05,
    truncation=0.15,
    num_blocks_log2=10,
    max_candidates=2048,
    max_visible=1024,
    max_new_per_round=512,
    backend="dense",
    grid_log2=6,
)
CFG_DENSE_FILTER = dataclasses.replace(CFG_DENSE, alloc_dedup="filter")
BOTH = pytest.mark.parametrize(
    "cfg",
    [CFG, CFG_DENSE, CFG_DENSE_FILTER],
    ids=["hash", "dense", "dense-filter"],
)

W, H = 64, 48
# deliberately non-centered intrinsics + tilted scenes: keeps voxel
# projections away from exact half-pixel boundaries where f32-vs-f64
# rounding flips would make oracle comparison ill-posed
K = (52.7, 53.3, 31.71, 23.43)
MAX_DEPTH = 4.0
WALL_POSE = None  # set below


def make_frame(depth, rgb=None, ht=None, lt=None):
    if rgb is None:
        rgb = checker_rgb(W, H)
    if ht is None:
        ht = np.full((H, W), 0.5, np.float32)
    if lt is None:
        lt = np.full((H, W), 0.5, np.float32)
    return FrameInput(
        rgb=jnp.asarray(rgb),
        depth=jnp.asarray(depth),
        ht=jnp.asarray(ht),
        lt=jnp.asarray(lt),
    )


def run_ours(frames_poses, cfg=CFG):
    vol = TSDFVolume.create(cfg)
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH), donate_argnums=0)
    for frame, pose in frames_poses:
        vol = step(vol, frame, SE3.from_matrix(pose))
    return vol


def run_oracle(frames_poses, cfg=CFG):
    ovol = OracleVolume(cfg.voxel_size, cfg.truncation)
    for frame, pose in frames_poses:
        ovol.integrate(
            np.asarray(frame.rgb),
            np.asarray(frame.depth),
            np.asarray(frame.ht),
            np.asarray(frame.lt),
            MAX_DEPTH,
            K,
            pose,
        )
    return ovol


def compare(vol, ovol, tsdf_atol=2e-3):
    """Compare every voxel of every oracle block against the volume."""
    m = volume_metrics(vol, ovol)
    assert m["missing"] == 0, f"{m['missing']}/{m['oracle_blocks']} oracle blocks missing"
    # weights are integral -> must match exactly almost everywhere; a tiny
    # fraction of voxels may sample a different pixel when the projection
    # sits at an f32-vs-f64 rounding boundary
    assert m["w_mismatch"] < 0.005, f"weight mismatch rate {m['w_mismatch']}"
    assert m["tsdf_l1"] < tsdf_atol, f"tsdf L1 {m['tsdf_l1']}"
    assert m["rgb_flip"] < 0.005, f"rgb mismatch rate {m['rgb_flip']}"
    assert m["prob_l1"] < 1e-3, f"prob L1 {m['prob_l1']}"
    # no extra live blocks beyond the oracle's
    assert m["blocks"] == m["oracle_blocks"], (m["blocks"], m["oracle_blocks"])


@BOTH
def test_single_wall_frame_matches_oracle(cfg):
    pose = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    frames = [(make_frame(depth), pose)]
    vol = run_ours(frames, cfg)
    ovol = run_oracle(frames, cfg)
    assert len(ovol.blocks) > 10
    compare(vol, ovol)


@BOTH
def test_multi_frame_sphere_matches_oracle(cfg):
    frames = []
    for i, ang in enumerate([0.0, 0.15, -0.12]):
        eye = np.array([np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027, -2.5 * np.cos(ang) + 1.0])
        pose = look_at(eye, (0.013, -0.021, 1.007))
        depth = render_sphere(W, H, K, pose, center=(0.013, -0.021, 1.007), radius=0.613)
        ht = np.full((H, W), 0.7, np.float32)
        lt = np.full((H, W), 0.4, np.float32)
        frames.append((make_frame(depth, ht=ht, lt=lt), pose))
    vol = run_ours(frames, cfg)
    ovol = run_oracle(frames, cfg)
    assert len(ovol.blocks) > 10
    compare(vol, ovol)


@BOTH
def test_carving_removes_empty_blocks(cfg):
    """A wall moving away: blocks allocated in front of the old surface
    must be carved once fully observed as empty-ish (min |tsdf| >= 0.9)."""
    pose = look_at((0.021, -0.017, 0.009), (0.05, 0.08, 2.0))
    d1 = render_wall(W, H, K, pose, wall_z=1.0137)
    d2 = render_wall(W, H, K, pose, wall_z=3.0219)
    frames = [(make_frame(d1), pose)] + [(make_frame(d2), pose)] * 8
    vol = run_ours(frames, cfg)
    ovol = run_oracle(frames, cfg)
    compare(vol, ovol, tsdf_atol=5e-3)


def test_default_ht_lt_keeps_prob_half():
    """ht = lt = 1 (the TSDFSystem default for missing masks,
    tsdf_module.cc:32-33) must keep probability at 0.5."""
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    ones = np.ones((H, W), np.float32)
    frames = [(make_frame(depth, ht=ones, lt=ones), pose)] * 2
    vol = run_ours(frames)
    live = np.asarray(vol.entry_block) >= 0
    pool = np.asarray(vol.entry_block)[live]
    w = np.asarray(vol.weight)[pool]
    p = np.asarray(vol.prob)[pool]
    np.testing.assert_allclose(p[w > 0], 0.5, atol=1e-5)


def test_integrate_jit_stable_shapes():
    """Two frames with different content must reuse one compiled program."""
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    step = jax.jit(lambda v, f, p: integrate(v, f, cam, p, MAX_DEPTH), donate_argnums=0)
    vol = TSDFVolume.create(CFG)
    d1 = render_wall(W, H, K, pose, wall_z=2.0131)
    d2 = render_wall(W, H, K, pose, wall_z=2.5217)
    vol = step(vol, make_frame(d1), SE3.from_matrix(pose))
    vol = step(vol, make_frame(d2), SE3.from_matrix(pose))
    assert step._cache_size() == 1


def test_prob_eps_prevents_nan():
    """Extreme ht/lt drive prob to 0/1 and then NaN in reference
    semantics; prob_eps clamps it (opt-in)."""
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    zeros = np.zeros((H, W), np.float32)
    ones = np.ones((H, W), np.float32)
    frames = [(make_frame(depth, ht=zeros, lt=ones), pose)] * 3

    cfg = dataclasses.replace(CFG_DENSE, prob_eps=1e-6)
    vol = run_ours(frames, cfg)
    live = np.asarray(vol.entry_block) >= 0
    pool = np.asarray(vol.entry_block)[live]
    p = np.asarray(vol.prob)[pool]
    w = np.asarray(vol.weight)[pool]
    assert np.isfinite(p).all()
    assert (p[w > 0] >= 1e-6).all()


def test_alloc_tile_compaction_matches_sort_path():
    """The two-level (tile) candidate compaction engages on streams
    >= 2^17 keys; allocation + fusion must match the sort-dedup path
    voxel-for-voxel (up to pool ordering)."""
    import dataclasses

    from disinfect_slam.ops.gather import gather_valid

    w2, h2 = 304, 224  # 304*224*2 DDA steps = 136192 keys >= 2^17
    k2 = (250.0, 250.0, 151.5, 111.5)
    intr = CameraIntrinsics.create(*k2)
    cam2 = CameraParams.create(intr, h2, w2)
    pose_np = look_at((0.033, -0.041, 0.017), (0.11, 0.07, 2.0131))
    depth = render_sphere(
        w2, h2, k2, pose_np, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    frame = FrameInput(
        rgb=jnp.asarray(checker_rgb(w2, h2)),
        depth=jnp.asarray(depth),
        ht=jnp.full((h2, w2), 0.5, jnp.float32),
        lt=jnp.full((h2, w2), 0.5, jnp.float32),
    )

    outs = {}
    for dedup in ("sort", "filter"):
        cfg = dataclasses.replace(
            CFG_DENSE, max_candidates=8192, max_visible=8192,
            max_new_per_round=4096, grid_log2=6, alloc_dedup=dedup,
        )
        vol = TSDFVolume.create(cfg)
        step = jax.jit(
            lambda v, f, p: integrate(v, f, cam2, p, MAX_DEPTH),
            donate_argnums=0,
        )
        for _ in range(2):
            vol = step(vol, frame, SE3.from_matrix(pose_np))
        g = gather_valid(vol)
        m = np.asarray(g.mask)
        rows = np.concatenate(
            [np.asarray(g.position)[m],
             np.asarray(g.tsdf)[m][:, None],
             np.asarray(g.weight)[m][:, None],
             np.asarray(g.prob)[m][:, None]], axis=1)
        outs[dedup] = rows[np.lexsort(rows[:, :3].T[::-1])]

    # check the stream size really triggers the tile path
    assert w2 * h2 * 2 >= (1 << 17)
    assert outs["sort"].shape == outs["filter"].shape
    np.testing.assert_array_equal(outs["sort"], outs["filter"])


@BOTH
def test_visible_pool_indices_sorted_unique_invariant(cfg):
    """The fuse/splat/export gathers promise indices_are_sorted (dense)
    and the payload scatters promise unique_indices to XLA — wrong
    results on the GPU if the compaction ever stops delivering ascending
    (dense) / collision-free pool rows.  Pin the precondition here.

    Dense backend: entry i <-> pool slot i and compact_mask preserves
    entry order, so live pool_idx must be strictly increasing.  Both
    backends: live pool_idx must be duplicate-free."""
    from disinfect_slam.ops.integrate import gather_visible
    from disinfect_slam.ops.render_fast import _surf_visible

    pose_np = look_at((0.013, -0.027, -1.5), (0.013, -0.021, 1.007))
    depth = render_sphere(
        W, H, K, pose_np, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    frame = make_frame(depth)
    intr = CameraIntrinsics.create(*K)
    cam = CameraParams.create(intr, H, W)
    pose = SE3.from_matrix(pose_np)
    vol = TSDFVolume.create(cfg)
    for _ in range(2):
        vol = integrate(vol, frame, cam, pose, MAX_DEPTH)

    def check(vis, where):
        mask = np.asarray(vis.mask)
        pool = np.asarray(vis.pool_idx)[mask]
        assert len(pool) > 4, f"{where}: degenerate visible set"
        assert len(np.unique(pool)) == len(pool), f"{where}: duplicate pool rows"
        if cfg.backend == "dense":
            assert np.all(np.diff(pool) > 0), f"{where}: not ascending"

    check(gather_visible(vol, cam, pose), "gather_visible")
    vis_surf, _ = _surf_visible(vol, cam, pose, band=1.0, cap=256)
    check(vis_surf, "_surf_visible")


def test_scatter_window_placement_exact():
    """The windowed scatter must be a pure re-routing of the plain
    full-pool scatter: with the payload values as fixed INPUTS (no
    shared math for XLA to re-fuse per program), the windowed program,
    its in-program fallback branch, and the plain program must write
    bit-identical pools.  This is the miscompile detector for the
    dynamic_slice / windowed scatter / dynamic_update_slice lowering;
    cross-program equality of the fused VALUES is bounded (not pinned
    to zero) by test_scatter_window_matches_plain below."""
    import jax

    from disinfect_slam.core.state import TSDFVolume
    from disinfect_slam.ops.integrate import (
        VisibleSet,
        _scatter_payload_rows,
    )

    rng = np.random.default_rng(3)
    vcap, bv = CFG_DENSE.max_visible, CFG_DENSE.block_volume
    # live rows inside a 500-row span so the 2^9 window fits (pool 2^10)
    n_live = 493
    pool = np.sort(rng.choice(500, n_live, replace=False)).astype(np.int32)
    pool_full = np.concatenate(
        [pool, np.full(vcap - n_live, CFG_DENSE.num_blocks, np.int32)]
    )
    mask = np.arange(vcap) < n_live
    tsdf_w = rng.standard_normal((vcap, bv)).astype(np.float32)
    rgbw_w = rng.integers(0, 2 ** 32, (vcap, bv), dtype=np.uint32)
    prob_w = rng.random((vcap, bv)).astype(np.float32)

    def run(wlog2):
        cfg = dataclasses.replace(CFG_DENSE, scatter_window_log2=wlog2)
        vol = TSDFVolume.create(cfg)
        vis = VisibleSet(
            entry_idx=jnp.full((vcap,), cfg.num_entries, jnp.int32),
            block_pos=jnp.zeros((vcap, 3), jnp.int32),
            pool_idx=jnp.asarray(pool_full),
            mask=jnp.asarray(mask),
            count=jnp.int32(n_live),
        )
        out = jax.jit(_scatter_payload_rows)(
            vol, vis, jnp.asarray(tsdf_w), jnp.asarray(rgbw_w),
            jnp.asarray(prob_w),
        )
        return np.asarray(out.tsdf), np.asarray(out.rgbw), np.asarray(out.prob)

    plain = run(0)
    for wlog2 in (9, 4):  # windowed branch; fallback branch (span > 16)
        got = run(wlog2)
        for a, b in zip(plain, got):
            np.testing.assert_array_equal(a, b)


def test_scatter_window_matches_plain():
    """cfg.scatter_window_log2 routes the fuse payload write-backs
    through a dynamic window (O(window) scatter operand); the volume
    must come out equal to the plain full-pool scatter on BOTH the
    windowed branch (window covers the live span) and the in-program
    fallback (window too small -> full scatter).

    Discrete columns (position, integral weight) compare bit-exactly;
    tsdf/prob compare within a few-ulp bound: the fuse math is a SHARED
    subgraph of two DIFFERENT programs, and XLA compiles it per program
    shape — observed on XLA:CPU as a ~14-ulp division-lowering
    difference in 1 of 89k voxels, even with every operand fenced by
    optimization_barrier.  Placement exactness (the part the window
    machinery is responsible for) is pinned bit-exactly by
    test_scatter_window_placement_exact."""
    from disinfect_slam.ops.gather import gather_valid

    pose_a = look_at((0.013, -0.027, -1.5), (0.013, -0.021, 1.007))
    pose_b = look_at((0.35, 0.11, -1.4), (0.013, -0.021, 1.007))
    depth_a = render_sphere(
        W, H, K, pose_a, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    depth_b = render_sphere(
        W, H, K, pose_b, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    frames = [(make_frame(depth_a), pose_a), (make_frame(depth_b), pose_b)]

    def volume_rows(wlog2):
        cfg = dataclasses.replace(CFG_DENSE, scatter_window_log2=wlog2)
        g = gather_valid(run_ours(frames, cfg))
        m = np.asarray(g.mask)
        rows = np.concatenate(
            [np.asarray(g.position)[m],
             np.asarray(g.tsdf)[m][:, None],
             np.asarray(g.weight)[m][:, None],
             np.asarray(g.prob)[m][:, None]], axis=1)
        return rows[np.lexsort(rows[:, :3].T[::-1])]

    plain = volume_rows(0)
    assert plain.shape[0] > 64, "degenerate scene"
    # 9: windowed branch taken (2^9 = 512 rows covers every live row of
    # the 2^10 pool); 4: in-program fallback (16-row window cannot
    # cover the live span)
    for wlog2 in (9, 4):
        rows = volume_rows(wlog2)
        assert rows.shape == plain.shape
        np.testing.assert_array_equal(plain[:, :3], rows[:, :3])  # position
        np.testing.assert_array_equal(plain[:, 4], rows[:, 4])  # weight
        np.testing.assert_allclose(plain[:, 3], rows[:, 3], rtol=0, atol=2e-6)
        np.testing.assert_allclose(plain[:, 5], rows[:, 5], rtol=0, atol=2e-6)


def test_auto_scatter_window_resolution():
    """The plain full-pool scatter is the default on every platform
    (there is no trace-time "auto" rule); an explicit window passes
    through to the scatter program, and negative values are rejected."""
    from disinfect_slam.ops.integrate import VisibleSet, _scatter_payload_rows

    assert TSDFConfig().scatter_window_log2 == 0
    big = dataclasses.replace(CFG_DENSE, num_blocks_log2=18)
    assert big.scatter_window_log2 == 0
    with pytest.raises(AssertionError):
        dataclasses.replace(big, scatter_window_log2=-1).validate()

    def window_slices(wlog2):
        cfg = dataclasses.replace(CFG_DENSE, scatter_window_log2=wlog2)
        vcap, bv = cfg.max_visible, cfg.block_volume
        vol = jax.eval_shape(lambda: TSDFVolume.create(cfg))
        vis = VisibleSet(
            entry_idx=jnp.zeros((vcap,), jnp.int32),
            block_pos=jnp.zeros((vcap, 3), jnp.int32),
            pool_idx=jnp.zeros((vcap,), jnp.int32),
            mask=jnp.zeros((vcap,), bool),
            count=jnp.int32(0),
        )
        rows = jnp.zeros((vcap, bv), jnp.float32)
        text = str(jax.make_jaxpr(_scatter_payload_rows)(
            vol, vis, rows, rows.astype(jnp.uint32), rows
        ))
        return text.count(f"slice_sizes=({1 << wlog2}, {bv})")

    assert window_slices(0) == 0
    assert window_slices(9) == 3  # tsdf, rgbw, prob each sliced to 2^9 rows


def test_fuse_ladder_matches_monolithic():
    """cfg.fuse_ladder compiles the post-sampler fuse tail at L static
    sizes and cond-selects the smallest covering the live count; the
    volume must come out equal to the monolithic tail.  Same contract
    class as test_scatter_window_matches_plain: discrete columns
    bit-exact, tsdf/prob within the few-ulp cross-program-shape bound
    (the fuse math compiles per branch shape on XLA:CPU)."""
    from disinfect_slam.ops.gather import gather_valid

    pose_a = look_at((0.013, -0.027, -1.5), (0.013, -0.021, 1.007))
    pose_b = look_at((0.35, 0.11, -1.4), (0.013, -0.021, 1.007))
    depth_a = render_sphere(
        W, H, K, pose_a, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    depth_b = render_sphere(
        W, H, K, pose_b, center=(0.013, -0.021, 1.007), radius=0.613
    ).astype(np.float32)
    frames = [(make_frame(depth_a), pose_a), (make_frame(depth_b), pose_b)]

    def volume_rows(ladder, base_cfg=CFG_DENSE):
        cfg = dataclasses.replace(base_cfg, fuse_ladder=ladder)
        g = gather_valid(run_ours(frames, cfg))
        m = np.asarray(g.mask)
        rows = np.concatenate(
            [np.asarray(g.position)[m],
             np.asarray(g.tsdf)[m][:, None],
             np.asarray(g.weight)[m][:, None],
             np.asarray(g.prob)[m][:, None]], axis=1)
        return rows[np.lexsort(rows[:, :3].T[::-1])]

    plain = volume_rows(1)
    assert plain.shape[0] > 64, "degenerate scene"
    # 4: a coarse ladder; 8: finer ladder exercises a non-boundary
    # branch; also the hash backend (no sorted-prefix hints needed —
    # the ladder only relies on mask == arange < count)
    for ladder in (4, 8):
        rows = volume_rows(ladder)
        assert rows.shape == plain.shape
        np.testing.assert_array_equal(plain[:, :3], rows[:, :3])
        np.testing.assert_array_equal(plain[:, 4], rows[:, 4])
        np.testing.assert_allclose(plain[:, 3], rows[:, 3], rtol=0, atol=2e-6)
        np.testing.assert_allclose(plain[:, 5], rows[:, 5], rtol=0, atol=2e-6)
    hash_plain = volume_rows(1, CFG)
    hash_rows = volume_rows(4, CFG)
    assert hash_rows.shape == hash_plain.shape
    np.testing.assert_array_equal(hash_plain[:, :3], hash_rows[:, :3])
    np.testing.assert_allclose(hash_plain[:, 3], hash_rows[:, 3], rtol=0, atol=2e-6)
