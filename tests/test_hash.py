"""Spatial hash + pool tests.

Port of the reference's unit-test domains (utils/tests/voxel_hash_test.cu,
voxel_mem_test.cu) to the batched functional design, plus the deliberate
collision fixture (voxel_hash_test.cu:128-180) re-expressed for the
claim-round mechanism.
"""

import jax
import jax.numpy as jnp
import numpy as np

from disinfect_slam.config import TINY, TSDFConfig
from disinfect_slam.core.state import (
    DEFAULT_PROB,
    DEFAULT_TSDF,
    EMPTY,
    RESET_PROB,
    RESET_TSDF,
    TSDFVolume,
)
from disinfect_slam.ops import hash as h


def mk(cfg=TINY):
    return TSDFVolume.create(cfg)


def ins(vol, coords):
    coords = jnp.asarray(coords, jnp.int32)
    valid = jnp.ones(coords.shape[0], bool)
    return h.insert(vol, coords, valid)


def test_hash_function_parity():
    """Hash must equal the reference's 3-prime XOR (voxel_hash.cu:31-35)."""
    cfg = TINY
    coords = np.array([[0, 0, 0], [1, 2, 3], [-1, -2, -3], [1000, -500, 77]], np.int32)
    got = np.asarray(h.hash_block(jnp.asarray(coords), cfg))
    for c, g in zip(coords, got):
        # uint32 wrapping arithmetic like the CUDA (uint) casts
        expect = (
            (np.uint32(np.int64(c[0]) * 73856093 & 0xFFFFFFFF))
            ^ (np.uint32(np.int64(c[1]) * 19349669 & 0xFFFFFFFF))
            ^ (np.uint32(np.int64(c[2]) * 83492791 & 0xFFFFFFFF))
        ) & np.uint32(cfg.bucket_mask)
        assert g == expect, (c, g, expect)


def test_insert_and_lookup_single():
    # voxel_hash_test.cu:56-92 analogue
    vol = mk()
    vol, dropped = ins(vol, [[1, 2, 3]])
    assert not bool(dropped[0])
    assert int(vol.num_active_blocks) == 1
    pool = h.lookup(vol, jnp.asarray([[1, 2, 3], [4, 5, 6]], jnp.int32))
    assert int(pool[0]) >= 0
    assert int(pool[1]) == EMPTY


def test_insert_idempotent():
    vol = mk()
    vol, _ = ins(vol, [[1, 2, 3]])
    p1 = int(h.lookup(vol, jnp.asarray([[1, 2, 3]], jnp.int32))[0])
    vol, dropped = ins(vol, [[1, 2, 3]])
    assert not bool(dropped[0])
    p2 = int(h.lookup(vol, jnp.asarray([[1, 2, 3]], jnp.int32))[0])
    assert p1 == p2
    assert int(vol.num_active_blocks) == 1


def test_duplicate_candidates_one_alloc():
    vol = mk()
    coords = [[7, 7, 7]] * 10
    vol, dropped = ins(vol, coords)
    assert int(vol.num_active_blocks) == 1
    assert not bool(jnp.any(dropped))


def test_batch_insert_128():
    # voxel_hash_test.cu:94-126 analogue.  Deep collision chains may drop
    # candidates within one insert (fail-open, like the reference's lock
    # losers, voxel_hash.cu:83-89); re-inserting must converge.
    vol = mk()
    rng = np.random.default_rng(0)
    coords = rng.integers(-100, 100, (128, 3)).astype(np.int32)
    coords = np.unique(coords, axis=0)
    for _ in range(5):
        vol, dropped = ins(vol, coords)
        if not bool(jnp.any(dropped)):
            break
    assert not bool(jnp.any(dropped))
    assert int(vol.num_active_blocks) == len(coords)
    pool = np.asarray(h.lookup(vol, jnp.asarray(coords)))
    assert (pool >= 0).all()
    assert len(np.unique(pool)) == len(coords)  # distinct pool blocks


def _colliding_coords(cfg, n, seed):
    """Find n distinct coords hashing to one bucket (vectorized)."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(-200, 200, (20000, 3)).astype(np.int32), axis=0)
    buckets = np.asarray(h.hash_block(jnp.asarray(coords), cfg))
    vals, counts = np.unique(buckets, return_counts=True)
    target = vals[np.argmax(counts)]
    assert counts.max() >= n
    return coords[buckets == target][:n]


def test_collision_resolution():
    """Three coords hashing to the same bucket must all land in ONE batch
    insert (the claim rounds replace the reference's 3-pass lock retry,
    voxel_hash_test.cu:128-180)."""
    cfg = TINY
    vol = mk(cfg)
    coords = _colliding_coords(cfg, 3, seed=1)
    vol, dropped = ins(vol, coords)
    assert not bool(jnp.any(dropped))
    pool = np.asarray(h.lookup(vol, jnp.asarray(coords)))
    assert (pool >= 0).all() and len(np.unique(pool)) == 3


def test_acquire_resets_payload():
    # voxel_mem_test.cu re-acquire-resets analogue (voxel_mem.cu:43-51)
    vol = mk()
    vol, _ = ins(vol, [[0, 0, 0]])
    pool = int(h.lookup(vol, jnp.asarray([[0, 0, 0]], jnp.int32))[0])
    assert float(vol.tsdf[pool, 0]) == RESET_TSDF
    assert float(vol.weight[pool, 0]) == 0.0
    assert float(vol.prob[pool, 0]) == RESET_PROB
    # dirty the payload, delete, re-insert -> reset again
    vol = vol.replace(tsdf=vol.tsdf.at[pool].set(0.123))
    entry = h.lookup_entry(vol, jnp.asarray([[0, 0, 0]], jnp.int32))
    vol = h.delete_entries(vol, entry, jnp.ones(1, bool))
    assert int(vol.num_active_blocks) == 0
    vol, _ = ins(vol, [[0, 0, 0]])
    pool2 = int(h.lookup(vol, jnp.asarray([[0, 0, 0]], jnp.int32))[0])
    assert float(vol.tsdf[pool2, 0]) == RESET_TSDF


def test_over_cap_insert_still_resets_every_block():
    """Regression: with more unique winners than max_new_per_round, the
    allocation must cap at the reset-buffer capacity — an uncapped winner
    would enter the pool with stale DEFAULT payload (prob=0), which the
    log-odds fusion turns into NaN on first touch."""
    import pytest

    from disinfect_slam.config import TINY_DENSE
    from disinfect_slam.utils.validate import validate_volume

    for cfg in (TINY, TINY_DENSE):
        n = cfg.max_new_per_round + 100  # > reset capacity, < pool size? no:
        # TINY pools hold 256 blocks == max_new_per_round; grow the pool so
        # the heap isn't the binding constraint
        import dataclasses

        cfg = dataclasses.replace(
            cfg, num_blocks_log2=10, max_candidates=1024,
            **({"num_buckets_log2": 11} if cfg.backend == "hash" else {}),
            **({"grid_log2": 6} if cfg.backend == "dense" else {}),
        )
        # coords must stay inside the dense grid extent (grid_log2=6 ->
        # [-32, 31]); spread over a 2-D patch
        ii = np.arange(n)
        coords = np.stack([ii % 32, ii // 32, np.zeros(n)], axis=1).astype(
            np.int32
        )
        vol = TSDFVolume.create(cfg)
        vol, dropped = h.insert(vol, jnp.asarray(coords), jnp.ones(n, bool))
        n_alloc = int(vol.num_active_blocks)
        n_drop = int(jnp.sum(dropped))
        rounds = cfg.insert_rounds if cfg.backend == "hash" else 1
        assert n_alloc <= cfg.max_new_per_round * rounds
        assert n_alloc + n_drop >= n  # nothing silently vanishes
        # every allocated block must carry RESET payload
        eb = np.asarray(vol.entry_block)
        alloc = eb[eb >= 0]
        assert (np.asarray(vol.tsdf[alloc]) == RESET_TSDF).all()
        assert (np.asarray(vol.prob[alloc]) == RESET_PROB).all()
        assert (np.asarray(vol.weight[alloc]) == 0.0).all()
        assert validate_volume(vol) == []


def test_delete_and_tombstone_probing():
    """Deleting an earlier entry must not break lookups of entries that
    probed past it (the tombstone analogue of list splicing)."""
    cfg = TINY
    vol = mk(cfg)
    # two coords colliding into the same bucket -> same probe chain
    a, b_ = _colliding_coords(cfg, 2, seed=2)
    vol, _ = ins(vol, np.stack([a, b_]))
    entry_a = h.lookup_entry(vol, jnp.asarray(a[None]))
    vol = h.delete_entries(vol, entry_a, jnp.ones(1, bool))
    # a gone, b still reachable
    assert int(h.lookup(vol, jnp.asarray(a[None]))[0]) == EMPTY
    assert int(h.lookup(vol, jnp.asarray(b_[None]))[0]) >= 0
    # tombstone slot is reusable
    vol, dropped = ins(vol, a[None])
    assert not bool(dropped[0])
    assert int(h.lookup(vol, jnp.asarray(a[None]))[0]) >= 0


def test_heap_exhaustion_drops():
    cfg = TSDFConfig(
        num_buckets_log2=8,
        num_blocks_log2=2,  # only 4 blocks
        max_probe=8,
        max_candidates=512,
        max_visible=16,
        max_new_per_round=16,
    )
    vol = mk(cfg)
    coords = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2)), -1).reshape(-1, 3)
    vol, dropped = ins(vol, coords.astype(np.int32))  # 8 candidates, 4 slots
    assert int(vol.num_active_blocks) == 4
    assert int(jnp.sum(dropped)) == 4
    assert int(vol.num_free) == 0


def test_read_voxels_defaults():
    vol = mk()
    t, rgb, w, p = h.read_voxels(vol, jnp.asarray([[5, 5, 5]], jnp.int32))
    assert float(t[0]) == DEFAULT_TSDF
    assert float(w[0]) == 0.0
    assert float(p[0]) == DEFAULT_PROB
    assert np.asarray(rgb[0]).tolist() == [0.0, 0.0, 0.0]


def test_trilinear_parity():
    """Trilinear TSDF must reproduce the reference's (quirky) corner
    weighting (voxel_hash.cu:173-200) on a known linear field."""
    vol = mk()
    # allocate blocks around origin and write tsdf = z coordinate / 8
    coords = np.array([[0, 0, 0]], np.int32)
    vol, _ = ins(vol, coords)
    pool = int(h.lookup(vol, jnp.asarray(coords))[0])
    # linear field: tsdf(x,y,z) = z * 0.1 over in-block voxels
    idx = np.arange(vol.cfg.block_volume)
    zz = (idx >> (2 * vol.cfg.block_len_log2)) & 7
    vol = vol.replace(tsdf=vol.tsdf.at[pool].set(jnp.asarray(zz * 0.1, jnp.float32)))

    # numpy oracle replicating the reference loop exactly
    def oracle(pt):
        pl = np.floor(pt)
        ph = pl + 1
        alpha = ph - pt
        tsdf = np.zeros(8)
        for i in range(8):
            corner = np.array(
                [
                    pl[0] if (i >> 2) & 1 else ph[0],
                    pl[1] if (i >> 1) & 1 else ph[1],
                    pl[2] if (i >> 0) & 1 else ph[2],
                ],
                np.int32,
            )
            inside = (corner >= 0).all() and (corner <= 7).all()
            tsdf[i] = corner[2] * 0.1 if inside else 1.0
        t00 = tsdf[0b000] * alpha[2] + tsdf[0b001] * (1 - alpha[2])
        t01 = tsdf[0b010] * alpha[2] + tsdf[0b011] * (1 - alpha[2])
        t10 = tsdf[0b100] * alpha[2] + tsdf[0b101] * (1 - alpha[2])
        t11 = tsdf[0b110] * alpha[2] + tsdf[0b111] * (1 - alpha[2])
        t0 = t00 * alpha[1] + t01 * (1 - alpha[1])
        t1 = t10 * alpha[1] + t11 * (1 - alpha[1])
        return t0 * alpha[0] + t1 * (1 - alpha[0])

    pts = np.array([[2.3, 3.7, 4.1], [1.0, 1.0, 1.0], [5.5, 2.25, 6.75]], np.float32)
    got = np.asarray(h.trilinear_tsdf(vol, jnp.asarray(pts)))
    want = np.array([oracle(p) for p in pts])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_insert_jit_compiles():
    vol = mk()

    @jax.jit
    def step(vol, coords):
        return h.insert(vol, coords, jnp.ones(coords.shape[0], bool))

    coords = jnp.asarray(np.random.default_rng(3).integers(-50, 50, (64, 3)), jnp.int32)
    vol2, dropped = step(vol, coords)
    assert int(vol2.num_active_blocks) > 0
