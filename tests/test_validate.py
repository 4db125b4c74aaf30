"""Debug sanitizer pass: the validator accepts healthy volumes and
catches deliberately corrupted state (VERDICT round-1 item 8)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from disinfect_slam.core.geometry import SE3, CameraIntrinsics, CameraParams
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops.integrate import FrameInput, integrate
from disinfect_slam.utils.validate import (
    VolumeCorruptionError,
    validate_volume,
)

from .scenes import look_at, render_wall
from .test_integrate import CFG as CFG_HASH, CFG_DENSE, H, K, W


def _fused_volume(cfg):
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    depth = render_wall(W, H, K, pose, wall_z=2.0131)
    frame = FrameInput(
        rgb=jnp.full((H, W, 3), 120.0, jnp.float32),
        depth=jnp.asarray(depth),
        ht=jnp.full((H, W), 0.6, jnp.float32),
        lt=jnp.full((H, W), 0.4, jnp.float32),
    )
    vol = TSDFVolume.create(cfg)
    return integrate(vol, frame, cam, SE3.from_matrix(jnp.asarray(pose)), 4.0)


@pytest.mark.parametrize("cfg", [CFG_DENSE, CFG_HASH], ids=["dense", "hash"])
def test_healthy_volume_validates(cfg):
    vol = _fused_volume(cfg)
    assert int(vol.num_active_blocks) > 10
    assert validate_volume(vol) == []


def test_detects_bad_free_counter():
    vol = _fused_volume(CFG_DENSE)
    bad = dataclasses.replace(vol, num_free=jnp.asarray(-3, jnp.int32))
    errs = validate_volume(bad, strict=False)
    assert any(e.startswith("H1") for e in errs)
    with pytest.raises(VolumeCorruptionError):
        validate_volume(bad)


def test_detects_double_allocation():
    vol = _fused_volume(CFG_DENSE)
    eb = np.asarray(vol.entry_block).copy()
    occ = np.flatnonzero(eb >= 0)
    eb[occ[1]] = eb[occ[0]]  # two entries claim the same pool block
    bad = dataclasses.replace(vol, entry_block=jnp.asarray(eb))
    errs = validate_volume(bad, strict=False)
    assert any(e.startswith("P1") or e.startswith("P2") for e in errs)


def test_detects_free_list_overlap():
    vol = _fused_volume(CFG_HASH)
    heap = np.asarray(vol.heap).copy()
    eb = np.asarray(vol.entry_block)
    allocated = eb[eb >= 0][0]
    heap[0] = allocated  # a block both free and allocated
    bad = dataclasses.replace(vol, heap=jnp.asarray(heap))
    errs = validate_volume(bad, strict=False)
    assert any(e.startswith("P2") or e.startswith("H2") for e in errs)


def test_detects_payload_corruption():
    vol = _fused_volume(CFG_DENSE)
    eb = np.asarray(vol.entry_block)
    blk = int(eb[eb >= 0][0])
    tsdf = np.asarray(vol.tsdf).copy()
    tsdf[blk, 7] = np.nan
    bad = dataclasses.replace(vol, tsdf=jnp.asarray(tsdf))
    errs = validate_volume(bad, strict=False)
    assert any("non-finite tsdf" in e for e in errs)

    prob = np.asarray(vol.prob).copy()
    prob[blk, 3] = 1.5
    bad = dataclasses.replace(vol, prob=jnp.asarray(prob))
    errs = validate_volume(bad, strict=False)
    assert any("prob" in e for e in errs)


def test_weightless_update_keeps_prob_finite():
    """Regression: a voxel first touched at depth ~ max_depth gets
    w_new < 0.5 (stored weight rounds to 0) and, with ht=0, prob
    collapses to 0.  The next update must not produce NaN (the naive
    w*log(p) form gives 0*(-inf); C powf(0,0)==1 semantics required,
    voxel_tsdf.cu:196-202)."""
    cfg = CFG_DENSE
    cam = CameraParams.create(CameraIntrinsics.create(*K), H, W)
    pose = look_at((0.01, 0.02, -0.01), (0.04, -0.03, 2.0))
    # wall close to max_depth=4.0 so w_new = (1 - d/4)*4 < 0.5
    depth = render_wall(W, H, K, pose, wall_z=3.93)
    frame = FrameInput(
        rgb=jnp.full((H, W, 3), 120.0, jnp.float32),
        depth=jnp.asarray(depth),
        ht=jnp.zeros((H, W), jnp.float32),
        lt=jnp.ones((H, W), jnp.float32),
    )
    vol = TSDFVolume.create(cfg)
    se3 = SE3.from_matrix(jnp.asarray(pose))
    vol = integrate(vol, frame, cam, se3, 4.0)
    vol = integrate(vol, frame, cam, se3, 4.0)
    assert np.isfinite(np.asarray(vol.prob)).all()
    assert validate_volume(vol) == []


def test_detects_dense_table_incoherence():
    vol = _fused_volume(CFG_DENSE)
    table = np.asarray(vol.block_table).copy()
    resident = np.flatnonzero(table >= 0)
    table[resident[0]] = -1  # drop a resident block from the table
    bad = dataclasses.replace(vol, block_table=jnp.asarray(table))
    errs = validate_volume(bad, strict=False)
    assert any(e.startswith("D1") for e in errs)
