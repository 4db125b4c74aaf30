"""Per-frame TSDF integration as one functional, jit-compiled step.

JAX rework of TSDFGrid::Integrate (voxel_tsdf.cu:347-375) and its
kernel pipeline:

  reference (CUDA)                          here (XLA/JAX)
  ---------------------------------------   ---------------------------------
  block_allocate_kernel: per-pixel DDA +    candidate generation (vectorized
    per-thread locked hash Allocate           DDA) -> packed unique -> batched
    (voxel_tsdf.cu:104-147)                   lock-free insert (ops/hash.py)
  check_visibility_kernel over all           frustum mask over all entries
    entries (voxel_tsdf.cu:82-93)             (any-corner test)
  prefix_sum + gather_visible_blocks +       cumsum + drop-scatter compaction;
    D2H count + stream sync                   the count STAYS ON DEVICE (kills
    (voxel_tsdf.cu:456-472)                   the per-frame sync at :469)
  tsdf_integrate_kernel, 8^3 threads per     fused elementwise update over
    visible block (voxel_tsdf.cu:149-205)     [max_visible, 512] voxel rows
  space_carving_kernel min-reduce + Delete   row min + batched tombstone delete
    (voxel_tsdf.cu:207-230)

Fusion math is kept formula-identical for golden parity:
  sdf    = depth_to_range * (depth - z_cam)             (voxel_tsdf.cu:174)
  tsdf   = min(1, sdf / truncation)   if sdf > -trunc   (:175-176)
  w_new  = (1 - depth / max_depth) * 4                  (:182)
  tsdf' := (tsdf*w_old + tsdf_new*w_new) / (w_old+w_new)(:191)
  w'    := min(round(w_old + w_new), 40)                (:192)
  rgb'  := round((rgb*w_old + rgb_new*w_new) / w_c)     (:189-194)
  p'    := geometric-mean log-odds fusion of ht/lt      (:196-202)
  carve block if min |tsdf| >= 0.9 over its 512 voxels  (:207-230, :485)
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.geometry import SE3, CameraParams
from ..core.state import TSDFVolume
from . import hash as h


class FrameInput(NamedTuple):
    """One RGB-D(+semantics) frame staged for fusion.

    Mirrors TSDFSystemInput (modules/tsdf_module.h:16-30): missing ht/lt
    default to all-ones (tsdf_module.cc:32-33).
    """

    rgb: jnp.ndarray  # f32 [H, W, 3] in [0, 255]
    depth: jnp.ndarray  # f32 [H, W] metres (0 = invalid)
    ht: jnp.ndarray  # f32 [H, W] high-touch probability
    lt: jnp.ndarray  # f32 [H, W] low-touch probability


def _pow_log(x: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """log(x**e) with C powf edge semantics: e == 0 -> 0 (powf(0,0)==1),
    e > 0 with x == 0 -> -inf (powf(0,e)==0)."""
    return jnp.where(e == 0.0, 0.0, e * jnp.log(x))


def depth_to_range(cam: CameraParams) -> jnp.ndarray:
    """Per-pixel depth->range conversion factors [H, W].

    |K^-1 (u, v, 1)| as computed in block_allocate_kernel
    (voxel_tsdf.cu:117-120); constant per intrinsics so it is hoisted out
    of the per-frame path here instead of being rewritten every frame.
    """
    u = jnp.arange(cam.img_w, dtype=jnp.float32)
    v = jnp.arange(cam.img_h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)  # [H, W]
    ones = jnp.ones_like(uu)
    pos_cam = cam.intrinsics_inv.project(jnp.stack([uu, vv, ones], axis=-1))
    return jnp.linalg.norm(pos_cam, axis=-1)


def block_visibility(
    block_pos: jnp.ndarray,
    cam_T_world: SE3,
    cam: CameraParams,
    cfg: TSDFConfig,
    full: bool,
) -> jnp.ndarray:
    """is_block_visible<Full> (voxel_tsdf.cu:59-80) over block coords [..., 3].

    full=True: all 8 corners visible (allocation gate); full=False: any
    corner visible (per-frame visibility sweep).

    Computed SoA (component arrays end-to-end): this sweep runs over
    EVERY hash entry each frame, and component arrays keep it one fused
    elementwise pass with no [..., 3] intermediates.
    """
    base = vx.block_to_point(block_pos, cfg)
    bx = base[..., 0]
    by = base[..., 1]
    bz = base[..., 2]
    bl = cfg.block_len - 1
    vsz = cfg.voxel_size
    intr = cam.intrinsics
    acc = None
    for i in range(8):
        px = (bx + ((i >> 0) & 1) * bl).astype(jnp.float32) * vsz
        py = (by + ((i >> 1) & 1) * bl).astype(jnp.float32) * vsz
        pz = (bz + ((i >> 2) & 1) * bl).astype(jnp.float32) * vsz
        cxp, cyp, czp = cam_T_world.apply_xyz(px, py, pz)
        u = (intr.fx * cxp + intr.cx * czp) / czp
        v = (intr.fy * cyp + intr.cy * czp) / czp
        vis = (
            (u >= 0)
            & (u <= cam.img_w - 1)
            & (v >= 0)
            & (v <= cam.img_h - 1)
            & (czp >= 0)
        )
        if acc is None:
            acc = vis
        else:
            acc = (acc & vis) if full else (acc | vis)
    return acc


# ----------------------------------------------------------------------
# Stage 1: candidate block generation (block_allocate_kernel rework)
# ----------------------------------------------------------------------
def _dda_steps(cfg: TSDFConfig) -> int:
    """Static bound on per-pixel DDA samples: the ray spans 2*truncation,
    stepped in BLOCK_LEN-voxel units (voxel_tsdf.cu:136-138)."""
    return int(math.ceil(2.0 * cfg.truncation / (cfg.voxel_size * cfg.block_len))) + 1


def generate_candidates(
    frame_depth: jnp.ndarray,
    d2r: jnp.ndarray,
    cam: CameraParams,
    cam_T_world: SE3,
    world_T_cam: SE3,
    max_depth: float,
    cfg: TSDFConfig,
) -> jnp.ndarray:
    """Per-pixel DDA along the camera ray over [-trunc, +trunc] around the
    surface sample, emitting packed candidate block keys [H*W*S]
    (sentinel-keyed where invalid).  Mirrors voxel_tsdf.cu:104-147.

    cfg.alloc_stride subsamples the pixel grid (each sampled ray still
    emits its full DDA walk); see the coverage bound in config.py.

    The whole DDA runs SoA (x/y/z component arrays), with no stacked
    [H, W, 3] intermediates."""
    hgt, wid = frame_depth.shape
    s = cfg.alloc_stride
    if s > 1:
        frame_depth = frame_depth[::s, ::s]
        d2r = d2r[::s, ::s]
    u = jnp.arange(0, wid, s, dtype=jnp.float32)
    v = jnp.arange(0, hgt, s, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    # K^-1 (u, v, 1) components (back-projected dir at depth 1)
    ki = cam.intrinsics_inv
    dx = ki.fx * uu + ki.cx
    dy = ki.fy * vv + ki.cy

    depth = frame_depth
    valid = (depth > 0) & (depth <= max_depth)

    pwx, pwy, pwz = world_T_cam.apply_xyz(dx * depth, dy * depth, depth)
    inv_r = 1.0 / d2r
    rdx, rdy, rdz = world_T_cam.rotate_xyz(dx * inv_r, dy * inv_r, inv_r)
    tr = cfg.truncation
    inv_vs = 1.0 / cfg.voxel_size
    rsgx = (pwx - rdx * tr) * inv_vs
    rsgy = (pwy - rdy * tr) * inv_vs
    rsgz = (pwz - rdz * tr) * inv_vs
    k2 = 2.0 * tr * inv_vs
    rgx, rgy, rgz = rdx * k2, rdy * k2, rdz * k2

    # per-pixel step count (voxel_tsdf.cu:136-138)
    n_steps = jnp.ceil(
        jnp.maximum(jnp.maximum(jnp.abs(rgx), jnp.abs(rgy)), jnp.abs(rgz))
        / cfg.block_len
    ).astype(jnp.int32)
    nsf = jnp.maximum(n_steps.astype(jnp.float32), 1.0)
    svx, svy, svz = rgx / nsf, rgy / nsf, rgz / nsf

    s_max = _dda_steps(cfg)
    bl_log2 = cfg.block_len_log2
    cb = cfg.coord_bits
    off = 1 << (cb - 1)
    lo, hi = cfg.coord_min, cfg.coord_max
    keys = []
    oob = jnp.zeros((), jnp.int32)
    for i in range(s_max):
        bx = vx.round_half_away(rsgx + svx * float(i)).astype(jnp.int32) >> bl_log2
        by = vx.round_half_away(rsgy + svy * float(i)).astype(jnp.int32) >> bl_log2
        bz = vx.round_half_away(rsgz + svz * float(i)).astype(jnp.int32) >> bl_log2
        # NOTE: the full-visibility gate (is_block_visible<true>,
        # voxel_tsdf.cu:144) is applied AFTER dedup in allocate_blocks —
        # visibility depends only on the block coordinate, so checking
        # each unique candidate once is equivalent to the reference's
        # per-sample check and ~50x cheaper
        wanted = valid & (i <= n_steps)
        in_rng = (
            (bx >= lo) & (bx <= hi)
            & (by >= lo) & (by <= hi)
            & (bz >= lo) & (bz <= hi)
        )
        ok = wanted & in_rng
        # candidate samples beyond the packed coord range are dropped —
        # count them so the truncation is observable (the reference's
        # hash has no such bound, voxel_hash.cuh:13-25)
        oob = oob + jnp.sum((wanted & ~in_rng).astype(jnp.int32))
        key = jnp.where(
            ok,
            (bx + off) | ((by + off) << cb) | ((bz + off) << (2 * cb)),
            vx.sentinel_key(cfg),
        )
        keys.append(key.reshape(-1))
    return jnp.concatenate(keys), oob


def allocate_blocks(
    vol: TSDFVolume,
    frame_depth: jnp.ndarray,
    d2r: jnp.ndarray,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
) -> TSDFVolume:
    """Dedup candidates and batch-insert them (Allocate, voxel_tsdf.cu:377-386).

    Dedup before insert matters even for the dense backend: its
    scatter-max claim would handle duplicates, but then every one of the
    ~1M candidate keys becomes a scatter update.  A cheap neighbor
    filter first knocks out the raster-adjacent duplicates so the sort
    sees mostly-sentinel input.
    """
    cfg = vol.cfg
    world_T_cam = cam_T_world.inverse()
    with jax.named_scope("candidates"):
        keys, oob = generate_candidates(
            frame_depth, d2r, cam, cam_T_world, world_T_cam, max_depth, cfg
        )
    sent = vx.sentinel_key(cfg)
    # adjacent pixels along a raster row usually hit the same block:
    # pre-mask keys equal to their left neighbor (exact dedup is still
    # done downstream; this just thins the stream)
    left = jnp.concatenate([jnp.full((1,), -1, keys.dtype), keys[:-1]])
    keys = jnp.where(keys == left, sent, keys)

    if cfg.alloc_dedup == "filter" and cfg.backend == "dense":
        # presence filter: candidates whose cell is already allocated
        # need no insert; only genuinely-new keys (a few hundred per
        # frame at steady state) are compacted — no ~1M-key sort.
        # Unpack SoA (no [N, 3] stack over the full key stream).
        ks = jnp.where(keys < sent, keys, 0)
        cb = cfg.coord_bits
        koff = 1 << (cb - 1)
        kmask = (1 << cb) - 1
        cell, in_range = h.table_index_xyz(
            (ks & kmask) - koff,
            ((ks >> cb) & kmask) - koff,
            ((ks >> (2 * cb)) & kmask) - koff,
            cfg,
        )
        exists = vol.block_table[cell] >= 0
        # candidates beyond the dense grid extent are dropped: count
        # them (grid-truncation observability, see oob_count)
        oob = oob + jnp.sum(((keys < sent) & ~in_range).astype(jnp.int32))
        new = (keys < sent) & in_range & ~exists
        rank = jnp.cumsum(new.astype(jnp.int32)) - 1
        slot = jnp.where(new & (rank < cfg.max_candidates), rank, cfg.max_candidates)
        compact = (
            jnp.full((cfg.max_candidates,), sent, jnp.int32)
            .at[slot]
            .set(keys, mode="drop")
        )
        valid = compact < sent
        coords = vx.unpack_block_coord(jnp.where(valid, compact, 0), cfg)
        valid = valid & block_visibility(coords, cam_T_world, cam, cfg, full=True)
        # duplicates within the frame survive compaction; the dense
        # insert's scatter-max claim resolves them.  The insert is not
        # gated behind lax.cond(n_new > 0): the identity branch cannot
        # alias the donated pool buffers through the conditional, so XLA
        # would copy them, and carve/realloc churn keeps n_new > 0 on
        # most frames anyway.
        with jax.named_scope("insert"):
            vol, _dropped = h.insert(vol, coords, valid)
        return vol.replace(oob_count=vol.oob_count + oob)

    with jax.named_scope("unique"):
        uniq = jnp.unique(keys, size=cfg.max_candidates, fill_value=sent)
    valid = uniq < sent
    coords = vx.unpack_block_coord(uniq, cfg)
    if cfg.backend == "dense":
        _, in_range = h.table_index(coords, cfg)
        oob = oob + jnp.sum((valid & ~in_range).astype(jnp.int32))
    valid = valid & block_visibility(coords, cam_T_world, cam, cfg, full=True)
    with jax.named_scope("insert"):
        vol, _dropped = h.insert(vol, coords, valid)
    return vol.replace(oob_count=vol.oob_count + oob)


# ----------------------------------------------------------------------
# Stage 2: visibility sweep + on-device compaction (GatherVisible rework)
# ----------------------------------------------------------------------
class IntegrateStats(NamedTuple):
    """Per-frame device-scalar stats from integrate(return_stats=True)."""

    visible_count: jnp.ndarray  # i32 [] visible blocks this frame


class VisibleSet(NamedTuple):
    """Compacted visible blocks; count stays on device (no host sync)."""

    entry_idx: jnp.ndarray  # i32 [V] hash entry index (pad: num_entries)
    block_pos: jnp.ndarray  # i32 [V, 3]
    pool_idx: jnp.ndarray  # i32 [V] (pad: num_blocks)
    mask: jnp.ndarray  # bool [V]
    count: jnp.ndarray  # i32 []


def compact_mask(vol: TSDFVolume, mask: jnp.ndarray) -> VisibleSet:
    """Stream-compact masked entries into a fixed [max_visible] set.

    Replaces prefix_sum + gather_visible_blocks_kernel + the D2H count
    readback (voxel_tsdf.cu:456-472) with cumsum + drop-mode scatter.
    """
    cfg = vol.cfg
    vcap = cfg.max_visible
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = jnp.where(mask & (rank < vcap), rank, vcap)
    src = jnp.arange(cfg.num_entries, dtype=jnp.int32)
    entry_idx = (
        jnp.full((vcap,), cfg.num_entries, jnp.int32).at[slot].set(src, mode="drop")
    )
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), vcap)
    vmask = jnp.arange(vcap) < count
    safe = jnp.clip(entry_idx, 0, cfg.num_entries - 1)
    block_pos = jnp.where(vmask[:, None], vol.entry_pos[safe], 0)
    pool_idx = jnp.where(vmask, vol.entry_block[safe], cfg.num_blocks)
    return VisibleSet(entry_idx, block_pos, pool_idx, vmask, count)


def gather_visible(
    vol: TSDFVolume,
    cam: CameraParams,
    cam_T_world: SE3,
    frame_depth: jnp.ndarray | None = None,
    d2r: jnp.ndarray | None = None,
) -> VisibleSet:
    """check_visibility_kernel (voxel_tsdf.cu:82-93): any-corner frustum
    test over every live entry, then compaction.

    With cfg.cull_occluded and a depth frame, blocks provably occluded by
    nearer surface are dropped: if the maximum observed range over the
    block's screen bbox plus the truncation is still closer than the
    block's nearest corner, no voxel can pass sdf > -truncation, so the
    fusion outcome is unchanged while the working set shrinks.
    """
    cfg = vol.cfg
    live = vol.entry_block >= 0
    vis = block_visibility(vol.entry_pos, cam_T_world, cam, cfg, full=False)
    mask = live & vis
    if cfg.cull_occluded and frame_depth is not None and d2r is not None:
        mask = mask & ~_occluded_blocks(
            vol.entry_pos, cam, cam_T_world, frame_depth, d2r, cfg
        )
    return compact_mask(vol, mask)


def _occluded_blocks(
    block_pos: jnp.ndarray,
    cam: CameraParams,
    cam_T_world: SE3,
    frame_depth: jnp.ndarray,
    d2r: jnp.ndarray,
    cfg: TSDFConfig,
) -> jnp.ndarray:
    """Mask [E] of blocks whose entire screen region observes range
    strictly closer than (block nearest range - truncation)."""
    # observed range image, invalid depth -> +inf so it never culls
    rng_img = jnp.where(
        (frame_depth > 0), frame_depth * d2r, jnp.inf
    )
    hgt, wid = rng_img.shape
    # max-range mipmap pyramid (powers of two tiles)
    levels = []
    cur = rng_img
    tile = 1
    while tile < max(hgt, wid):
        ph = (-cur.shape[0]) % 2
        pw = (-cur.shape[1]) % 2
        cur = jnp.pad(cur, ((0, ph), (0, pw)), constant_values=-jnp.inf)
        cur = jnp.max(
            cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2), axis=(1, 3)
        )
        tile *= 2
        levels.append(cur)

    # project the 8 block corners
    base = vx.block_to_point(block_pos, cfg)
    bl = cfg.block_len - 1
    us, vs_, rngs, valid = [], [], [], None
    for i in range(8):
        corner = base + jnp.array(
            [(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1], jnp.int32
        ) * bl
        pos_cam = cam_T_world.apply(corner.astype(jnp.float32) * cfg.voxel_size)
        pih = cam.intrinsics.project(pos_cam)
        z = pih[..., 2]
        us.append(pih[..., 0] / z)
        vs_.append(pih[..., 1] / z)
        rngs.append(jnp.linalg.norm(pos_cam, axis=-1))
        v_ok = z > 0
        valid = v_ok if valid is None else (valid & v_ok)
    # grow the bbox by 1 px (voxels round to their nearest pixel) and
    # clamp into the image
    u_min = jnp.clip(jnp.min(jnp.stack(us), 0) - 1.0, 0.0, wid - 1.0)
    u_max = jnp.clip(jnp.max(jnp.stack(us), 0) + 1.0, 0.0, wid - 1.0)
    v_min = jnp.clip(jnp.min(jnp.stack(vs_), 0) - 1.0, 0.0, hgt - 1.0)
    v_max = jnp.clip(jnp.max(jnp.stack(vs_), 0) + 1.0, 0.0, hgt - 1.0)
    # nearest possible voxel range: corner min less the full block
    # diagonal (the interior minimum is not necessarily at a corner)
    diag = cfg.block_len * cfg.voxel_size * 1.7320508
    blk_near = jnp.min(jnp.stack(rngs), 0) - diag

    # pick the pyramid level where the bbox spans <= 2x2 tiles
    span = jnp.maximum(u_max - u_min, v_max - v_min)
    occluded = jnp.zeros(block_pos.shape[:-1], bool)
    chosen = jnp.full(block_pos.shape[:-1], -1, jnp.int32)
    region_max = jnp.full(block_pos.shape[:-1], jnp.inf)
    for li, lv in enumerate(levels):
        tile = 2 ** (li + 1)
        fits = (span <= tile) & (chosen < 0)
        lh, lw = lv.shape
        tu = jnp.clip((u_min / tile).astype(jnp.int32), 0, lw - 1)
        tv = jnp.clip((v_min / tile).astype(jnp.int32), 0, lh - 1)
        tu1 = jnp.clip(tu + 1, 0, lw - 1)
        tv1 = jnp.clip(tv + 1, 0, lh - 1)
        m = jnp.maximum(
            jnp.maximum(lv[tv, tu], lv[tv, tu1]),
            jnp.maximum(lv[tv1, tu], lv[tv1, tu1]),
        )
        region_max = jnp.where(fits, m, region_max)
        chosen = jnp.where(fits, li, chosen)
    occluded = valid & (region_max + cfg.truncation < blk_near)
    return occluded


# ----------------------------------------------------------------------
# Stage 3: fusion (tsdf_integrate_kernel rework)
# ----------------------------------------------------------------------
def fuse_visible(
    vol: TSDFVolume,
    vis: VisibleSet,
    frame: FrameInput,
    d2r: jnp.ndarray,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
):
    """Weighted running-average fusion over [max_visible, 512] voxels.

    Formula-identical to tsdf_integrate_kernel (voxel_tsdf.cu:149-205).
    Returns (volume, min|tsdf| per visible row) — the carve reduction is
    computed on the in-flight rows so carving never re-reads the pool.
    """
    cfg = vol.cfg
    vcap, bv = cfg.max_visible, cfg.block_volume

    # absolute voxel coords of every voxel in every visible block — as
    # SoA component planes [V, 512].  The packed [V, 512, 3] form made
    # XLA materialize ~200 MB intermediates per step: jnp.cross inside
    # the quaternion SE3.apply lowers to transposes on the 3-minor axis,
    # which break elementwise fusion.  Component planes fuse straight
    # into the consumers; the matrix-form rotation is the same
    # arithmetic the numpy oracle uses (tests/oracle.py:138).
    bl = cfg.block_len_log2
    lmask = cfg.block_len - 1
    vidx = jnp.arange(bv, dtype=jnp.int32)
    ox = (vidx & lmask)[None, :]
    oy = ((vidx >> bl) & lmask)[None, :]
    oz = ((vidx >> (2 * bl)) & lmask)[None, :]
    px = ((vis.block_pos[:, 0:1] << bl) + ox).astype(jnp.float32) * cfg.voxel_size
    py = ((vis.block_pos[:, 1:2] << bl) + oy).astype(jnp.float32) * cfg.voxel_size
    pz = ((vis.block_pos[:, 2:3] << bl) + oz).astype(jnp.float32) * cfg.voxel_size
    xc, yc, z = cam_T_world.apply_xyz(px, py, pz)  # [V, 512] camera coords
    intr = cam.intrinsics
    u = vx.round_half_away((intr.fx * xc + intr.cx * z) / z).astype(jnp.int32)
    v = vx.round_half_away((intr.fy * yc + intr.cy * z) / z).astype(jnp.int32)
    in_img = (u >= 0) & (u < cam.img_w) & (v >= 0) & (v < cam.img_h)
    us = jnp.clip(u, 0, cam.img_w - 1)
    vs = jnp.clip(v, 0, cam.img_h - 1)
    # Pin the projection outputs: the fully-fusable SoA chain otherwise
    # fuses into each consumer, and XLA's FMA contraction then depends
    # on program shape — ulp differences in z between e.g. the windowed-
    # and plain-scatter programs.  The barrier keeps the projection
    # compiling identically across those program variants; note it does
    # NOT fully pin the downstream fuse math — XLA:CPU still lowers the
    # shared division differently per program shape (see
    # test_scatter_window_matches_plain), so cross-program contracts
    # there are ulp-bounded.  These arrays materialize as gather
    # operands anyway.
    us, vs, z, in_img = jax.lax.optimization_barrier((us, vs, z, in_img))

    # One stacked image carries all per-pixel channels (depth, d2r, rgb,
    # ht, lt, pad-to-8), sampled by ONE gather: [V, 512] pixel indices
    # -> [V, 512, 8] rows.
    stacked = jnp.stack(
        [
            frame.depth,
            d2r,
            frame.rgb[..., 0],
            frame.rgb[..., 1],
            frame.rgb[..., 2],
            frame.ht,
            frame.lt,
            jnp.zeros_like(frame.depth),
        ],
        axis=-1,
    )
    with jax.named_scope("sample"):
        samp = stacked[vs, us]  # [V, 512, 8]
    depth = samp[..., 0]
    d2r_s = samp[..., 1]
    r_new, g_new, b_new = samp[..., 2], samp[..., 3], samp[..., 4]
    ht = samp[..., 5]
    lt = samp[..., 6]

    def _tail(s: int):
        """Post-gather fuse tail over the first `s` visible rows.

        Rows past the live count are masked everywhere (vis.mask), so any
        s >= vis.count produces the same volume; smaller s does ~s/vcap
        of the tail's gather/VPU/scatter work.  Used monolithically
        (s == vcap) or as a cfg.fuse_ladder cond branch."""
        sl = (lambda a: a) if s == vcap else (lambda a: a[:s])
        mask_s = sl(vis.mask)
        depth_s, d2r_ss, z_s = sl(depth), sl(d2r_s), sl(z)
        ht_s, lt_s = sl(ht), sl(lt)
        depth_ok = (depth_s > 0) & (depth_s <= max_depth)
        sdf = d2r_ss * (depth_s - z_s)
        sdf_ok = sdf > -cfg.truncation
        update = mask_s[:, None] & sl(in_img) & depth_ok & sdf_ok

        tsdf_new = jnp.minimum(1.0, sdf / cfg.truncation)
        w_new = (1.0 - depth_s / max_depth) * 4.0

        # Index hints: dense-backend pool indices are ascending (entry i
        # <-> pool slot i and compaction preserves entry order), so the
        # row gathers/scatters can promise sorted/unique to XLA's
        # emitters.  Padding rows clip to num_blocks-1 (duplicated), so
        # the gather only claims sorted, not unique.
        dense = cfg.backend == "dense" and cfg.index_hints
        pool = jnp.clip(sl(vis.pool_idx), 0, cfg.num_blocks - 1)  # [s]
        with jax.named_scope("payload_gather"):
            tsdf_old = vol.tsdf.at[pool].get(indices_are_sorted=dense)  # [s, 512]
            # ONE packed gather for color+weight (VoxelRGBW word); unpack
            # with shifts in-flight — no [s, 512, 3] arrays in this path
            rgbw_old = vol.rgbw.at[pool].get(indices_are_sorted=dense)  # u32
            prob_old = vol.prob.at[pool].get(indices_are_sorted=dense)
        # Second pin (see the projection barrier above): vis.pool_idx
        # feeds both these gathers and the scatter-index computation,
        # which DIFFERS between the windowed- and plain-scatter programs
        # — without the barrier XLA can fuse the gathers + fusion math
        # into a kernel whose shape (and hence FMA contraction) varies
        # per program.  Pinning the inputs narrows the variance to the
        # fuse-math region itself (which XLA:CPU still specializes per
        # program at the ~ulp level).
        tsdf_old, rgbw_old, prob_old = jax.lax.optimization_barrier(
            (tsdf_old, rgbw_old, prob_old)
        )
        w_old = (rgbw_old >> 24).astype(jnp.float32)
        r_old = (rgbw_old & 0xFF).astype(jnp.float32)
        g_old = ((rgbw_old >> 8) & 0xFF).astype(jnp.float32)
        b_old = ((rgbw_old >> 16) & 0xFF).astype(jnp.float32)
        w_comb = w_old + w_new
        w_safe = jnp.where(w_comb == 0, 1.0, w_comb)
        tsdf_upd = (tsdf_old * w_old + tsdf_new * w_new) / w_safe
        r_upd = vx.round_half_away((r_old * w_old + sl(r_new) * w_new) / w_safe)
        g_upd = vx.round_half_away((g_old * w_old + sl(g_new) * w_new) / w_safe)
        b_upd = vx.round_half_away((b_old * w_old + sl(b_new) * w_new) / w_safe)
        w_upd = jnp.minimum(vx.round_half_away(w_comb), cfg.max_weight)
        # log-space geometric fusion of ht/lt (voxel_tsdf.cu:196-202).
        # DELIBERATE divergence from the reference in one corner: the
        # reference computes expf(w * logf(p)), which is NaN when w == 0
        # and p == 0 (0 * -inf) — hit by voxels first touched near
        # max_depth, whose w_new < 0.5 rounds the stored weight to 0.
        # Here the zero-exponent term contributes nothing (powf(0,0)==1
        # semantics), and a zero denominator keeps p_old, so those
        # voxels stay finite where the reference would poison them.  The
        # oracle encodes the same guard, so tests pin THIS behavior, not
        # the reference's NaN.
        positive = jnp.exp(
            _pow_log(prob_old, w_old / w_safe) + _pow_log(ht_s, w_new / w_safe)
        )
        negative = jnp.exp(
            _pow_log(1.0 - prob_old, w_old / w_safe)
            + _pow_log(lt_s, w_new / w_safe)
        )
        denom = positive + negative
        prob_upd = jnp.where(
            denom > 0, positive / jnp.where(denom > 0, denom, 1.0), prob_old
        )
        if cfg.prob_eps > 0.0:
            prob_upd = jnp.clip(prob_upd, cfg.prob_eps, 1.0 - cfg.prob_eps)

        tsdf_w = jnp.where(update, tsdf_upd, tsdf_old)
        prob_w = jnp.where(update, prob_upd, prob_old)
        # repack the RGBW word: updated lanes pack their (integral,
        # rounded) channels; others keep the old word bit-for-bit
        rgbw_upd = (
            r_upd.astype(jnp.uint32)
            | (g_upd.astype(jnp.uint32) << 8)
            | (b_upd.astype(jnp.uint32) << 16)
            | (w_upd.astype(jnp.uint32) << 24)
        )
        rgbw_w = jnp.where(update, rgbw_upd, rgbw_old)

        # Same rationale as the projection barrier above: pin the fused
        # payloads so the scatter machinery (plain vs windowed-cond)
        # cannot fuse INTO the fusion math — the update arrays are the
        # scatter operands and materialize regardless.  This also makes
        # the in-program windowed/fallback cond branches provably write
        # the same values (both consume these pinned arrays).
        tsdf_w, rgbw_w, prob_w = jax.lax.optimization_barrier(
            (tsdf_w, rgbw_w, prob_w)
        )
        vis_s = VisibleSet(
            entry_idx=sl(vis.entry_idx),
            block_pos=sl(vis.block_pos),
            pool_idx=sl(vis.pool_idx),
            mask=mask_s,
            count=vis.count,
        )
        with jax.named_scope("payload_scatter"):
            vol_s = _scatter_payload_rows(vol, vis_s, tsdf_w, rgbw_w, prob_w)
        min_abs = jnp.min(jnp.abs(tsdf_w), axis=-1)
        if s < vcap:
            # pad to the full visible cap for carving; padded rows have
            # vis.mask False (count <= s in this branch) so the value is
            # never consumed
            min_abs = jnp.concatenate(
                [min_abs, jnp.zeros((vcap - s,), min_abs.dtype)]
            )
        return vol_s.tsdf, vol_s.rgbw, vol_s.prob, min_abs

    ladder = _auto_fuse_ladder(cfg)
    if ladder <= 1:
        tsdf_a, rgbw_a, prob_a, min_abs = _tail(vcap)
    else:
        # smallest static size covering the live count wins; the last
        # rung (s == vcap) is the unconditional fallback
        sizes = [vcap * k // ladder for k in range(1, ladder + 1)]

        def _rung(k: int):
            if k == len(sizes) - 1:
                return lambda: _tail(sizes[k])
            return lambda: lax.cond(
                vis.count <= sizes[k], lambda: _tail(sizes[k]), _rung(k + 1)
            )

        tsdf_a, rgbw_a, prob_a, min_abs = _rung(0)()
    vol = vol.replace(tsdf=tsdf_a, rgbw=rgbw_a, prob=prob_a)
    return vol, min_abs


def _auto_fuse_ladder(cfg: TSDFConfig) -> int:
    """Resolve cfg.fuse_ladder = -1 ("auto") at trace time.

    Auto resolves to 1 (monolithic): the lax.cond rungs defeat the
    donated pool-buffer aliasing the way a gated allocate insert would
    (allocate_blocks), and the measured ladder was slower than the
    monolithic tail.  Explicit values stay available.  An L that doesn't
    divide max_visible disables the ladder (validate() rejects explicit
    values, this guards the auto path)."""
    ladder = cfg.fuse_ladder
    if ladder == -1:
        ladder = 1
    if ladder > 1 and cfg.max_visible % ladder != 0:
        return 1
    return ladder


def _scatter_payload_rows(
    vol: TSDFVolume,
    vis: VisibleSet,
    tsdf_w: jnp.ndarray,
    rgbw_w: jnp.ndarray,
    prob_w: jnp.ndarray,
) -> TSDFVolume:
    """Write fused payload rows back to the pool.

    Padded rows drop via OOB index: padding gets DISTINCT out-of-bounds
    indices (num_blocks + position) so the whole index vector is
    genuinely unique — and, on the dense backend, ascending (live rows
    are the compacted ascending prefix, pinned by
    test_visible_pool_indices_sorted_unique_invariant) — letting the
    scatter emitter skip its collision handling.

    cfg.scatter_window_log2 > 0 (dense backend): route the scatters
    through a 2^k-row window around the live rows so the scatter operand
    is O(window) instead of O(pool) — see the config field's rationale.
    Falls back to the plain full-pool scatter in-program when the live
    span exceeds the window (fail-open, bit-identical either way).
    """
    cfg = vol.cfg
    vcap = vis.mask.shape[0]
    dense = cfg.backend == "dense" and cfg.index_hints
    pad = cfg.num_blocks + jnp.arange(vcap, dtype=jnp.int32)
    wpool = jnp.where(vis.mask, vis.pool_idx, pad)

    def full_set(arr, upd):
        return arr.at[wpool].set(
            upd, mode="drop", unique_indices=cfg.index_hints,
            indices_are_sorted=dense,
        )

    wlog2 = cfg.scatter_window_log2
    win = 1 << wlog2
    if wlog2 <= 0 or cfg.backend != "dense" or win >= cfg.num_blocks:
        return vol.replace(
            tsdf=full_set(vol.tsdf, tsdf_w),
            rgbw=full_set(vol.rgbw, rgbw_w),
            prob=full_set(vol.prob, prob_w),
        )

    count = vis.count
    first = jnp.where(count > 0, wpool[0], 0)
    last = jnp.where(count > 0, wpool[jnp.maximum(count - 1, 0)], 0)
    # sublane-aligned window base, clamped so the slice stays in range
    base = jnp.clip(first & ~7, 0, cfg.num_blocks - win).astype(jnp.int32)
    fits = (last - base) < win
    # local indices keep the sorted/unique invariant: live rows map to
    # [0, win) preserving order; padding maps to win + position (OOB,
    # ascending, past every live value)
    lrows = jnp.where(
        vis.mask, wpool - base, win + jnp.arange(vcap, dtype=jnp.int32)
    )
    zero = jnp.zeros((), jnp.int32)

    def win_set(arr, upd):
        w = lax.dynamic_slice(arr, (base, zero), (win, arr.shape[1]))
        w = w.at[lrows].set(
            upd, mode="drop", unique_indices=cfg.index_hints,
            indices_are_sorted=dense,
        )
        return lax.dynamic_update_slice(arr, w, (base, zero))

    def windowed(t, c, p):
        return win_set(vol.tsdf, t), win_set(vol.rgbw, c), win_set(vol.prob, p)

    def fallback(t, c, p):
        return full_set(vol.tsdf, t), full_set(vol.rgbw, c), full_set(vol.prob, p)

    tsdf, rgbw, prob = lax.cond(fits, windowed, fallback, tsdf_w, rgbw_w, prob_w)
    return vol.replace(tsdf=tsdf, rgbw=rgbw, prob=prob)


# ----------------------------------------------------------------------
# Stage 4: space carving (space_carving_kernel rework)
# ----------------------------------------------------------------------
def space_carve(
    vol: TSDFVolume, vis: VisibleSet, min_abs: jnp.ndarray | None = None
) -> TSDFVolume:
    """Delete visible blocks whose min |tsdf| >= carve threshold
    (voxel_tsdf.cu:207-230, threshold 0.9 at :485).

    min_abs: per-visible-row min |tsdf| already computed by fusion;
    when absent the rows are re-gathered from the pool."""
    cfg = vol.cfg
    if min_abs is None:
        pool = jnp.clip(vis.pool_idx, 0, cfg.num_blocks - 1)
        min_abs = jnp.min(jnp.abs(vol.tsdf[pool]), axis=-1)
    doomed = vis.mask & (min_abs >= cfg.carve_threshold)
    return h.delete_entries(vol, vis.entry_idx, doomed)


# ----------------------------------------------------------------------
# Full per-frame step
# ----------------------------------------------------------------------
def integrate(
    vol: TSDFVolume,
    frame: FrameInput,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    return_stats: bool = False,
    allocate: bool = True,
):
    """One frame of semantic TSDF fusion (TSDFGrid::Integrate,
    voxel_tsdf.cu:347-375). Pure function of (volume, frame, pose); jit it
    with donate_argnums=0 to update the volume in place in HBM.

    return_stats=True additionally returns IntegrateStats (device
    scalars: the visible count).

    allocate=False (static) skips the block-allocation stage entirely —
    the cfg.alloc_every scheme fuses every frame but allocates on every
    N-th: geometry first seen on a skipped frame starts fusing one frame
    late, the SAME fail-open latency class as the reference's hash lock
    collisions, which drop the allocation and retry next frame
    (voxel_hash.cu:83-89).  At steady state (no new surface in view) the
    skipped pass was a provable no-op."""
    # named scopes label each stage in device traces (scripts/trace_summary.py)
    d2r = depth_to_range(cam)
    if allocate:
        with jax.named_scope("allocate"):
            vol = allocate_blocks(vol, frame.depth, d2r, cam, cam_T_world, max_depth)
    with jax.named_scope("visible"):
        vis = gather_visible(vol, cam, cam_T_world, frame.depth, d2r)
    with jax.named_scope("fuse"):
        vol, min_abs = fuse_visible(vol, vis, frame, d2r, cam, cam_T_world, max_depth)
    with jax.named_scope("carve"):
        vol = space_carve(vol, vis, min_abs)
    if return_stats:
        return vol, IntegrateStats(visible_count=vis.count)
    return vol


@partial(jax.jit, static_argnums=(2, 4), donate_argnums=(0,))
def integrate_jit(
    vol: TSDFVolume,
    frame: FrameInput,
    cam_size: Tuple[int, int],
    cam_intr: jnp.ndarray,
    max_depth: float,
    cam_T_world_mat: jnp.ndarray,
) -> TSDFVolume:
    """Convenience jitted entry: intrinsics as (fx, fy, cx, cy) array,
    pose as a 4x4 matrix, image size static."""
    from ..core.geometry import CameraIntrinsics

    intr = CameraIntrinsics.create(cam_intr[0], cam_intr[1], cam_intr[2], cam_intr[3])
    cam = CameraParams.create(intr, cam_size[0], cam_size[1])
    pose = SE3.from_matrix(cam_T_world_mat)
    return integrate(vol, frame, cam, pose, max_depth)
