"""Lock-free batched spatial hashing in JAX.

The reference mutates its hash table from inside CUDA kernels using
per-bucket spin locks (`atomicExch`, voxel_hash.cu:58-171); lock losers
silently drop their allocation and retry next frame.  A functional
XLA program has no device-side locks, so allocation is redesigned as a
*batched functional insert*:

  1. every candidate probes a fixed window of slots (existence check +
     first-free-slot search) — pure vectorized gathers;
  2. candidates wanting a free slot claim it with a deterministic
     scatter-max of their batch index; exactly one winner per slot;
  3. winners pop pool blocks off the free heap via a prefix-sum rank and
     reset their payload rows;
  4. losers retry in the next claim round against the updated table; after
     `insert_rounds` rounds the rest are dropped for this frame — the same
     fail-open semantics as the reference's lock retry, but deterministic.

The hash function is kept bit-identical to the reference
(voxel_hash.cu:31-35): h = (x*73856093 ^ y*19349669 ^ z*83492791) & mask,
evaluated in wrapping int32 arithmetic.

Deletion writes a TOMBSTONE so probe chains stay intact (the functional
analogue of the reference's list splice on Delete, voxel_hash.cu:122-171).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import TSDFConfig
from ..core import voxel as vx
from ..core.state import EMPTY, RESET_PROB, RESET_TSDF, TOMBSTONE, TSDFVolume

_P1 = jnp.int32(73856093)
_P2 = jnp.int32(19349669)
_P3 = jnp.int32(83492791)


def hash_block(block: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Block coord [..., 3] int32 -> bucket index [...].

    int32 multiply wraps (two's complement) so the bit pattern matches the
    reference's uint32 arithmetic; the final mask keeps it non-negative.
    """
    x = block[..., 0] * _P1
    y = block[..., 1] * _P2
    z = block[..., 2] * _P3
    return (x ^ y ^ z) & cfg.bucket_mask


def probe_slots(block: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Probe window [..., max_probe] of entry indices for a block coord.

    Probing starts at the bucket's first entry and walks linearly with
    wraparound — the open-addressing replacement for the reference's
    2-entry bucket + chained overflow list.
    """
    base = hash_block(block, cfg) << cfg.entries_per_bucket_log2
    offs = jnp.arange(cfg.max_probe, dtype=jnp.int32)
    return (base[..., None] + offs) & cfg.entry_mask


# ----------------------------------------------------------------------
# dense backend: block_table[grid_cell] -> pool idx; entry i == pool i
# ----------------------------------------------------------------------
def table_index_xyz(bx, by, bz, cfg: TSDFConfig):
    """SoA table_index: block coord component arrays -> (cell, in_range).

    The grid spans [grid_origin, grid_origin + grid_side) blocks per
    axis (origin defaults to centered, -grid_side/2).  Component-array
    form so million-key sweeps never materialize [N, 3] intermediates."""
    g = cfg.grid_side
    org = cfg.grid_origin or (-(g >> 1),) * 3
    px = bx - org[0]
    py = by - org[1]
    pz = bz - org[2]
    in_range = (
        (px >= 0) & (px < g) & (py >= 0) & (py < g) & (pz >= 0) & (pz < g)
    )
    idx = (
        (jnp.clip(px, 0, g - 1) << (2 * cfg.grid_log2))
        | (jnp.clip(py, 0, g - 1) << cfg.grid_log2)
        | jnp.clip(pz, 0, g - 1)
    )
    return idx, in_range


def table_index(block: jnp.ndarray, cfg: TSDFConfig):
    """Block coord [..., 3] -> (cell index [...], in-range mask [...])."""
    return table_index_xyz(
        block[..., 0], block[..., 1], block[..., 2], cfg
    )


def _lookup_dense(vol: TSDFVolume, block: jnp.ndarray) -> jnp.ndarray:
    idx, in_range = table_index(block, vol.cfg)
    pool = vol.block_table[idx]
    return jnp.where(in_range, pool, EMPTY)


def _push_free(heap, num_free, mask, blk, cfg: TSDFConfig):
    """Push blk[i] where mask[i] onto the free stack (above the top) —
    the shared release discipline of ReleaseBlock (voxel_mem.cu:57-61).
    Returns (heap, new num_free)."""
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    heap_pos = jnp.where(mask, num_free + rank, cfg.num_blocks)
    heap = heap.at[heap_pos].set(blk, mode="drop")
    return heap, num_free + jnp.sum(mask.astype(jnp.int32))


def _insert_dense(
    vol: TSDFVolume, block: jnp.ndarray, valid: jnp.ndarray
) -> Tuple[TSDFVolume, jnp.ndarray]:
    """Single-pass dense insert: no probe conflicts exist (one cell per
    coord); duplicate candidates resolve by a scatter-max claim."""
    cfg = vol.cfg
    m = block.shape[0]
    idx, in_range = table_index(block, cfg)
    exists = vol.block_table[idx] >= 0
    pending = valid & in_range & ~exists

    # Claim IN PLACE in block_table (donated, so the scatter-min mutates
    # the live buffer): encoding cand ids as values strictly below EMPTY
    # avoids materializing a fresh grid_cells-sized claims array every
    # frame (67 MB at 256^3).  min(-3 - cand_id) selects the LARGEST
    # cand id per cell — the same winner as the old scatter-max claim.
    # Free cells are EMPTY (-1) > every encode; occupied cells are >= 0
    # and never claimed (pending excludes them).
    cand_id = jnp.arange(m, dtype=jnp.int32)
    claim_slot = jnp.where(pending, idx, cfg.grid_cells)
    enc = -3 - cand_id
    claimed = vol.block_table.at[claim_slot].min(enc, mode="drop")
    won = pending & (claimed[idx] == enc)

    # Cap acquisitions at max_new_per_round: the payload reset below only
    # covers that many rows, so an uncapped winner would enter the pool
    # with stale DEFAULT payload (prob=0 -> NaN in the log-odds fusion).
    # Overflow candidates drop and retry next frame (fail-open, like the
    # reference's lock-miss, voxel_hash.cu:83-89).
    w = cfg.max_new_per_round
    rank = jnp.cumsum(won.astype(jnp.int32)) - 1
    heap_idx = vol.num_free - 1 - rank
    ok = won & (heap_idx >= 0) & (rank < w)
    pool_idx = vol.heap[jnp.clip(heap_idx, 0, cfg.num_blocks - 1)]

    # every claimed cell has exactly one winner, so this single scatter
    # restores the table to a clean state: capacity-approved winners
    # write their pool idx, capacity-dropped winners restore EMPTY
    block_table = claimed.at[jnp.where(won, idx, cfg.grid_cells)].set(
        jnp.where(ok, pool_idx, EMPTY), mode="drop"
    )
    wslot = jnp.where(ok, pool_idx, cfg.num_blocks)
    entry_block = vol.entry_block.at[wslot].set(pool_idx, mode="drop")
    # packed-key entry write: ONE [E] i32 scatter (see core/state.py on
    # why not the [E, 3] form); in-range is already enforced above, so
    # the pack is exact for every non-dropped slot
    entry_key = vol.entry_key.at[wslot].set(
        vx.pack_block_coord(block, cfg), mode="drop"
    )
    num_free = vol.num_free - jnp.sum(ok.astype(jnp.int32))

    # payload reset (voxel_mem.cu:43-51) via compacted winner rows; ok
    # implies rank < w, so every acquired block gets a reset row.
    # Padding slots get DISTINCT out-of-bounds indices (num_blocks +
    # slot) so the whole index vector is genuinely unique (heap pops are
    # distinct pool rows) and the scatter emitter can skip collision
    # handling; every >= num_blocks index still drops.
    crank = jnp.where(ok, rank, w)
    compact = (
        (cfg.num_blocks + jnp.arange(w, dtype=jnp.int32))
        .at[crank]
        .set(pool_idx, mode="drop")
    )
    v = cfg.block_volume
    tsdf = vol.tsdf.at[compact].set(
        jnp.full((w, v), RESET_TSDF, jnp.float32), mode="drop",
        unique_indices=cfg.index_hints
    )
    # zero the whole packed rgbw word (weight=0 AND rgb=0; see
    # core/state.py on the stale-rgb divergence from voxel_mem.cu:43-51)
    rgbw = vol.rgbw.at[compact].set(
        jnp.zeros((w, v), jnp.uint32), mode="drop", unique_indices=cfg.index_hints
    )
    prob = vol.prob.at[compact].set(
        jnp.full((w, v), RESET_PROB, jnp.float32), mode="drop",
        unique_indices=cfg.index_hints
    )

    vol = vol.replace(
        block_table=block_table,
        entry_key=entry_key,
        entry_block=entry_block,
        num_free=num_free,
        tsdf=tsdf,
        rgbw=rgbw,
        prob=prob,
    )
    dropped = valid & in_range & ~exists & ~ok
    return vol, dropped


def _delete_entries_dense(
    vol: TSDFVolume, entry_idx: jnp.ndarray, valid: jnp.ndarray
) -> TSDFVolume:
    cfg = vol.cfg
    safe_idx = jnp.clip(entry_idx, 0, cfg.num_blocks - 1)
    blk = vol.entry_block[safe_idx]
    valid = valid & (entry_idx >= 0) & (blk >= 0)

    # clear the dense cell for the stored coordinate
    pos = vx.unpack_block_coord(vol.entry_key[safe_idx], cfg)
    cell, _ = table_index(pos, cfg)
    block_table = vol.block_table.at[jnp.where(valid, cell, cfg.grid_cells)].set(
        EMPTY, mode="drop"
    )
    entry_block = vol.entry_block.at[jnp.where(valid, safe_idx, cfg.num_blocks)].set(
        EMPTY, mode="drop"
    )
    heap, num_free = _push_free(vol.heap, vol.num_free, valid, blk, cfg)
    return vol.replace(
        block_table=block_table,
        entry_block=entry_block,
        heap=heap,
        num_free=num_free,
    )


def recenter_origin_for(cfg: TSDFConfig, cam_pos_world_m):
    """Window origin (block coords, clipped into packed-coord range)
    centering the dense window on a world position."""
    import numpy as np

    bs = cfg.block_len * cfg.voxel_size
    g = cfg.grid_side
    lo, hi = cfg.coord_min, cfg.coord_max - g + 1
    return tuple(
        int(np.clip(int(np.floor(c / bs)) - (g >> 1), lo, hi))
        for c in np.asarray(cam_pos_world_m, np.float64)
    )


def needs_recenter(
    cfg: TSDFConfig, cam_pos_world_m, margin_blocks=None, max_depth=None
) -> bool:
    """True when the camera is within the margin of the dense window
    edge.  Pass max_depth to derive a frustum-deep margin (observations
    past the edge drop until the window moves); fallback is a quarter
    window; either caps at 3/8 window so an oversized frustum cannot
    retrigger every frame.  Pure host arithmetic."""
    import numpy as np

    if cfg.backend != "dense":
        return False
    bs = cfg.block_len * cfg.voxel_size
    g = cfg.grid_side
    if margin_blocks is None:
        margin_blocks = int(np.ceil(max_depth / bs)) if max_depth else g >> 2
    margin_blocks = min(margin_blocks, 3 * g // 8)
    org = np.asarray(cfg.grid_origin or (-(g >> 1),) * 3)
    b = np.floor(np.asarray(cam_pos_world_m, np.float64) / bs).astype(int)
    return bool(
        np.any((b - org < margin_blocks) | (org + g - b <= margin_blocks))
    )


def recenter_dense(vol: TSDFVolume, new_origin) -> TSDFVolume:
    """Move the dense directory's coverage window to a new grid_origin
    WITHOUT touching voxel payloads.

    entry_pos stores ABSOLUTE block coordinates (the world frame never
    moves — only the directory window does, like the reference's
    coordinate-unbounded hash whose coverage follows wherever allocation
    goes, voxel_hash.cuh:13-25).  The move is therefore a pure directory
    rebuild: every live block re-scatters into the table at its new
    cell; blocks falling outside the new window are released to the
    free list (their payloads reset on the next acquire, voxel_mem.cu:
    43-51).  This is how a disinfection robot outruns the fixed
    +-grid_side/2 window on the production backend: recenter at
    waypoint cadence (a new cfg = a new jit specialization — do NOT
    call per frame).

    new_origin: (ox, oy, oz) block coordinates of the window's low
    corner, each within [coord_min, coord_max - grid_side + 1].
    """
    import dataclasses

    cfg = vol.cfg
    assert cfg.backend == "dense", "recenter applies to the dense directory"
    new_cfg = dataclasses.replace(
        cfg, grid_origin=tuple(int(x) for x in new_origin)
    )
    new_cfg.validate()
    if new_cfg.grid_origin == (cfg.grid_origin or (-(cfg.grid_side >> 1),) * 3):
        return vol  # no-op

    live = vol.entry_block >= 0
    cell, in_r = table_index(vol.entry_pos, new_cfg)
    keep = live & in_r
    drop = live & ~in_r
    # distinct absolute coords map to distinct in-window cells, so one
    # scatter rebuilds the whole directory
    table = (
        jnp.full((cfg.grid_cells,), EMPTY, jnp.int32)
        .at[jnp.where(keep, cell, cfg.grid_cells)]
        .set(vol.entry_block, mode="drop")
    )
    # release out-of-window blocks
    heap, num_free = _push_free(
        vol.heap, vol.num_free, drop, vol.entry_block, cfg
    )
    entry_block = jnp.where(drop, EMPTY, vol.entry_block)
    return vol.replace(
        cfg=new_cfg,
        block_table=table,
        entry_block=entry_block,
        heap=heap,
        num_free=num_free,
    )


def lookup(vol: TSDFVolume, block: jnp.ndarray) -> jnp.ndarray:
    """Batched retrieve: block coords [N, 3] -> pool indices [N] (-1 miss).

    Functional analogue of VoxelHashTable::RetrieveMutable
    (voxel_hash.cuh:124-161): probe the window, return the pool index of
    the matching live entry.
    """
    cfg = vol.cfg
    if cfg.backend == "dense":
        return _lookup_dense(vol, block)
    slots = probe_slots(block, cfg)  # [N, K]
    ekey = vol.entry_key[slots]  # [N, K] packed coords
    eblk = vol.entry_block[slots]  # [N, K]
    match = (eblk >= 0) & (ekey == vx.pack_block_coord(block, cfg)[..., None])
    found = jnp.any(match, axis=-1)
    first = jnp.argmax(match, axis=-1)
    blk = jnp.take_along_axis(eblk, first[..., None], axis=-1)[..., 0]
    return jnp.where(found, blk, EMPTY)


def lookup_entry(vol: TSDFVolume, block: jnp.ndarray) -> jnp.ndarray:
    """Like lookup() but returns the *entry* index [N] (-1 miss)."""
    cfg = vol.cfg
    if cfg.backend == "dense":
        return _lookup_dense(vol, block)  # entry idx == pool idx
    slots = probe_slots(block, cfg)
    ekey = vol.entry_key[slots]
    eblk = vol.entry_block[slots]
    match = (eblk >= 0) & (ekey == vx.pack_block_coord(block, cfg)[..., None])
    found = jnp.any(match, axis=-1)
    first = jnp.argmax(match, axis=-1)
    slot = jnp.take_along_axis(slots, first[..., None], axis=-1)[..., 0]
    return jnp.where(found, slot, EMPTY)


def _claim_round(
    vol: TSDFVolume, block: jnp.ndarray, pending: jnp.ndarray
) -> Tuple[TSDFVolume, jnp.ndarray]:
    """One existence-check + claim + allocate round over [M] candidates."""
    cfg = vol.cfg
    m = block.shape[0]
    num_entries = cfg.num_entries

    slots = probe_slots(block, cfg)  # [M, K]
    key = vx.pack_block_coord(block, cfg)  # [M]
    ekey = vol.entry_key[slots]
    eblk = vol.entry_block[slots]

    # Existence: a live entry with our coord anywhere in the window.
    exists = jnp.any((eblk >= 0) & (ekey == key[:, None]), axis=-1)
    pending = pending & ~exists

    # First free (empty or tombstone) slot in the window.
    free = eblk < 0
    has_free = jnp.any(free, axis=-1)
    first_free = jnp.argmax(free, axis=-1)
    target = jnp.take_along_axis(slots, first_free[:, None], axis=-1)[:, 0]

    want = pending & has_free
    cand_id = jnp.arange(m, dtype=jnp.int32)
    # Deterministic conflict resolution: max candidate id wins the slot.
    claim_slot = jnp.where(want, target, num_entries)  # OOB -> dropped
    claims = (
        jnp.full((num_entries,), -1, jnp.int32)
        .at[claim_slot]
        .max(cand_id, mode="drop")
    )
    won = want & (claims[target] == cand_id)

    # Pool acquisition: winner i takes heap[num_free - 1 - rank_i]
    # (stack pop order of AquireBlock, voxel_mem.cu:37-42).  Capped at
    # max_new_per_round so the payload reset below covers every acquired
    # block (an uncapped winner would fuse against stale DEFAULT payload);
    # capped-out candidates stay pending for the next round/frame.
    w = cfg.max_new_per_round
    rank = jnp.cumsum(won.astype(jnp.int32)) - 1
    heap_idx = vol.num_free - 1 - rank
    can_alloc = won & (heap_idx >= 0) & (rank < w)
    pool_idx = vol.heap[jnp.clip(heap_idx, 0, cfg.num_blocks - 1)]

    # Write entries (scatter, unique slots by construction).
    wslot = jnp.where(can_alloc, target, num_entries)
    entry_block = vol.entry_block.at[wslot].set(pool_idx, mode="drop")
    entry_key = vol.entry_key.at[wslot].set(key, mode="drop")
    n_alloc = jnp.sum(can_alloc.astype(jnp.int32))
    num_free = vol.num_free - n_alloc

    # Reset payload rows of acquired blocks (voxel_mem.cu:43-51).  Compact
    # winners into a small buffer first so the scatter touches at most
    # max_new_per_round rows instead of M; can_alloc implies rank < w.
    crank = jnp.where(can_alloc, rank, w)
    compact = (
        jnp.full((w,), cfg.num_blocks, jnp.int32).at[crank].set(pool_idx, mode="drop")
    )
    v = cfg.block_volume
    tsdf = vol.tsdf.at[compact].set(
        jnp.full((w, v), RESET_TSDF, jnp.float32), mode="drop"
    )
    rgbw = vol.rgbw.at[compact].set(jnp.zeros((w, v), jnp.uint32), mode="drop")
    prob = vol.prob.at[compact].set(
        jnp.full((w, v), RESET_PROB, jnp.float32), mode="drop"
    )

    vol = vol.replace(
        entry_key=entry_key,
        entry_block=entry_block,
        num_free=num_free,
        tsdf=tsdf,
        rgbw=rgbw,
        prob=prob,
    )
    pending = pending & ~can_alloc
    return vol, pending


def insert(
    vol: TSDFVolume, block: jnp.ndarray, valid: jnp.ndarray
) -> Tuple[TSDFVolume, jnp.ndarray]:
    """Batch-insert block coords [M, 3] where valid [M].

    Returns (volume, dropped_mask). Candidates unresolved after
    cfg.insert_rounds claim rounds are dropped (fail-open, like the
    reference's lock-miss retry-next-frame, voxel_hash.cu:83-89).
    """
    if vol.cfg.backend == "dense":
        return _insert_dense(vol, block, valid)
    # packed-key storage bounds coords to [coord_min, coord_max] (the
    # documented coord_bits range, config.py); out-of-range candidates
    # drop rather than aliasing another key
    pending = valid & vx.in_coord_range(block, vol.cfg)
    for _ in range(vol.cfg.insert_rounds):
        vol, pending = _claim_round(vol, block, pending)
    return vol, pending


def delete_entries(
    vol: TSDFVolume, entry_idx: jnp.ndarray, valid: jnp.ndarray
) -> TSDFVolume:
    """Batch-delete by entry index [N]; releases pool blocks to the heap.

    Functional analogue of VoxelHashTable::Delete (voxel_hash.cu:122-171):
    instead of list splicing, the entry becomes a TOMBSTONE that probes
    walk through. ReleaseBlock pushes the pool idx back on the stack
    (voxel_mem.cu:57-61).
    """
    cfg = vol.cfg
    if cfg.backend == "dense":
        return _delete_entries_dense(vol, entry_idx, valid)
    num_entries = cfg.num_entries
    safe_idx = jnp.clip(entry_idx, 0, num_entries - 1)
    blk = vol.entry_block[safe_idx]
    valid = valid & (entry_idx >= 0) & (blk >= 0)

    wslot = jnp.where(valid, safe_idx, num_entries)
    entry_block = vol.entry_block.at[wslot].set(TOMBSTONE, mode="drop")

    heap, num_free = _push_free(vol.heap, vol.num_free, valid, blk, cfg)
    return vol.replace(entry_block=entry_block, heap=heap, num_free=num_free)


def read_voxels(
    vol: TSDFVolume, point: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Read (tsdf, rgb, weight, prob) at integer voxel coords [N, 3].

    Misses return the default voxel payloads (VoxelTSDF()=+1 etc.,
    voxel_types.cu:8-12), matching Retrieve's default-on-miss
    (voxel_hash.cuh:104-112).
    """
    from ..core import voxel as vx
    from ..core.state import DEFAULT_PROB, DEFAULT_TSDF

    cfg = vol.cfg
    blk_coord = vx.point_to_block(point, cfg)
    pool = lookup(vol, blk_coord)  # [N]
    hit = pool >= 0
    pool_safe = jnp.where(hit, pool, 0)
    vidx = vx.offset_to_index(vx.point_to_offset(point, cfg), cfg)
    tsdf = jnp.where(hit, vol.tsdf[pool_safe, vidx], DEFAULT_TSDF)
    # gather the packed word first, THEN unpack (gathering through the
    # .rgb property would materialize a full unpacked pool array)
    rw = vol.rgbw[pool_safe, vidx]
    rgb = jnp.where(
        hit[:, None],
        jnp.stack(
            [rw & 0xFF, (rw >> 8) & 0xFF, (rw >> 16) & 0xFF], axis=-1
        ).astype(jnp.float32),
        0.0,
    )
    weight = jnp.where(hit, (rw >> 24).astype(jnp.float32), 0.0)
    prob = jnp.where(hit, vol.prob[pool_safe, vidx], DEFAULT_PROB)
    return tsdf, rgb, weight, prob


def read_tsdf(vol: TSDFVolume, point: jnp.ndarray) -> jnp.ndarray:
    """TSDF-only read at integer voxel coords [..., 3] (hot raycast path)."""
    return read_tsdf_miss(vol, point)[0]


def read_tsdf_miss(
    vol: TSDFVolume, point: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(tsdf, block_missing) at integer voxel coords [..., 3].

    The miss flag drives empty-space skipping in the raycaster: an
    unallocated block reads the default +1 everywhere, so the march can
    jump over it without changing any sampled value.
    """
    from ..core import voxel as vx
    from ..core.state import DEFAULT_TSDF

    cfg = vol.cfg
    blk_coord = vx.point_to_block(point, cfg)
    pool = lookup(vol, blk_coord)
    hit = pool >= 0
    pool_safe = jnp.where(hit, pool, 0)
    vidx = vx.offset_to_index(vx.point_to_offset(point, cfg), cfg)
    return jnp.where(hit, vol.tsdf[pool_safe, vidx], DEFAULT_TSDF), ~hit


def trilinear_tsdf(vol: TSDFVolume, point: jnp.ndarray) -> jnp.ndarray:
    """Trilinearly interpolated TSDF at fractional voxel coords [N, 3].

    Mirrors RetrieveTSDF (voxel_hash.cu:173-200) including its corner
    weighting: alpha = ceil-corner - point, corner i uses floor when the
    corresponding bit is set.
    """
    pl = jnp.floor(point)
    alpha = pl + 1.0 - point  # = ph - point
    vals = []
    for i in range(8):
        cx = pl[..., 0] if (i >> 2) & 1 else pl[..., 0] + 1.0
        cy = pl[..., 1] if (i >> 1) & 1 else pl[..., 1] + 1.0
        cz = pl[..., 2] if (i >> 0) & 1 else pl[..., 2] + 1.0
        corner = jnp.stack([cx, cy, cz], axis=-1).astype(jnp.int32)
        vals.append(read_tsdf(vol, corner))
    ax, ay, az = alpha[..., 0], alpha[..., 1], alpha[..., 2]
    t00 = vals[0b000] * az + vals[0b001] * (1 - az)
    t01 = vals[0b010] * az + vals[0b011] * (1 - az)
    t10 = vals[0b100] * az + vals[0b101] * (1 - az)
    t11 = vals[0b110] * az + vals[0b111] * (1 - az)
    t0 = t00 * ay + t01 * (1 - ay)
    t1 = t10 * ay + t11 * (1 - ay)
    return t0 * ax + t1 * (1 - ax)
