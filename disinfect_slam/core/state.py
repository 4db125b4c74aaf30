"""The TSDF volume as one functional pytree of HBM-resident arrays.

This fuses the reference's three mutable GPU structures into immutable
JAX state threaded through jitted steps:
  - VoxelMemPool   (utils/tsdf/voxel_mem.cuh:95-174): SoA payload arrays +
    free-list heap with an atomic counter -> `tsdf/weight/rgb/prob` arrays
    plus a `heap` stack and scalar `num_free`.
  - VoxelHashTable (utils/tsdf/voxel_hash.cuh:47-183): bucketed entries
    with spin locks and chained overflow -> flat `entry_key`/`entry_block`
    arrays probed linearly; conflicts are resolved by deterministic
    scatter claims instead of locks (see ops/hash.py).  Block coordinates
    are stored PACKED (one i32 key per entry, core/voxel.py
    pack_block_coord): a [E, 3] coordinate array would be minor-dim-3,
    which XLA may relayout with whole-array copies around the entry
    scatter.  The packed key scatters as a plain [E] i32 row and unpacks
    into consumers for free; the `entry_pos` property provides the
    unpacked [E, 3] view.
  - VoxelBlock metadata (voxel_mem.cuh:73-93).

Entry states in `entry_block`: >= 0 pool index, EMPTY (-1) never used,
TOMBSTONE (-2) deleted (probe continues past it, like the reference's
list splice keeping chains intact, voxel_hash.cu:122-171).

Payload semantics (voxel_types.cu):
  - unallocated reads return tsdf=+1, rgb=0, weight=0, prob=0
  - freshly acquired blocks reset to tsdf=-1, weight=0, prob=0.5
    (voxel_mem.cu:43-51).  The reference leaves rgb stale on acquire;
    here the packed rgbw word resets to 0 (rgb=0 too) — weight 0 makes
    the first fusion overwrite rgb either way, so the difference is
    only visible when directly reading never-fused voxels, where 0
    matches the numpy oracle and avoids leaking a previous block's
    colors through pool-row reuse.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import TSDFConfig
from .pytree import pytree_dataclass, static_field

EMPTY = -1
TOMBSTONE = -2

# Default payload values for unallocated voxels (VoxelTSDF()/VoxelSEGM()
# default ctors, voxel_types.cu:8-12).
DEFAULT_TSDF = 1.0
DEFAULT_PROB = 0.0

# Reset values on block acquisition (voxel_mem.cu:43-51).
RESET_TSDF = -1.0
RESET_PROB = 0.5


@pytree_dataclass
class TSDFVolume:
    """Functional TSDF volume state."""

    # --- spatial index (E entries) ---
    # hash backend: E = num_entries, open-addressed probe slots.
    # dense backend: E = num_blocks, entry i <-> pool slot i, plus a dense
    # block_table mapping grid cell -> pool idx for O(1) lookup (one
    # load instead of a 16-slot probe).
    entry_key: jnp.ndarray  # int32 [E] packed block coordinate (pack_block_coord)
    entry_block: jnp.ndarray  # int32 [E]  pool idx / EMPTY / TOMBSTONE
    block_table: jnp.ndarray  # int32 [G^3] (dense) or [1] placeholder (hash)

    # --- block pool free list (B blocks) ---
    heap: jnp.ndarray  # int32 [B] stack of free pool indices
    num_free: jnp.ndarray  # int32 [] stack top (= number of free blocks)

    # cumulative count of allocation candidates dropped because they
    # fell outside the grid/coord coverage — the reference's hash is
    # coordinate-unbounded (voxel_hash.cuh:13-25), so silent truncation
    # here would be a parity break; hosts watch this and warn loudly
    # (systems/tsdf_grid.py)
    oob_count: jnp.ndarray  # int32 []

    # --- voxel payloads, SoA (B blocks x 512 voxels) ---
    # Byte-exact VoxelRGBW: one u32 per voxel packing {u8 r, g, b,
    # weight} exactly like the reference struct (voxel_types.cuh:10-19,
    # little-endian byte order r|g<<8|b<<16|w<<24).  Together with
    # VoxelTSDF {f32} and VoxelSEGM {f32} this is the reference's
    # 4+4+4 = 12 B per voxel.  One packed array also means ONE
    # gather + ONE scatter per frame for color+weight, and no [*, 3]
    # minor-dim layouts for XLA to pad or copy (an u8[B,512,3] rgb
    # array cost two whole-pool layout copies per frame).  Fusion math
    # always produced integral rgb/weight (voxel_tsdf.cu:189-194), so
    # the packed storage is exact; readers unpack with shifts in-flight.
    tsdf: jnp.ndarray  # f32 [B, V]
    rgbw: jnp.ndarray  # u32 [B, V] packed r|g<<8|b<<16|weight<<24
    prob: jnp.ndarray  # f32 [B, V] high-touch probability

    cfg: TSDFConfig = static_field()

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, cfg: TSDFConfig) -> "TSDFVolume":
        cfg.validate()
        # one jitted program instead of ~10 eager array inits: it
        # compiles once and lands in the persistent compile cache
        return _create_volume(cfg)


    @property
    def entry_pos(self) -> jnp.ndarray:
        """Unpacked [E, 3] block-coordinate view of entry_key (the
        storage is packed — see the class docstring)."""
        from . import voxel as vx

        return vx.unpack_block_coord(self.entry_key, self.cfg)

    @property
    def num_active_blocks(self) -> jnp.ndarray:
        """NumActiveBlock equivalent (voxel_hash.cu:207)."""
        return jnp.asarray(self.cfg.num_blocks, jnp.int32) - self.num_free

    # unpacked payload views (engine hot paths use .rgbw directly and
    # unpack in-flight; these exist for exports, tests, tooling)
    @property
    def weight(self) -> jnp.ndarray:
        """u8 [B, V] fusion weight (VoxelRGBW.weight view)."""
        return (self.rgbw >> 24).astype(jnp.uint8)

    @property
    def rgb(self) -> jnp.ndarray:
        """u8 [B, V, 3] color (VoxelRGBW.rgb view)."""
        return jnp.stack(
            [
                (self.rgbw & 0xFF).astype(jnp.uint8),
                ((self.rgbw >> 8) & 0xFF).astype(jnp.uint8),
                ((self.rgbw >> 16) & 0xFF).astype(jnp.uint8),
            ],
            axis=-1,
        )

    def nbytes(self) -> int:
        total = 0
        for f in (
            self.entry_key,
            self.entry_block,
            self.block_table,
            self.heap,
            self.tsdf,
            self.rgbw,
            self.prob,
        ):
            total += f.size * f.dtype.itemsize
        return total


@partial(jax.jit, static_argnums=0)
def _create_volume(cfg: TSDFConfig) -> "TSDFVolume":
    e, b, v = cfg.num_entries, cfg.num_blocks, cfg.block_volume
    table_size = cfg.grid_cells if cfg.backend == "dense" else 1
    # key of coordinate (0, 0, 0): keeps the unpacked entry_pos view of
    # never-written entries identical to the old zero-initialized array
    off = 1 << (cfg.coord_bits - 1)
    key0 = off | (off << cfg.coord_bits) | (off << (2 * cfg.coord_bits))
    return TSDFVolume(
        entry_key=jnp.full((e,), key0, jnp.int32),
        entry_block=jnp.full((e,), EMPTY, jnp.int32),
        block_table=jnp.full((table_size,), EMPTY, jnp.int32),
        # Stack pops from the top: heap[num_free - 1] first, matching
        # AquireBlock's atomicSub order (voxel_mem.cu:37-42).
        heap=jnp.arange(b, dtype=jnp.int32),
        num_free=jnp.asarray(b, jnp.int32),
        oob_count=jnp.zeros((), jnp.int32),
        tsdf=jnp.full((b, v), DEFAULT_TSDF, jnp.float32),
        rgbw=jnp.zeros((b, v), jnp.uint32),
        prob=jnp.full((b, v), DEFAULT_PROB, jnp.float32),
        cfg=cfg,
    )
