"""Voxel / block coordinate helpers.

JAX equivalents of the reference's coordinate maps
(utils/tsdf/voxel_mem.cuh:29-68): voxel<->block coordinates, in-block
offsets, plus int32 packing used for batched dedup (the reference
needs no packing because it dedups through per-thread hash probes).

All functions are shape-polymorphic over leading dims and jit-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import TSDFConfig


def point_to_block(point: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Voxel coord [..., 3] int32 -> block coord (arithmetic shift, like
    voxel_mem.cuh:29-32 which relies on signed >>)."""
    return point >> cfg.block_len_log2


def block_to_point(block: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Block coord [..., 3] -> voxel coord of its first voxel."""
    return block << cfg.block_len_log2


def point_to_offset(point: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Voxel coord [..., 3] -> offset within its block, in [0, 8)."""
    return point & (cfg.block_len - 1)


def offset_to_index(offset: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """In-block offset [..., 3] -> flat index in [0, 512).

    Layout matches OffsetToIndex (voxel_mem.cuh:65-68): x fastest.
    """
    bl = cfg.block_len_log2
    return offset[..., 0] + (offset[..., 1] << bl) + (offset[..., 2] << (2 * bl))


def index_to_offset(index: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Flat in-block index [...,] -> offset [..., 3]."""
    bl = cfg.block_len_log2
    mask = cfg.block_len - 1
    x = index & mask
    y = (index >> bl) & mask
    z = (index >> (2 * bl)) & mask
    return jnp.stack([x, y, z], axis=-1)


def pack_block_coord(block: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Pack a block coord [..., 3] into one non-negative int32 key.

    Used as a sort/dedup key for batched allocation. Coordinates outside
    the representable range [coord_min, coord_max] are clamped by the
    caller (out-of-range blocks are dropped before packing).
    """
    b = cfg.coord_bits
    off = 1 << (b - 1)
    x = (block[..., 0] + off).astype(jnp.int32)
    y = (block[..., 1] + off).astype(jnp.int32)
    z = (block[..., 2] + off).astype(jnp.int32)
    return x | (y << b) | (z << (2 * b))


def unpack_block_coord(key: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Inverse of pack_block_coord -> [..., 3] int32."""
    b = cfg.coord_bits
    off = 1 << (b - 1)
    mask = (1 << b) - 1
    x = (key & mask) - off
    y = ((key >> b) & mask) - off
    z = ((key >> (2 * b)) & mask) - off
    return jnp.stack([x, y, z], axis=-1)


def in_coord_range(block: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """Mask [...] of block coords representable by pack_block_coord."""
    lo = cfg.coord_min
    hi = cfg.coord_max
    return jnp.all((block >= lo) & (block <= hi), axis=-1)


# Sentinel pack key: larger than any valid key, sorts last.
def sentinel_key(cfg: TSDFConfig) -> int:
    return 1 << (3 * cfg.coord_bits)


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """CUDA roundf semantics: round half away from zero.

    jnp.round is half-to-even; the reference rounds voxel projections and
    fused rgb/weights with roundf (e.g. voxel_tsdf.cu:165-166, 192-194),
    so exact-parity goldens need this variant.
    """
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))
