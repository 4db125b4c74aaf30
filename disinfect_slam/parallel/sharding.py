"""Multi-chip scale-out of the TSDF volume over a JAX device mesh.

The reference is single-GPU with no distributed backend (SURVEY.md §2.5);
this is the additive multi-device scaling axis.  Design:

  - The voxel working set is sharded *by block ownership*: every device
    owns the blocks whose coordinate hashes to its mesh index (a
    different prime mix than the bucket hash so ownership and bucket
    placement are decorrelated).
  - State is a TSDFVolume with a leading device axis [D, ...]; each
    device holds an independent sub-hash + sub-pool of 1/D capacity.
  - `integrate` runs under shard_map: the frame is replicated to every
    device (small: ~2 MB) and every device allocates/fuses/carves only its own
    blocks.  No collectives are needed in the hot loop at all — the
    ownership filter makes the update embarrassingly parallel.
  - Queries (bbox gather / full export) run per-shard and all-gather
    their fixed-capacity results.
  - Raycast across shards marches per-device and min-combines hit
    depths with a psum-style reduction (each ray's first crossing is on
    exactly one owner's shard for watertight surfaces).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops import hash as h
from ..ops.integrate import (
    FrameInput,
    depth_to_range,
    fuse_visible,
    gather_visible,
    space_carve,
)

_OWNER_P1 = jnp.int32(126271)
_OWNER_P2 = jnp.int32(522133279)
_OWNER_P3 = jnp.int32(96002369)


def owner_of(block: jnp.ndarray, n_devices: int) -> jnp.ndarray:
    """Device index owning a block coord [..., 3] (decorrelated from the
    bucket hash so each shard's buckets fill uniformly)."""
    mix = (
        (block[..., 0] * _OWNER_P1)
        ^ (block[..., 1] * _OWNER_P2)
        ^ (block[..., 2] * _OWNER_P3)
    )
    return jnp.abs(mix) % n_devices


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard", devices=None) -> Mesh:
    devs = list(jax.devices() if devices is None else devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_config(cfg: TSDFConfig, n_devices: int) -> TSDFConfig:
    """Per-device sub-volume config: pool capacity divided by the shard
    count.  The dense block table keeps its full spatial extent on every
    shard (ownership scatters blocks across all of space); only the hash
    bucket count shrinks with the pool."""
    shrink = max(int(np.log2(n_devices)), 0)
    kwargs = dict(num_blocks_log2=cfg.num_blocks_log2 - shrink)
    if cfg.backend == "hash":
        kwargs["num_buckets_log2"] = cfg.num_buckets_log2 - shrink
    return dataclasses.replace(cfg, **kwargs)


class DistributedTSDF:
    """TSDF volume sharded over a 1-D device mesh."""

    def __init__(self, cfg: TSDFConfig, mesh: Mesh):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_devices = mesh.devices.size
        self.cfg = cfg
        self.sub_cfg = shard_config(cfg, self.n_devices)

        sub = TSDFVolume.create(self.sub_cfg)
        # replicate the initial (empty) sub-volume onto each device shard
        stacked = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (self.n_devices,) + x.shape), sub
        )
        sharding = NamedSharding(mesh, P(self.axis))
        self.volume = jax.tree.map(
            lambda x: jax.device_put(x, sharding), stacked
        )
        self._integrate_cache = {}

    # ------------------------------------------------------------------
    def _build_integrate(self, img_h: int, img_w: int, max_depth: float):
        axis = self.axis
        n_dev = self.n_devices
        sub_cfg = self.sub_cfg

        def shard_step(vol: TSDFVolume, frame: FrameInput, intr, pose_mat):
            # vol leaves arrive with their leading device axis stripped
            vol = jax.tree.map(lambda x: x[0], vol)
            vol = dataclasses.replace(vol, cfg=sub_cfg)
            my_idx = jax.lax.axis_index(axis)

            intrinsics = CameraIntrinsics.create(intr[0], intr[1], intr[2], intr[3])
            cam = CameraParams.create(intrinsics, img_h, img_w)
            pose = SE3.from_matrix(pose_mat)
            d2r = depth_to_range(cam)

            # allocation reuses the single-chip path, but candidates not
            # owned by this shard are masked out before insert
            vol = _allocate_owned(vol, frame.depth, d2r, cam, pose, max_depth, my_idx, n_dev)
            vis = gather_visible(vol, cam, pose)
            vol, min_abs = fuse_visible(vol, vis, frame, d2r, cam, pose, max_depth)
            vol = space_carve(vol, vis, min_abs)
            return jax.tree.map(lambda x: x[None], vol)

        fn = shard_map(
            shard_step,
            mesh=self.mesh,
            in_specs=(P(axis), P(), P(), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        return jax.jit(fn, donate_argnums=0)

    def integrate(
        self,
        frame: FrameInput,
        intrinsics: Tuple[float, float, float, float],
        cam_T_world: np.ndarray,
        max_depth: float,
    ) -> None:
        img_h, img_w = frame.depth.shape
        key = (img_h, img_w, float(max_depth))
        if key not in self._integrate_cache:
            self._integrate_cache[key] = self._build_integrate(img_h, img_w, float(max_depth))
        step = self._integrate_cache[key]
        self.volume = step(
            self.volume,
            frame,
            jnp.asarray(intrinsics, jnp.float32),
            jnp.asarray(cam_T_world, jnp.float32),
        )

    # ------------------------------------------------------------------
    def enable_host_spill(self) -> None:
        """Attach one HostBlockStore per shard (systems/block_streaming.py).
        Spilled blocks re-place onto their owner shard on restore — the
        ownership hash is stable, so each shard's store only ever holds
        blocks that shard owns, and no cross-shard traffic is needed."""
        from ..systems.block_streaming import HostBlockStore

        self.spill_stores = [HostBlockStore() for _ in range(self.n_devices)]

    def spill_store_len(self) -> int:
        stores = getattr(self, "spill_stores", None)
        return sum(len(s) for s in stores) if stores else 0

    def _get_shard(self, d: int) -> TSDFVolume:
        sub = jax.tree.map(lambda x: jnp.asarray(np.asarray(x[d])), self.volume)
        return dataclasses.replace(sub, cfg=self.sub_cfg)

    def _put_shards(self, shards) -> None:
        host = [jax.tree.map(lambda x: np.asarray(x), s) for s in shards]
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *host)
        sharding = NamedSharding(self.mesh, P(self.axis))
        self.volume = jax.tree.map(
            lambda x: jax.device_put(jnp.asarray(x), sharding), stacked
        )

    def maybe_page(
        self,
        cam_pos_world_m,
        radius_m: float,
        min_free_frac: float = 0.05,
        target_free_frac: float = 0.15,
    ) -> Tuple[int, int]:
        """Pool-pressure paging per shard — the sharded twin of
        TSDFGrid.maybe_page (systems/tsdf_grid.py), same policy: under
        low free-list pressure evict the farthest-from-camera owned
        blocks to that shard's host store, then restore stored blocks
        within radius_m while pool room allows.  Host-coordinated (pulls
        each shard, pages, re-places the stacked volume) — call at
        waypoint cadence, never per frame.  Returns (restored, evicted)
        summed over shards."""
        stores = getattr(self, "spill_stores", None)
        if not stores:
            return (0, 0)
        restored = evicted = 0
        shards = []
        b = self.sub_cfg.num_blocks
        for d in range(self.n_devices):
            sub = self._get_shard(d)
            free = int(np.asarray(sub.num_free))
            if free < min_free_frac * b:
                n_evict = int(target_free_frac * b) - free
                sub, ev = stores[d].spill_cold(
                    sub, cam_pos_world_m, n_evict, keep_radius_m=radius_m
                )
                evicted += ev
                free = int(np.asarray(sub.num_free))
            room = free - int(min_free_frac * b)
            if room > 0 and len(stores[d]):
                sub, rs = stores[d].restore_into_window(
                    sub, center_m=cam_pos_world_m, radius_m=radius_m,
                    max_restore=room,
                )
                restored += rs
            shards.append(sub)
        if restored or evicted:
            self._put_shards(shards)
        return (restored, evicted)

    # ------------------------------------------------------------------
    def num_active_blocks(self) -> int:
        sub_blocks = self.sub_cfg.num_blocks
        return int(jnp.sum(sub_blocks - self.volume.num_free))

    def gather_all_tsdf(self):
        """Per-shard gather_valid; returns host-side concatenated records."""
        from ..ops import gather as g

        outs = []
        for d in range(self.n_devices):
            sub = jax.tree.map(lambda x: jax.device_get(x[d]), self.volume)
            sub = dataclasses.replace(sub, cfg=self.sub_cfg)
            sub = jax.tree.map(jnp.asarray, sub)
            st = g.gather_valid(sub)
            outs.append(g.to_numpy_records(st))
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def query_bbox(self, bbox) -> np.ndarray:
        """Distributed bbox query: every shard extracts its in-bound
        voxels, results combine with an all_gather (the
        multi-chip TSDFSystem::Query analogue).  Returns host [N, 4]
        (x, y, z, tsdf) records."""
        from ..ops import gather as g

        axis = self.axis
        sub_cfg = self.sub_cfg

        def shard_query(vol):
            vol = jax.tree.map(lambda x: x[0], vol)
            vol = dataclasses.replace(vol, cfg=sub_cfg)
            st = g.gather_voxels(vol, bbox)
            pos = jnp.where(st.mask[:, None], st.position, 0.0)
            tsdf = jnp.where(st.mask, st.tsdf, jnp.nan)
            rec = jnp.concatenate([pos, tsdf[:, None]], axis=1)  # [N, 4]
            # collective: every shard receives all shards' records
            return jax.lax.all_gather(rec, axis)[None]

        fn = shard_map(
            shard_query,
            mesh=self.mesh,
            in_specs=(P(axis),),
            out_specs=P(axis),
            check_vma=False,
        )
        out = np.asarray(jax.jit(fn)(self.volume))[0]  # [D, N, 4]
        out = out.reshape(-1, 4)
        return out[~np.isnan(out[:, 3])]

    def render(self, cam, cam_T_world: np.ndarray, max_depth: float):
        """Distributed splat render: each shard splats its own blocks and
        the per-pixel z-buffers merge with a global min (pmin); payload
        selection follows the winning depth."""
        from ..core.geometry import SE3
        from ..ops.render_fast import splat_render

        axis = self.axis
        sub_cfg = self.sub_cfg

        def shard_render(vol, pose_mat):
            vol = jax.tree.map(lambda x: x[0], vol)
            vol = dataclasses.replace(vol, cfg=sub_cfg)
            res = splat_render(vol, cam, SE3.from_matrix(pose_mat), max_depth)
            local_d = jnp.where(res.hit, res.depth, jnp.inf)
            # global nearest surface across shards
            best = jax.lax.pmin(local_d, axis)
            win = res.hit & (local_d <= best)
            rgba = jnp.where(win[..., None], res.rgba, 0)
            normal = jnp.where(win[..., None], res.normal, 0)
            # combine payloads: max works because exactly one shard wins
            # per pixel (strict depth winner) and losers contribute zero
            rgba = jax.lax.pmax(rgba, axis)
            normal = jax.lax.pmax(normal, axis)
            hit = jax.lax.pmax(win.astype(jnp.int32), axis) > 0
            depth = jnp.where(jnp.isfinite(best), best, 0.0)
            return jax.tree.map(
                lambda x: x[None], (rgba, normal, depth, hit)
            )

        fn = shard_map(
            shard_render,
            mesh=self.mesh,
            in_specs=(P(axis), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        rgba, normal, depth, hit = jax.jit(fn)(
            self.volume, jnp.asarray(cam_T_world, jnp.float32)
        )
        from ..ops.raycast import RaycastResult

        return RaycastResult(
            rgba=rgba[0], normal=normal[0], depth=depth[0], hit=hit[0]
        )


def save_distributed(path: str, dist: DistributedTSDF) -> int:
    """Elastic checkpoint of a sharded volume: a mesh-size-AGNOSTIC dump
    of every live block (absolute coords + payload rows) plus the
    top-level config.  Restoring with load_distributed works onto ANY
    device count — scale-up, scale-down, or single chip — because block
    placement is recomputed from the ownership hash at load time.  (The
    reference has no distributed backend at all, SURVEY.md §2.5; its
    only volume artifact is the VoxelSpatialTSDF dump.)  Returns the
    number of blocks saved."""
    import dataclasses as _dc
    import json

    pos_all, tsdf_all, rgbw_all, prob_all = [], [], [], []
    for d in range(dist.n_devices):
        sub = jax.tree.map(lambda x: np.asarray(jax.device_get(x[d])), dist.volume)
        live = sub.entry_block >= 0
        pool = sub.entry_block[live]
        pos_all.append(sub.entry_pos[live])
        tsdf_all.append(sub.tsdf[pool])
        rgbw_all.append(sub.rgbw[pool])
        prob_all.append(sub.prob[pool])
    pos = np.concatenate(pos_all) if pos_all else np.zeros((0, 3), np.int32)
    cfg_json = np.frombuffer(
        json.dumps(_dc.asdict(dist.cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(
        path,
        format=np.asarray(1, np.int32),
        cfg_json=cfg_json,
        pos=pos,
        tsdf=np.concatenate(tsdf_all),
        rgbw=np.concatenate(rgbw_all),
        prob=np.concatenate(prob_all),
    )
    return int(pos.shape[0])


def load_distributed(
    path: str, mesh: Mesh, cfg: Optional[TSDFConfig] = None
) -> DistributedTSDF:
    """Restore an elastic checkpoint onto `mesh` (any device count —
    including a different one than it was saved from).  Blocks re-insert
    shard-by-shard through the normal allocation path (chunked to the
    sub-volume's max_new_per_round), payload rows land via lookup."""
    import json

    from ..core.state import TSDFVolume as _Vol
    from ..ops import hash as _h

    data = np.load(path)
    if cfg is None:
        fields = json.loads(bytes(data["cfg_json"]).decode())
        fields["grid_origin"] = (
            tuple(fields["grid_origin"]) if fields.get("grid_origin") else None
        )
        cfg = TSDFConfig(**fields)
    dist = DistributedTSDF(cfg, mesh)
    pos = np.asarray(data["pos"], np.int32)
    owners = np.asarray(owner_of(jnp.asarray(pos), dist.n_devices))

    shards = []
    for d in range(dist.n_devices):
        sel = owners == d
        p = pos[sel]
        tsdf = np.asarray(data["tsdf"])[sel]
        rgbw = np.asarray(data["rgbw"])[sel]
        prob = np.asarray(data["prob"])[sel]
        sub = _Vol.create(dist.sub_cfg)
        step = min(dist.sub_cfg.max_new_per_round, dist.sub_cfg.max_candidates)
        for lo in range(0, len(p), step):
            chunk = jnp.asarray(p[lo : lo + step])
            sub, dropped = _h.insert(
                sub, chunk, jnp.ones((chunk.shape[0],), bool)
            )
            n_drop = int(jnp.sum(dropped))
            if n_drop:
                raise ValueError(
                    f"shard {d}: {n_drop} blocks did not fit the "
                    f"sub-volume (capacity 2^{dist.sub_cfg.num_blocks_log2}"
                    "); restore onto more devices or a larger pool"
                )
        if len(p):
            rows = _h.lookup(sub, jnp.asarray(p))
            sub = sub.replace(
                tsdf=sub.tsdf.at[rows].set(jnp.asarray(tsdf)),
                rgbw=sub.rgbw.at[rows].set(jnp.asarray(rgbw)),
                prob=sub.prob.at[rows].set(jnp.asarray(prob)),
            )
        shards.append(jax.device_get(sub))

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *shards)
    sharding = NamedSharding(mesh, P(dist.axis))
    dist.volume = jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), sharding), stacked
    )
    return dist


def _allocate_owned(
    vol: TSDFVolume,
    frame_depth: jnp.ndarray,
    d2r: jnp.ndarray,
    cam: CameraParams,
    cam_T_world: SE3,
    max_depth: float,
    my_idx: jnp.ndarray,
    n_devices: int,
) -> TSDFVolume:
    """allocate_blocks with an ownership filter on the candidates.

    Uses the presence-filter dedup on the dense backend, like the
    single-device path (it skips the ~1M-key sort, which also compiles
    far slower).  Candidates not owned by this shard are masked before
    the insert, so each device allocates only its own blocks.
    """
    from ..core import voxel as vx
    from ..ops.integrate import block_visibility, generate_candidates

    cfg = vol.cfg
    world_T_cam = cam_T_world.inverse()
    keys, oob = generate_candidates(
        frame_depth, d2r, cam, cam_T_world, world_T_cam, max_depth, cfg
    )
    sent = vx.sentinel_key(cfg)
    left = jnp.concatenate([jnp.full((1,), -1, keys.dtype), keys[:-1]])
    keys = jnp.where(keys == left, sent, keys)

    if cfg.alloc_dedup == "filter" and cfg.backend == "dense":
        # SoA unpack over the full key stream (see ops/integrate.py)
        ks = jnp.where(keys < sent, keys, 0)
        cb = cfg.coord_bits
        koff = 1 << (cb - 1)
        kmask = (1 << cb) - 1
        kx = (ks & kmask) - koff
        ky = ((ks >> cb) & kmask) - koff
        kz = ((ks >> (2 * cb)) & kmask) - koff
        cell, in_range = h.table_index_xyz(kx, ky, kz, cfg)
        exists = vol.block_table[cell] >= 0
        mix = (kx * _OWNER_P1) ^ (ky * _OWNER_P2) ^ (kz * _OWNER_P3)
        owned = (jnp.abs(mix) % n_devices) == my_idx
        new = (keys < sent) & in_range & ~exists & owned
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
        vol, _ = h.insert(vol, coords, valid)
        return vol.replace(oob_count=vol.oob_count + oob)

    uniq = jnp.unique(keys, size=cfg.max_candidates, fill_value=sent)
    coords = vx.unpack_block_coord(uniq, cfg)
    valid = (
        (uniq < sent)
        & (owner_of(coords, n_devices) == my_idx)
        & block_visibility(coords, cam_T_world, cam, cfg, full=True)
    )
    vol, _ = h.insert(vol, coords, valid)
    return vol.replace(oob_count=vol.oob_count + oob)
