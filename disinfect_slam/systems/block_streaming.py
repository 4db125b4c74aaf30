"""Host-RAM block streaming: spill blocks evicted by dense-window
recentering to host memory and restore them when the window returns.

The reference RESERVED this mode but never built it — voxel_mem.cuh:76-77
keeps `offset < 0` for "voxel block on CPU" — and SURVEY.md §5 names host
offload as the spatial working-set scaling axis.  With a
HostBlockStore attached to TSDFGrid, the production dense backend
becomes effectively unbounded: HBM holds the active ±grid_side/2 window,
host RAM holds everything the robot has ever mapped, and revisited areas
come back voxel-for-voxel instead of refusing from scratch.

Cadence: spill/restore run only inside recenter (a host-coordinated,
recompiling event — systems/tsdf_grid.py recenter docstring); the
per-frame fusion hot path is untouched.

Policies:
  - spill: every live block falling outside the NEW window is pulled to
    host (coords + tsdf/rgbw/prob rows) before recenter_dense releases
    its pool row.  A re-spill of the same coordinate overwrites the
    stored copy (newest wins).
  - restore: stored blocks inside the (new) window are batch-inserted
    and their payloads scattered back, then dropped from the store.  A
    coordinate that is ALREADY live on device MERGES: the live row
    re-fused from a DEFAULT reset after the eviction, so the two rows
    hold disjoint observations and weight-proportional fusion
    (_merge_rows) loses neither.  Blocks the insert machinery drops
    (pool exhausted / claim rounds lost) stay in the store for the next
    pass — fail-open, like the reference's lock-miss retry
    (voxel_hash.cu:83-89).
  - checkpointing: the store is host state; save_npz/load_npz persist it
    next to the volume checkpoint (ops/checkpoint.py covers only the
    device volume).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.state import TSDFVolume

logger = logging.getLogger("disinfect_slam.block_streaming")

_Key = Tuple[int, int, int]
# payload rows per block: (tsdf f32[V], rgbw u32[V], prob f32[V])
_Payload = Tuple[np.ndarray, np.ndarray, np.ndarray]

# spill/restore transfers are padded to a multiple of this many rows so
# the eager gathers/scatters specialize to a bounded set of shapes
# (every distinct shape is its own compile)
_PAD_ROWS = 2048


def _pad_to(n: int) -> int:
    return max(_PAD_ROWS, ((n + _PAD_ROWS - 1) // _PAD_ROWS) * _PAD_ROWS)


def _merge_rows(t_l, c_l, p_l, t_s, c_s, p_s, max_weight, prob_eps=0.0):
    """Combine two independently-fused payload rows with the engine's
    weight-proportional fusion formulas (ops/integrate.py fuse_visible,
    voxel_tsdf.cu:189-202).

    Used when a restore finds its coordinate live on device again: the
    live row re-accumulated from a DEFAULT reset *after* the stored row
    was evicted (the store only holds blocks deleted at stash time), so
    the two rows fuse disjoint observation sets and merging loses
    neither — where plain device-wins would silently drop the stored
    history.  Voxels unobserved in both rows (w==0 each) keep the live
    bits."""
    w_l = (c_l >> 24).astype(np.float64)
    w_s = (c_s >> 24).astype(np.float64)
    w_c = w_l + w_s
    w_safe = np.where(w_c == 0, 1.0, w_c)

    def ch(c, sh):
        return ((c >> sh) & 0xFF).astype(np.float64)

    def rha(x):  # round half away from zero, like the engine
        return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))

    t = (t_l.astype(np.float64) * w_l + t_s.astype(np.float64) * w_s) / w_safe
    r = rha((ch(c_l, 0) * w_l + ch(c_s, 0) * w_s) / w_safe)
    g = rha((ch(c_l, 8) * w_l + ch(c_s, 8) * w_s) / w_safe)
    b = rha((ch(c_l, 16) * w_l + ch(c_s, 16) * w_s) / w_safe)
    w = np.minimum(rha(w_c), max_weight)

    # log-odds geometric fusion with the powf(0,0)==1 edge semantics
    def plog(x, e):
        with np.errstate(divide="ignore"):
            lg = np.log(x.astype(np.float64))
        return np.where(e == 0.0, 0.0, e * lg)

    e_l = w_l / w_safe
    e_s = w_s / w_safe
    pos = np.exp(plog(p_l, e_l) + plog(p_s, e_s))
    neg = np.exp(plog(1.0 - p_l, e_l) + plog(1.0 - p_s, e_s))
    den = pos + neg
    p = np.where(den > 0, pos / np.where(den > 0, den, 1.0), p_l)
    if prob_eps > 0.0:
        p = np.clip(p, prob_eps, 1.0 - prob_eps)

    word = (
        r.astype(np.uint32)
        | (g.astype(np.uint32) << 8)
        | (b.astype(np.uint32) << 16)
        | (w.astype(np.uint32) << 24)
    )
    # exact shortcuts: a voxel unobserved on one side takes the other
    # side's bits verbatim (the f64 weighted forms above are only
    # float-faithful, not bit-faithful, at w=0 edges)
    t = np.where(w_s == 0, t_l, np.where(w_l == 0, t_s, t))
    word = np.where(w_s == 0, c_l, np.where(w_l == 0, c_s, word))
    p = np.where(w_s == 0, p_l, np.where(w_l == 0, p_s, p))
    return (
        t.astype(np.float32), word.astype(np.uint32), p.astype(np.float32)
    )


class HostBlockStore:
    """Dict of spilled blocks, keyed by absolute block coordinate."""

    def __init__(self) -> None:
        self._store: Dict[_Key, _Payload] = {}

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: _Key) -> bool:
        return tuple(int(x) for x in key) in self._store

    def nbytes(self) -> int:
        if not self._store:
            return 0
        v = next(iter(self._store.values()))
        per = sum(a.nbytes for a in v) + 3 * 4
        return per * len(self._store)

    def payload(self, key: _Key) -> _Payload:
        return self._store[tuple(int(x) for x in key)]

    # ------------------------------------------------------------------
    def _stash(self, vol: TSDFVolume, coords: np.ndarray, rows: np.ndarray):
        """Pull payload rows [n] to host and store them under coords."""
        n = rows.shape[0]
        # padded device gather (clipped pad rows are discarded below)
        pad = _pad_to(n)
        rows_p = np.zeros((pad,), np.int32)
        rows_p[:n] = rows
        rj = jnp.asarray(rows_p)
        tsdf = np.asarray(vol.tsdf[rj])[:n]
        rgbw = np.asarray(vol.rgbw[rj])[:n]
        prob = np.asarray(vol.prob[rj])[:n]
        for i in range(n):
            self._store[tuple(int(c) for c in coords[i])] = (
                tsdf[i], rgbw[i], prob[i],
            )

    def spill_out_of_window(self, vol: TSDFVolume, new_cfg) -> int:
        """Copy every live block that falls OUTSIDE new_cfg's dense
        window into the store.  Call BEFORE ops.hash.recenter_dense
        (which releases those pool rows).  Returns blocks spilled."""
        from ..ops.hash import table_index

        live = np.asarray(vol.entry_block) >= 0
        _, in_r = table_index(vol.entry_pos, new_cfg)
        drop = live & ~np.asarray(in_r)
        n = int(drop.sum())
        if n == 0:
            return 0
        self._stash(
            vol, np.asarray(vol.entry_pos)[drop], np.asarray(vol.entry_block)[drop]
        )
        logger.info(
            "[spill] %d blocks -> host store (%d total, %.1f MB)",
            n, len(self._store), self.nbytes() / 1e6,
        )
        return n

    # ------------------------------------------------------------------
    def spill_cold(
        self,
        vol: TSDFVolume,
        cam_pos_m,
        n_evict: int,
        keep_radius_m: float = 0.0,
    ) -> Tuple[TSDFVolume, int]:
        """Pool-pressure eviction: store + delete the n_evict live blocks
        FARTHEST from cam_pos_m (never within keep_radius_m unless the
        pool cannot progress otherwise).  Works on both index backends —
        the reference's analogue simply stops allocating when the pool
        exhausts (voxel_mem.cu AquireBlock returns nothing to retry).
        Returns (volume, blocks evicted)."""
        from ..ops.hash import delete_entries

        cfg = vol.cfg
        live = np.asarray(vol.entry_block) >= 0
        idx = np.nonzero(live)[0]
        if idx.size == 0 or n_evict <= 0:
            return vol, 0
        pos = np.asarray(vol.entry_pos)[idx].astype(np.float64)
        centers = (pos * cfg.block_len + cfg.block_len / 2.0) * cfg.voxel_size
        dist = np.linalg.norm(centers - np.asarray(cam_pos_m, np.float64), axis=1)
        order = np.argsort(-dist)  # farthest first
        if keep_radius_m > 0.0:
            # NEVER evict inside the keep radius: those blocks may be in
            # the live frustum (mid-fusion) and evicting them both loses
            # freshness and churns straight back in through restore.
            # Under-evicting is safe — allocation stays fail-open.
            far = order[dist[order] > keep_radius_m]
            if far.size < n_evict:
                logger.warning(
                    "[spill-cold] pool pressure inside keep radius: "
                    "wanted %d evictions, only %d blocks beyond %.1f m",
                    n_evict, far.size, keep_radius_m,
                )
            pick = far[:n_evict]
        else:
            pick = order[:n_evict]
        if pick.size == 0:
            return vol, 0
        sel = idx[pick]
        n = sel.shape[0]
        self._stash(vol, np.asarray(vol.entry_pos)[sel], np.asarray(vol.entry_block)[sel])

        pad = _pad_to(n)
        eidx = np.full((pad,), -1, np.int32)
        eidx[:n] = sel
        vol = delete_entries(
            vol, jnp.asarray(eidx), jnp.asarray(eidx >= 0)
        )
        logger.info(
            "[spill-cold] evicted %d blocks beyond %.1f m (%d stored, "
            "%.1f MB)", n, keep_radius_m, len(self._store), self.nbytes() / 1e6,
        )
        return vol, n

    # ------------------------------------------------------------------
    def restore_into_window(
        self,
        vol: TSDFVolume,
        center_m=None,
        radius_m: float = 0.0,
        max_restore: int | None = None,
    ) -> Tuple[TSDFVolume, int]:
        """Insert stored blocks that fall inside vol.cfg's coverage (the
        dense window, or the packed-coord range on the hash backend) and
        write their payloads back.  Call AFTER recenter_dense, or at
        paging cadence with (center_m, radius_m) to pull back only the
        blocks near the camera, capped at max_restore.  Returns
        (volume, blocks restored)."""
        from ..core import voxel as vx
        from ..ops.hash import insert, lookup, table_index

        cfg = vol.cfg
        if not self._store:
            return vol, 0
        keys = np.array(list(self._store.keys()), np.int32).reshape(-1, 3)
        if cfg.backend == "dense":
            _, in_r = table_index(jnp.asarray(keys), cfg)
        else:
            in_r = vx.in_coord_range(jnp.asarray(keys), cfg)
        sel = np.asarray(in_r)
        if center_m is not None and radius_m > 0.0:
            centers = (
                keys.astype(np.float64) * cfg.block_len + cfg.block_len / 2.0
            ) * cfg.voxel_size
            dist = np.linalg.norm(
                centers - np.asarray(center_m, np.float64), axis=1
            )
            sel = sel & (dist <= radius_m)
            # nearest first, so a max_restore cap keeps the closest
            order = np.argsort(dist)
            cand = keys[order][sel[order]]
        else:
            cand = keys[sel]
        if max_restore is not None:
            cand = cand[:max_restore]
        if cand.shape[0] == 0:
            return vol, 0

        restored = 0
        chunk_rows = min(cfg.max_new_per_round, 4096)
        for lo in range(0, cand.shape[0], chunk_rows):
            chunk = cand[lo:lo + chunk_rows]
            m = chunk.shape[0]
            pad = _pad_to(m)
            coords_p = np.zeros((pad, 3), np.int32)
            coords_p[:m] = chunk
            valid_p = np.zeros((pad,), bool)
            valid_p[:m] = True
            cj = jnp.asarray(coords_p)

            before = np.asarray(lookup(vol, cj))[:m]
            fresh = before < 0
            vj = jnp.asarray(valid_p & np.pad(fresh, (0, pad - m)))
            vol, _ = insert(vol, cj, vj)
            after = np.asarray(lookup(vol, cj))[:m]
            ok = fresh & (after >= 0)

            # coordinates live again on device: the live row re-fused
            # from a reset AFTER the eviction, so MERGE the stored
            # history in (weight-proportional, _merge_rows) instead of
            # discarding either copy
            conflicts = np.nonzero(~fresh)[0]
            if conflicts.size:
                n_c = conflicts.size
                cpad = _pad_to(n_c)
                crow = np.full((cpad,), cfg.num_blocks, np.int32)
                crow[:n_c] = before[conflicts]
                crj = jnp.asarray(crow)
                t_l = np.asarray(vol.tsdf[crj])[:n_c]
                c_l = np.asarray(vol.rgbw[crj])[:n_c]
                p_l = np.asarray(vol.prob[crj])[:n_c]
                t_s = np.stack(
                    [self._store[tuple(int(x) for x in chunk[i])][0]
                     for i in conflicts])
                c_s = np.stack(
                    [self._store[tuple(int(x) for x in chunk[i])][1]
                     for i in conflicts])
                p_s = np.stack(
                    [self._store[tuple(int(x) for x in chunk[i])][2]
                     for i in conflicts])
                t_m, c_m, p_m = _merge_rows(
                    t_l, c_l, p_l, t_s, c_s, p_s,
                    max_weight=cfg.max_weight, prob_eps=cfg.prob_eps,
                )
                t_w = np.zeros((cpad, cfg.block_volume), np.float32)
                c_w = np.zeros((cpad, cfg.block_volume), np.uint32)
                p_w = np.zeros((cpad, cfg.block_volume), np.float32)
                t_w[:n_c], c_w[:n_c], p_w[:n_c] = t_m, c_m, p_m
                vol = vol.replace(
                    tsdf=vol.tsdf.at[crj].set(jnp.asarray(t_w), mode="drop"),
                    rgbw=vol.rgbw.at[crj].set(jnp.asarray(c_w), mode="drop"),
                    prob=vol.prob.at[crj].set(jnp.asarray(p_w), mode="drop"),
                )

            n_ok = int(ok.sum())
            if n_ok:
                # scatter stored payloads over the freshly-reset rows
                rows_p = np.full((pad,), cfg.num_blocks, np.int32)
                t_p = np.zeros((pad, cfg.block_volume), np.float32)
                c_p = np.zeros((pad, cfg.block_volume), np.uint32)
                p_p = np.zeros((pad, cfg.block_volume), np.float32)
                j = 0
                for i in range(m):
                    if not ok[i]:
                        continue
                    t, c, p = self._store[tuple(int(x) for x in chunk[i])]
                    rows_p[j] = after[i]
                    t_p[j], c_p[j], p_p[j] = t, c, p
                    j += 1
                rj = jnp.asarray(rows_p)
                vol = vol.replace(
                    tsdf=vol.tsdf.at[rj].set(jnp.asarray(t_p), mode="drop"),
                    rgbw=vol.rgbw.at[rj].set(jnp.asarray(c_p), mode="drop"),
                    prob=vol.prob.at[rj].set(jnp.asarray(p_p), mode="drop"),
                )
            # evict consumed entries: restored blocks AND merged
            # conflicts; insert-dropped blocks stay for the next pass
            for i in range(m):
                if ok[i] or not fresh[i]:
                    self._store.pop(tuple(int(x) for x in chunk[i]), None)
            restored += n_ok + int(conflicts.size)

        kept = int(cand.shape[0]) - restored
        logger.info(
            "[restore] %d blocks <- host store (%d in-window unplaced, "
            "%d still stored)", restored, kept, len(self._store),
        )
        return vol, restored

    # ------------------------------------------------------------------
    def spatial_records(self, cfg) -> np.ndarray:
        """[N, 4] (x, y, z, tsdf) world-metre records for every stored
        voxel, in the VoxelSpatialTSDF dump layout (voxel_types.cuh:33-41,
        ops/gather.py) — so a --save export can include spilled blocks
        instead of silently dumping only the on-device window."""
        if not self._store:
            return np.zeros((0, 4), np.float32)
        bl = cfg.block_len
        idx = np.arange(cfg.block_volume)
        mask = bl - 1
        offs = np.stack(
            [idx & mask, (idx >> cfg.block_len_log2) & mask,
             (idx >> (2 * cfg.block_len_log2)) & mask], axis=-1
        )  # same in-block order as core/voxel.py index_to_offset
        keys = np.array(list(self._store.keys()), np.int64)  # [M, 3]
        t = np.stack([v[0] for v in self._store.values()])  # [M, V]
        # f32 cast BEFORE the metre scale, exactly like ops/gather.py
        # _download (integer grid coords -> f32 -> * voxel_size)
        pos = (keys[:, None, :] * bl + offs[None, :, :]).astype(
            np.float32
        ) * np.float32(cfg.voxel_size)
        rec = np.concatenate(
            [pos.reshape(-1, 3), t.reshape(-1, 1)], axis=1
        )
        return rec.astype(np.float32)

    def save_npz(self, path: str) -> None:
        """Persist the store next to a volume checkpoint."""
        if self._store:
            keys = np.array(list(self._store.keys()), np.int32)
            t = np.stack([v[0] for v in self._store.values()])
            c = np.stack([v[1] for v in self._store.values()])
            p = np.stack([v[2] for v in self._store.values()])
        else:
            keys = np.zeros((0, 3), np.int32)
            t = np.zeros((0, 0), np.float32)
            c = np.zeros((0, 0), np.uint32)
            p = np.zeros((0, 0), np.float32)
        np.savez_compressed(path, keys=keys, tsdf=t, rgbw=c, prob=p)

    @classmethod
    def load_npz(cls, path: str) -> "HostBlockStore":
        z = np.load(path)
        store = cls()
        keys = z["keys"]
        for i in range(keys.shape[0]):
            store._store[tuple(int(x) for x in keys[i])] = (
                z["tsdf"][i], z["rgbw"][i], z["prob"][i],
            )
        return store
