"""Numpy golden oracle replicating the reference CUDA engine's semantics.

This is a *test oracle only* — a dict-based re-statement of the
reference's integration pipeline (voxel_tsdf.cu) used to validate the
JAX engine's outputs voxel-for-voxel.  It follows the CUDA logic
exactly: per-pixel DDA allocation gated on full-corner block visibility,
any-corner visibility gathering, weighted fusion with roundf-style
rounding, and min-|tsdf| space carving.  Inner loops are vectorized with
numpy for test-suite speed; semantics are unchanged.
"""

from __future__ import annotations

import numpy as np

BLOCK_LEN = 8
BLOCK_VOLUME = 512


def round_away(x):
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


class OracleVolume:
    def __init__(self, voxel_size, truncation, carve_threshold=0.9, max_weight=40.0):
        self.voxel_size = voxel_size
        self.truncation = truncation
        self.carve_threshold = carve_threshold
        self.max_weight = max_weight
        # block coord tuple -> dict of per-voxel arrays [512]
        self.blocks = {}
        # in-block voxel offsets, x fastest (OffsetToIndex layout)
        idx = np.arange(BLOCK_VOLUME)
        self._offsets = np.stack([idx & 7, (idx >> 3) & 7, (idx >> 6) & 7], -1)

    # -- helpers ------------------------------------------------------
    def _new_block(self):
        return {
            "tsdf": np.full(BLOCK_VOLUME, -1.0, np.float32),
            "weight": np.zeros(BLOCK_VOLUME, np.float32),
            "rgb": np.zeros((BLOCK_VOLUME, 3), np.float32),
            "prob": np.full(BLOCK_VOLUME, 0.5, np.float32),
        }

    def read(self, point):
        """Voxel payload at integer voxel coord (defaults on miss)."""
        p = np.asarray(point, np.int64)
        bk = tuple(p >> 3)
        off = p & 7
        idx = int(off[0] + off[1] * 8 + off[2] * 64)
        if bk in self.blocks:
            b = self.blocks[bk]
            return (
                float(b["tsdf"][idx]),
                b["rgb"][idx].copy(),
                float(b["weight"][idx]),
                float(b["prob"][idx]),
            )
        return 1.0, np.zeros(3), 0.0, 0.0

    def _blocks_visible(self, blocks, cam_T_world, K, w, h, full):
        """Vectorized is_block_visible over [N, 3] block coords."""
        fx, fy, cx, cy = K
        base = blocks.astype(np.float64) * BLOCK_LEN
        acc = None
        for i in range(8):
            corner = base + np.array(
                [(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
            ) * (BLOCK_LEN - 1)
            pw = corner * self.voxel_size
            pc = pw @ cam_T_world[:3, :3].T + cam_T_world[:3, 3]
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = (fx * pc[:, 0] + cx * z) / z
                v = (fy * pc[:, 1] + cy * z) / z
            vis = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z >= 0)
            vis = np.nan_to_num(vis, nan=False)
            acc = vis if acc is None else ((acc & vis) if full else (acc | vis))
        return acc

    # -- pipeline ------------------------------------------------------
    def integrate(self, rgb, depth, ht, lt, max_depth, K, cam_T_world):
        """One frame. K = (fx, fy, cx, cy); cam_T_world = 4x4."""
        h_img, w_img = depth.shape
        fx, fy, cx, cy = K
        world_T_cam = np.linalg.inv(cam_T_world)

        uu, vv = np.meshgrid(np.arange(w_img), np.arange(h_img))
        xc = (uu - cx) / fx
        yc = (vv - cy) / fy
        d2r = np.sqrt(xc**2 + yc**2 + 1.0)

        # ---- allocate (block_allocate_kernel, voxel_tsdf.cu:104-147) ----
        valid = (depth > 0) & (depth <= max_depth)
        pos_cam = np.stack([xc, yc, np.ones_like(xc)], -1)  # [H, W, 3]
        pos_world = (pos_cam * depth[..., None]) @ world_T_cam[:3, :3].T + world_T_cam[
            :3, 3
        ]
        ray_dir = (pos_cam / d2r[..., None]) @ world_T_cam[:3, :3].T
        start = (pos_world - ray_dir * self.truncation) / self.voxel_size
        ray = ray_dir * 2 * self.truncation / self.voxel_size
        n = np.ceil(np.max(np.abs(ray), -1) / BLOCK_LEN).astype(np.int64)
        step = ray / np.maximum(n, 1)[..., None]
        n_max = int(n[valid].max()) if valid.any() else 0
        cand = []
        for i in range(n_max + 1):
            p = start + step * i
            blk = (round_away(p).astype(np.int64) >> 3)
            ok = valid & (i <= n)
            cand.append(blk[ok])
        if cand:
            cand = np.unique(np.concatenate(cand), axis=0)
            new = np.array(
                [c for c in cand if tuple(c) not in self.blocks], np.int64
            ).reshape(-1, 3)
            if len(new):
                vis = self._blocks_visible(new, cam_T_world, K, w_img, h_img, True)
                for c in new[vis]:
                    self.blocks[tuple(c)] = self._new_block()

        # NOTE: the CUDA kernel checks full visibility per DDA sample of
        # *every* pixel; since visibility depends only on the block coord,
        # checking once per unique new block is equivalent.

        # ---- gather visible (any corner, check_visibility_kernel) ----
        if not self.blocks:
            return
        all_blocks = np.array(list(self.blocks.keys()), np.int64)
        vis = self._blocks_visible(all_blocks, cam_T_world, K, w_img, h_img, False)
        visible = [tuple(b) for b in all_blocks[vis]]

        # ---- fuse (tsdf_integrate_kernel, voxel_tsdf.cu:149-205) ----
        for b in visible:
            blk = self.blocks[b]
            pg = np.asarray(b, np.int64) * BLOCK_LEN + self._offsets  # [512, 3]
            pw = pg.astype(np.float64) * self.voxel_size
            pc = pw @ cam_T_world[:3, :3].T + cam_T_world[:3, 3]
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = round_away((fx * pc[:, 0] + cx * z) / z).astype(np.int64)
                v = round_away((fy * pc[:, 1] + cy * z) / z).astype(np.int64)
            in_img = (u >= 0) & (u < w_img) & (v >= 0) & (v < h_img)
            us = np.clip(u, 0, w_img - 1)
            vs = np.clip(v, 0, h_img - 1)
            d = depth[vs, us]
            sdf = d2r[vs, us] * (d - z)
            upd = in_img & (d > 0) & (d <= max_depth) & (sdf > -self.truncation)
            if not upd.any():
                continue
            tsdf_new = np.minimum(1.0, sdf / self.truncation)
            w_new = (1 - d / max_depth) * 4
            w_old = blk["weight"].astype(np.float64)
            w_c = np.where(upd, w_old + w_new, 1.0)
            rgb_new = rgb[vs, us].astype(np.float64)
            t_upd = (blk["tsdf"] * w_old + tsdf_new * w_new) / w_c
            rgb_upd = round_away(
                (blk["rgb"] * w_old[:, None] + rgb_new * w_new[:, None]) / w_c[:, None]
            )
            w_upd = np.minimum(round_away(w_old + w_new), self.max_weight)
            p_old = blk["prob"].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                # C powf semantics (powf(0,0)==1): zero-weight terms
                # contribute nothing even at base 0 (see ops/integrate.py)
                def _pow_log(x, e):
                    return np.where(e == 0.0, 0.0, e * np.log(x))

                e_old, e_new = w_old / w_c, w_new / w_c
                pos = np.exp(_pow_log(p_old, e_old) + _pow_log(ht[vs, us], e_new))
                neg = np.exp(
                    _pow_log(1 - p_old, e_old) + _pow_log(lt[vs, us], e_new)
                )
                den = pos + neg
                p_upd = np.where(den > 0, pos / np.where(den > 0, den, 1.0), p_old)
            blk["tsdf"] = np.where(upd, t_upd, blk["tsdf"]).astype(np.float32)
            blk["rgb"] = np.where(upd[:, None], rgb_upd, blk["rgb"]).astype(np.float32)
            blk["weight"] = np.where(upd, w_upd, blk["weight"]).astype(np.float32)
            blk["prob"] = np.where(upd, p_upd, blk["prob"]).astype(np.float32)

        # ---- space carving (space_carving_kernel) ----
        for b in visible:
            if np.min(np.abs(self.blocks[b]["tsdf"])) >= self.carve_threshold:
                del self.blocks[b]


def volume_metrics(vol, ovol: OracleVolume) -> dict:
    """Voxel-for-voxel agreement of a TSDFVolume with the oracle over
    every oracle block: missing blocks, weight-mismatch rate, mean tsdf
    and prob error on same-weight voxels, rate of rgb channels off by
    more than one level, and both live-block counts."""
    import jax.numpy as jnp

    from disinfect_slam.ops import hash as h

    coords = np.array(sorted(ovol.blocks.keys()), np.int32).reshape(-1, 3)
    pool = np.asarray(h.lookup(vol, jnp.asarray(coords)))
    found = pool >= 0
    rows = pool[found]
    ours_tsdf = np.asarray(vol.tsdf)[rows]  # [B, 512]
    ours_w = np.asarray(vol.weight)[rows]
    ours_rgb = np.asarray(vol.rgb)[rows]
    ours_p = np.asarray(vol.prob)[rows]
    kept = [tuple(c) for c in coords[found]]
    o_tsdf = np.stack([ovol.blocks[c]["tsdf"] for c in kept]).reshape(ours_tsdf.shape)
    o_w = np.stack([ovol.blocks[c]["weight"] for c in kept]).reshape(ours_w.shape)
    o_rgb = np.stack([ovol.blocks[c]["rgb"] for c in kept]).reshape(ours_rgb.shape)
    o_p = np.stack([ovol.blocks[c]["prob"] for c in kept]).reshape(ours_p.shape)
    same_w = ours_w == o_w
    return {
        "missing": int((~found).sum()),
        "w_mismatch": float((ours_w != o_w).mean()),
        "tsdf_l1": float(np.abs(ours_tsdf - o_tsdf)[same_w].mean()),
        "rgb_flip": float(
            (np.abs(ours_rgb - o_rgb)[same_w].max(-1) > 1.0).mean()
        ),
        "prob_l1": float(np.abs(ours_p - o_p)[same_w].mean()),
        "blocks": int(vol.num_active_blocks),
        "oracle_blocks": len(coords),
    }


def oracle_raycast(vol: OracleVolume, K, img_h, img_w, cam_T_world, max_depth,
                   step_size=None):
    """Numpy transcription of ray_cast_kernel (voxel_tsdf.cu:232-307).

    Returns (rgba u8 [H,W,4], normal u8 [H,W,4], hit bool [H,W]).
    """
    fx, fy, cx, cy = K
    if step_size is None:
        step_size = vol.truncation / 2.0
    world_T_cam = np.linalg.inv(cam_T_world)
    rgba = np.zeros((img_h, img_w, 4), np.uint8)
    normal = np.zeros((img_h, img_w, 4), np.uint8)
    hit = np.zeros((img_h, img_w), bool)

    def tsdf_at(p):
        return vol.read(np.asarray(p, np.int64))[0]

    max_step = int(np.ceil(max_depth / step_size))
    for y in range(img_h):
        for x in range(img_w):
            pos_cam = np.array([(x - cx) / fx, (y - cy) / fy, 1.0])
            ray_dir = world_T_cam[:3, :3] @ (pos_cam / np.linalg.norm(pos_cam))
            step = ray_dir * step_size / vol.voxel_size
            pos = world_T_cam[:3, 3] / vol.voxel_size
            prev = tsdf_at(round_away(pos))
            pos = pos + step
            for i in range(1, max_step):
                curr = tsdf_at(round_away(pos))
                if prev > 0 and curr <= 0 and prev - curr <= 1.5:
                    p1, p2 = pos - step, pos.copy()
                    mid = (p1 + p2) / 2
                    while np.dot(p1 - p2, p1 - p2) > 0.1:
                        if tsdf_at(round_away(mid)) < 0:
                            p2 = mid
                        else:
                            p1 = mid
                        mid = (p1 + p2) / 2
                    fg = round_away(mid).astype(np.int64)
                    _, rgb, _, prob = vol.read(fg)
                    grad = np.array([
                        tsdf_at(fg + [1, 0, 0]) - tsdf_at(fg + [-1, 0, 0]),
                        tsdf_at(fg + [0, 1, 0]) - tsdf_at(fg + [0, -1, 0]),
                        tsdf_at(fg + [0, 0, 1]) - tsdf_at(fg + [0, 0, -1]),
                    ])
                    nrm = np.linalg.norm(grad)
                    diff = max(np.dot(grad, -ray_dir) / nrm, 0) if nrm > 0 else 0.0
                    alpha = max(prob - 0.5, 0) / 0.5
                    rgba[y, x] = [
                        np.uint8(alpha * 255 + (1 - alpha) * rgb[0]),
                        np.uint8((1 - alpha) * rgb[1]),
                        np.uint8((1 - alpha) * rgb[2]),
                        255,
                    ]
                    s = (1 - alpha) * diff * 255
                    normal[y, x] = [np.uint8(alpha * 255 + s), np.uint8(s), np.uint8(s), 255]
                    hit[y, x] = True
                    break
                prev = curr
                pos = pos + step
    return rgba, normal, hit
