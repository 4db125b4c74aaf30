"""DenseSLAM: self-contained tracking + fusion (KinectFusion-style).

The reference cannot run without an external SLAM library for poses
(OpenVSLAM / ORB_SLAM3).  This module closes the loop in JAX:

  track:   projective point-to-plane ICP (systems/odometry.py) against
           a *model render* — the TSDF splatted to a depth map from the
           previous pose (ops/render_fast.py) — frame-to-model tracking,
           far less drift than frame-to-frame
  fuse:    the standard integrate step with the tracked pose
  render:  the updated model view feeds the next track

Everything is jitted JAX; the only host logic is the tracking-ok gate
(mirroring the reference's tracking-lost handling, online.cc:46).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops.integrate import FrameInput, integrate
from ..ops.render_fast import splat_render
from .odometry import ICPOdometry


class DenseSLAM:
    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        voxel_size: float = 0.01,
        truncation: float = 0.06,
        max_depth: float = 4.0,
        cfg: Optional[TSDFConfig] = None,
        max_rmse: float = 0.08,
        host_spill: bool = False,
        loop_closure: bool = False,
        kf_every: int = 10,
        lc_kwargs: Optional[dict] = None,
        track_res_scale: int = 1,
    ):
        # track_res_scale: run the WHOLE tracking path (model render +
        # ICP pyramid) at 1/scale resolution while fusion stays full
        # res.  scale=2 quarters the two dominant tracking costs (splat
        # patch work, per-iteration correspondence gathers); at 4 mm-1 cm
        # voxels the model depth is voxel-quantized anyway, so half-res
        # tracking loses little geometry (A/B: scripts/bench_dense_slam
        # --track-scale, trajectory deltas in test_dense_slam).
        import dataclasses

        if cfg is None:
            cfg = TSDFConfig(voxel_size=voxel_size, truncation=truncation)
        else:
            cfg = dataclasses.replace(cfg, voxel_size=voxel_size, truncation=truncation)
        self.cfg = cfg
        self.max_depth = float(max_depth)
        self.intrinsics = intrinsics
        self.cam = CameraParams.create(CameraIntrinsics.create(*intrinsics), img_h, img_w)
        self.volume = TSDFVolume.create(cfg)
        ts = int(track_res_scale)
        assert ts >= 1 and img_h % ts == 0 and img_w % ts == 0, (
            "track_res_scale must divide the image dims", ts, img_h, img_w)
        self.track_scale = ts
        fx, fy, cx, cy = intrinsics
        track_intr = (fx / ts, fy / ts, cx / ts, cy / ts)
        self.track_cam = CameraParams.create(
            CameraIntrinsics.create(*track_intr), img_h // ts, img_w // ts
        )
        self.tracker = ICPOdometry(
            track_intr, img_h // ts, img_w // ts, max_rmse=max_rmse
        )
        self.world_T_cam = np.eye(4, dtype=np.float32)
        self.frame_count = 0
        # per-frame device ok flags; lost_count resolves them lazily so
        # the steady-state loop never blocks on the gate.  Resolved
        # flags fold into _lost_resolved and the list drains (bounded
        # memory for long-running services)
        self._ok_flags: list = []
        self._lost_resolved = 0
        # host-RAM spill store across recenters (systems/block_streaming.py)
        self.spill_store = None
        if host_spill:
            from .block_streaming import HostBlockStore

            self.spill_store = HostBlockStore()
        # loop closure / relocalization (systems/loop_closure.py) — the
        # drift correction the reference inherits from ORB_SLAM3's loop
        # closing (disinfect_slam.cc:89).  Keyframe work syncs the
        # tracked pose to host, so it runs at kf_every cadence only.
        self.lc = None
        self._kf_every = int(kf_every)
        if loop_closure:
            from .loop_closure import LoopClosureManager

            self.lc = LoopClosureManager(
                intrinsics, img_h, img_w, kf_every=kf_every,
                **(lc_kwargs or {}),
            )

        cam = self.cam
        md = self.max_depth

        @jax.jit
        def _step(vol, frame, pose_mat):
            return integrate(vol, frame, cam, SE3.from_matrix(pose_mat), md)

        track_cam = self.track_cam

        @jax.jit
        def _model_depth(vol, pose_mat):
            d = splat_render(vol, track_cam, SE3.from_matrix(pose_mat), md).depth
            # validity-aware 3x3 smoothing: the splat depth is quantized
            # to voxel centers; the box filter removes the stair-step
            # bias that would otherwise pull ICP along the view axis.
            # HIGHEST: an f32 convolution may run in TF32 on the GPU,
            # which would round depths to ~1 mm at 4 m.
            valid = (d > 0).astype(jnp.float32)
            k = jnp.ones((3, 3), jnp.float32)
            hi = jax.lax.Precision.HIGHEST
            num = jax.scipy.signal.convolve2d(d * valid, k, mode="same", precision=hi)
            den = jax.scipy.signal.convolve2d(valid, k, mode="same", precision=hi)
            sm = jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)
            return jnp.where(valid > 0, sm, 0.0)

        self._step = _step
        self._model_depth = _model_depth

        tracker = self.tracker
        max_rmse = float(max_rmse)

        ts_static = self.track_scale

        @jax.jit
        def _track_frame(vol, prev_cam_T_world, depth, seed):
            # one program for render-model -> pyramids -> multilevel ICP:
            # the split form round-tripped the model depth through the
            # host (1.2 MB D2H + re-upload) and paid a dispatch+sync per
            # stage
            md_img = _model_depth(vol, prev_cam_T_world)
            pyr_ref = tracker._prep(md_img)
            if ts_static > 1:
                depth = depth[::ts_static, ::ts_static]
            pyr_cur = tracker._prep(depth)
            return tracker._track(seed, pyr_cur, pyr_ref, prev_cam_T_world)

        self._track_frame = _track_frame

        from functools import partial as _partial

        @_partial(jax.jit, donate_argnums=(0,))
        def _track_fuse(vol, world_T_cam_prev, frame, gyro_RT, dp_w):
            # THE steady-state step: track + accept-gate + fuse in ONE
            # dispatch.  The tracking-ok decision (rmse/inlier gate)
            # runs on device so no host sync sits between tracking and
            # fusion; on loss the volume fuses with the last-known pose
            # (the reference's keep-last-pose behavior, online.cc:46)
            # and the pose estimate is discarded.
            prev_cam_T_world = jnp.linalg.inv(world_T_cam_prev)
            seed = world_T_cam_prev.at[:3, :3].set(
                world_T_cam_prev[:3, :3] @ gyro_RT
            )
            # optional world-frame translation prior (IMU preintegration,
            # systems/imu.py relative_motion) on top of the rotation seed
            seed = seed.at[:3, 3].add(dp_w)
            T, rmse, inl = _track_frame(vol, prev_cam_T_world, frame.depth, seed)
            ok = jnp.isfinite(rmse) & (rmse < max_rmse) & (inl > 100)
            world_T_cam = jnp.where(ok, T, world_T_cam_prev)
            cam_T_world = jnp.linalg.inv(world_T_cam)
            vol = integrate(vol, frame, cam, SE3.from_matrix(cam_T_world), md)
            return vol, world_T_cam, cam_T_world, ok

        self._track_fuse = _track_fuse

    # ------------------------------------------------------------------
    def set_initial_pose(self, world_T_cam0: np.ndarray) -> None:
        """Anchor the world frame before the first frame — e.g. the
        gravity-aligned pose from ImuPreintegrator.gravity_aligned_pose
        (systems/imu.py) so maps come out level.  Only valid before
        process_frame has run."""
        assert self.frame_count == 0, "initial pose must precede frame 0"
        self.world_T_cam = np.asarray(world_T_cam0, np.float32)

    # ------------------------------------------------------------------
    def process_frame(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        ht: Optional[np.ndarray] = None,
        lt: Optional[np.ndarray] = None,
        gyro_prior: Optional[np.ndarray] = None,
        trans_prior: Optional[np.ndarray] = None,
    ):
        """Track + fuse one frame; returns (cam_T_world, tracking_ok) as
        DEVICE arrays — the steady-state path is ONE jitted dispatch
        with zero forced host syncs (the accept gate runs on device).
        Convert with np.asarray()/bool() only when you need the values;
        the trajectory can be resolved in bulk after the run.

        gyro_prior: optional cam1_R_cam0 from IMU preintegration
        (systems/imu.py) seeding the ICP initial pose through fast
        rotations.  trans_prior: optional world-frame camera translation
        [3] over the frame interval (ImuPreintegrator.relative_motion's
        delta_p) completing the SE3 seed through fast translations.
        """
        h, w = depth.shape
        if ht is None:
            ht = np.ones((h, w), np.float32)
        if lt is None:
            lt = np.ones((h, w), np.float32)
        frame = FrameInput(
            rgb=jnp.asarray(rgb, jnp.float32),
            depth=jnp.asarray(depth, jnp.float32),
            ht=jnp.asarray(ht, jnp.float32),
            lt=jnp.asarray(lt, jnp.float32),
        )

        if self.frame_count == 0:
            # world frame anchored at the first camera pose — optionally
            # gravity-aligned via set_initial_pose (systems/imu.py
            # ImuPreintegrator.gravity_aligned_pose)
            cam_T_world = jnp.asarray(
                np.linalg.inv(self.world_T_cam), jnp.float32
            )
            self.volume = self._step(self.volume, frame, cam_T_world)
            ok = jnp.asarray(True)
        else:
            gyro_RT = (
                jnp.asarray(gyro_prior, jnp.float32).T
                if gyro_prior is not None
                else jnp.eye(3, dtype=jnp.float32)
            )
            dp_w = (
                jnp.asarray(trans_prior, jnp.float32)
                if trans_prior is not None
                else jnp.zeros((3,), jnp.float32)
            )
            self.volume, self.world_T_cam, cam_T_world, ok = self._track_fuse(
                self.volume, jnp.asarray(self.world_T_cam, jnp.float32),
                frame, gyro_RT, dp_w,
            )
            self._ok_flags.append(ok)
            # bound the pending-flag buffers: by 1024 frames the early
            # flags are long computed, so the drain sync is free
            if len(self._ok_flags) >= 1024:
                self._drain_ok_flags()
        if self.lc is not None and self.frame_count % self._kf_every == 0:
            # keyframe cadence: ONE host sync per kf_every frames (the
            # steady-state frames in between stay sync-free).  The
            # manager enforces kf_every again internally (defense in
            # depth for direct API users); this outer gate exists to
            # avoid the host sync on non-keyframe frames.
            inten = np.asarray(rgb, np.float32)
            if inten.ndim == 3:
                inten = inten.mean(axis=-1)
            if bool(np.asarray(ok)):
                corr = self.lc.add_keyframe(
                    np.asarray(depth, np.float32),
                    np.asarray(self.world_T_cam, np.float32),
                    self.frame_count,
                    intensity=inten,
                )
                if corr is not None:
                    # continue tracking/fusing in the loop-consistent
                    # frame (the reference never re-warps its TSDF on an
                    # ORB_SLAM3 closure either — already-fused drift
                    # stays; the trajectory is corrected retroactively)
                    self.world_T_cam = (
                        corr @ np.asarray(self.world_T_cam, np.float32)
                    )
                    cam_T_world = jnp.asarray(
                        np.linalg.inv(self.world_T_cam), jnp.float32
                    )
            else:
                reloc = self.lc.relocalize(
                    np.asarray(depth, np.float32), intensity=inten
                )
                if reloc is not None:
                    self.world_T_cam = reloc
                    cam_T_world = jnp.asarray(
                        np.linalg.inv(reloc), jnp.float32
                    )
        self.frame_count += 1
        return cam_T_world, ok

    def maybe_recenter(self, margin_blocks: int | None = None) -> bool:
        """Dense backend: move the coverage window to follow the tracked
        camera when it nears the edge (ops/hash.py recenter_dense; no-op
        on the hash backend or far from the edge).  Reading the tracked
        pose forces a host sync, and a move recompiles the step — call
        at waypoint cadence (e.g. every ~30 frames), not per frame."""
        from ..ops.hash import (
            needs_recenter,
            recenter_dense,
            recenter_origin_for,
        )

        cfg = self.volume.cfg
        cam_pos = np.asarray(self.world_T_cam, np.float64)[:3, 3]
        if not needs_recenter(cfg, cam_pos, margin_blocks, self.max_depth):
            return False
        org = recenter_origin_for(cfg, cam_pos)
        if org == (cfg.grid_origin or (-(cfg.grid_side >> 1),) * 3):
            return False
        if self.spill_store is not None:
            import dataclasses

            new_cfg = dataclasses.replace(cfg, grid_origin=org)
            self.spill_store.spill_out_of_window(self.volume, new_cfg)
        self.volume = recenter_dense(self.volume, org)
        if self.spill_store is not None:
            # cap by pool headroom (see TSDFGrid.recenter)
            free = int(np.asarray(self.volume.num_free))
            room = max(0, free - int(0.05 * cfg.num_blocks))
            if room:
                self.volume, _ = self.spill_store.restore_into_window(
                    self.volume, max_restore=room
                )
        return True

    def _drain_ok_flags(self) -> None:
        if self._ok_flags:
            self._lost_resolved += int(
                np.sum(~np.asarray(jnp.stack(self._ok_flags)))
            )
            self._ok_flags.clear()

    @property
    def lost_count(self) -> int:
        """Number of tracking-lost frames so far (forces a sync on the
        pending flags; cheap, call it for reporting, not per frame)."""
        self._drain_ok_flags()
        return self._lost_resolved

    def correct_trajectory(
        self, frame_ids: np.ndarray, poses_cam_T_world: np.ndarray
    ) -> np.ndarray:
        """Retro-apply loop-closure corrections to a recorded trajectory
        (no-op without loop_closure=True)."""
        if self.lc is None:
            return poses_cam_T_world
        return self.lc.correct_trajectory(frame_ids, poses_cam_T_world)

    def save_map(self, path: str) -> None:
        """Keyframe/map database save — the save_map_database analogue
        (run_zed_native.cc:88).  Requires loop_closure=True."""
        assert self.lc is not None, "loop_closure=True required"
        self.lc.save(path)

    def load_map(self, path: str) -> None:
        assert self.lc is not None, "loop_closure=True required"
        self.lc.load(path)

    def render(self, cam_T_world: Optional[np.ndarray] = None):
        if cam_T_world is None:
            cam_T_world = np.linalg.inv(np.asarray(self.world_T_cam))
        return splat_render(
            self.volume, self.cam, SE3.from_matrix(jnp.asarray(cam_T_world)), self.max_depth
        )
