"""TSDFGrid: the host-facing engine object (API parity with
utils/tsdf/voxel_tsdf.cuh:32-124).

Owns a TSDFVolume pytree on device and the jitted step functions; methods
accept/return numpy.  The jitted integrate donates the volume so updates
happen in place in HBM; frames are staged with `jax.device_put` before
the step launches (the double-buffered analogue of the reference's two
async copy streams, voxel_tsdf.cu:357-373, falls out of XLA's async
dispatch: the next frame's H2D overlaps the current step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..ops import gather as gather_ops
from ..ops import raycast as raycast_ops
from ..ops.gather import BoundingCube, SpatialTSDF
from ..ops.integrate import FrameInput, integrate

logger = __import__("logging").getLogger("disinfect_slam.tsdf_grid")


class TSDFGrid:
    def __init__(
        self,
        voxel_size: float = 0.01,
        truncation: float = 0.06,
        cfg: Optional[TSDFConfig] = None,
        device=None,
        host_spill: bool = False,
    ):
        if cfg is None:
            cfg = TSDFConfig(voxel_size=voxel_size, truncation=truncation)
        else:
            cfg = dataclasses.replace(
                cfg, voxel_size=voxel_size, truncation=truncation
            )
        self.cfg = cfg
        self.device = device
        with jax.default_device(device) if device is not None else contextlib.nullcontext():
            self.volume = TSDFVolume.create(cfg)

        self._integrate = jax.jit(
            self._integrate_impl,
            static_argnames=("img_h", "img_w", "max_depth", "allocate"),
            donate_argnums=0,
        )
        self._raycast = jax.jit(
            self._raycast_impl,
            static_argnames=("img_h", "img_w", "max_depth"),
        )
        self._splat = jax.jit(
            self._splat_impl,
            static_argnames=("img_h", "img_w", "max_depth"),
        )
        self._gather_valid = jax.jit(gather_ops.gather_valid)
        self._integrate_stats = jax.jit(
            self._integrate_stats_impl,
            static_argnames=("img_h", "img_w", "max_depth", "allocate"),
            donate_argnums=0,
        )
        # out-of-coverage allocation watchdog (checked every N frames;
        # candidates beyond the dense grid / packed-coord extent are
        # dropped on device and accumulate in volume.oob_count)
        self._oob_tick = 0
        self._warned_oob = False
        # oob_count is cumulative; the watchdog warns on growth past
        # this baseline (recenter advances it so a move doesn't re-warn
        # about drops that predate the new window)
        self._oob_base = 0
        # functional state guard for concurrent host threads
        self._lock = threading.Lock()
        # host-RAM spill store for blocks evicted by recentering (the
        # reference's reserved-but-unbuilt CPU streaming mode,
        # voxel_mem.cuh:76-77) — see systems/block_streaming.py
        self.spill_store = None
        if host_spill:
            from .block_streaming import HostBlockStore

            self.spill_store = HostBlockStore()

    # ------------------------------------------------------------------
    @staticmethod
    def _integrate_impl(
        vol, frame, intr, pose_mat, img_h, img_w, max_depth, allocate=True
    ):
        intrinsics = CameraIntrinsics.create(intr[0], intr[1], intr[2], intr[3])
        cam = CameraParams.create(intrinsics, img_h, img_w)
        return integrate(
            vol, frame, cam, SE3.from_matrix(pose_mat), max_depth,
            allocate=allocate,
        )

    @staticmethod
    def _integrate_stats_impl(
        vol, frame, intr, pose_mat, img_h, img_w, max_depth, allocate=True
    ):
        intrinsics = CameraIntrinsics.create(intr[0], intr[1], intr[2], intr[3])
        cam = CameraParams.create(intrinsics, img_h, img_w)
        return integrate(
            vol, frame, cam, SE3.from_matrix(pose_mat), max_depth,
            return_stats=True, allocate=allocate,
        )

    @staticmethod
    def _raycast_impl(vol, intr, pose_mat, img_h, img_w, max_depth):
        intrinsics = CameraIntrinsics.create(intr[0], intr[1], intr[2], intr[3])
        cam = CameraParams.create(intrinsics, img_h, img_w)
        return raycast_ops.raycast(vol, cam, SE3.from_matrix(pose_mat), max_depth)

    @staticmethod
    def _splat_impl(vol, intr, pose_mat, img_h, img_w, max_depth):
        from ..ops.render_fast import splat_render

        intrinsics = CameraIntrinsics.create(intr[0], intr[1], intr[2], intr[3])
        cam = CameraParams.create(intrinsics, img_h, img_w)
        return splat_render(vol, cam, SE3.from_matrix(pose_mat), max_depth)

    # ------------------------------------------------------------------
    def integrate(
        self,
        img_rgb: np.ndarray,
        img_depth: np.ndarray,
        img_ht: Optional[np.ndarray],
        img_lt: Optional[np.ndarray],
        max_depth: float,
        intrinsics: Tuple[float, float, float, float],
        cam_T_world: np.ndarray,
    ) -> None:
        """TSDFGrid::Integrate (voxel_tsdf.cu:347-375)."""
        h, w = img_depth.shape
        if img_ht is None:
            img_ht = np.ones((h, w), np.float32)
        if img_lt is None:
            img_lt = np.ones((h, w), np.float32)
        frame = FrameInput(
            rgb=jnp.asarray(img_rgb, jnp.float32),
            depth=jnp.asarray(img_depth, jnp.float32),
            ht=jnp.asarray(img_ht, jnp.float32),
            lt=jnp.asarray(img_lt, jnp.float32),
        )
        intr = jnp.asarray(intrinsics, jnp.float32)
        pose = jnp.asarray(cam_T_world, jnp.float32)
        debug = logger.isEnabledFor(10)  # DEBUG: forces a device sync
        with self._lock:
            if debug:
                logger.debug(
                    "[TSDF] pre integrate: %d active blocks",
                    int(self.volume.num_active_blocks),
                )
            if debug:
                # stats variant: same step + the visible-count scalar;
                # same allocate gate as the production branch: DEBUG
                # logging must observe, not change, the reconstruction
                self.volume, stats = self._integrate_stats(
                    self.volume, frame, intr, pose,
                    img_h=h, img_w=w, max_depth=float(max_depth),
                    allocate=self._oob_tick % self.cfg.alloc_every == 0,
                )
                logger.debug(
                    "[TSDF] visible blocks: %d",
                    int(np.asarray(stats.visible_count)),
                )
            else:
                # cfg.alloc_every: allocation runs on every N-th frame
                # (frame 0 always allocates); fusion runs every frame
                self.volume = self._integrate(
                    self.volume, frame, intr, pose,
                    img_h=h, img_w=w, max_depth=float(max_depth),
                    allocate=self._oob_tick % self.cfg.alloc_every == 0,
                )
            if debug:
                logger.debug(
                    "[TSDF] post integrate: %d active blocks",
                    int(self.volume.num_active_blocks),
                )
            # scene-extent watchdog: the reference's hash maps unbounded
            # coordinates (voxel_hash.cuh:13-25); the dense backend is
            # bounded, so dropping candidates must be LOUD, not silent.
            # The device-scalar read only syncs on the frame just
            # dispatched, and only every 30 frames until it fires.
            self._oob_tick += 1
            if not self._warned_oob and self._oob_tick % 30 == 0:
                oob = int(np.asarray(self.volume.oob_count)) - self._oob_base
                if oob:
                    cfg = self.cfg
                    extent = cfg.grid_side * cfg.block_len * cfg.voxel_size
                    logger.warning(
                        "[TSDF] %d allocation candidates fell OUTSIDE the "
                        "mapped extent (%s backend, %.1f m per axis) and "
                        "were dropped — the map is truncated. Raise "
                        "grid_log2/coord_bits or move grid_origin.",
                        oob, cfg.backend, extent,
                    )
                    self._warned_oob = True

    def ray_cast(
        self,
        max_depth: float,
        virtual_cam: Tuple[Tuple[float, float, float, float], int, int],
        cam_T_world: np.ndarray,
        renderer: str = "raycast",
    ) -> raycast_ops.RaycastResult:
        """TSDFGrid::RayCast (voxel_tsdf.cu:490-506). virtual_cam =
        ((fx, fy, cx, cy), img_h, img_w).

        The default is the parity ray marcher (exact ray_cast_kernel
        semantics incl. trilinear refinement).  renderer="splat" selects
        the scatter-based fast path (same image conventions, different
        algorithm: geometry within ~1 voxel, see ops/render_fast.py)."""
        intr, img_h, img_w = virtual_cam
        fn = self._splat if renderer == "splat" else self._raycast
        # hold the lock across the dispatch: integrate donates the volume
        # buffers, so a read enqueued after the donation would hit a
        # deleted array (the reference serializes the same way with
        # mtx_read_, tsdf_module.cc:40-49)
        with self._lock:
            res = fn(
                self.volume,
                jnp.asarray(intr, jnp.float32),
                jnp.asarray(cam_T_world, jnp.float32),
                img_h=int(img_h),
                img_w=int(img_w),
                max_depth=float(max_depth),
            )
        # splat paths cap surface blocks; dropped geometry must be
        # observable (ADVICE r2).  The sync this read forces is gated on
        # debug logging, like the integrate block-count gauges above.
        if logger.isEnabledFor(10) and res.surf_overflow is not None:
            ov = int(np.asarray(res.surf_overflow))
            if ov:
                logger.debug(
                    "[TSDF] splat surf_cap exceeded: %d surface blocks "
                    "dropped from this render", ov
                )
        return res

    def gather_valid(self) -> SpatialTSDF:
        """TSDFGrid::GatherValid (voxel_tsdf.cu:399-425)."""
        with self._lock:
            return self._gather_valid(self.volume)

    def gather_voxels(self, volume: BoundingCube) -> SpatialTSDF:
        """TSDFGrid::GatherVoxels (voxel_tsdf.cu:427-454)."""
        with self._lock:
            return gather_ops.gather_voxels(self.volume, volume)

    def snapshot(self) -> TSDFVolume:
        """Consistent on-device copy of the volume for long-running
        readers (mesh extraction, export) that must not hold the
        integration lock: integrate donates its input buffers, so raw
        references go stale."""
        with self._lock:
            return jax.tree.map(lambda x: x.copy(), self.volume)

    def recenter(self, center_world_m) -> bool:
        """Move the dense directory window so `center_world_m` (metres,
        e.g. the robot's position) sits at its center — the escape hatch
        when a long drive approaches the +-grid_side/2 coverage edge
        (ops/hash.py recenter_dense; the hash backend needs none: it is
        coordinate-unbounded like the reference's).  Voxel payloads and
        absolute coordinates are untouched; blocks leaving the window
        are released.  Returns True if the window actually moved.

        A move changes cfg (a new jit specialization of the step), so
        call at waypoint cadence, not per frame."""
        if self.cfg.backend != "dense":
            return False
        from ..ops.hash import recenter_dense, recenter_origin_for

        g = self.cfg.grid_side
        org = recenter_origin_for(self.cfg, center_world_m)
        with self._lock:
            if org == (self.cfg.grid_origin or (-(g >> 1),) * 3):
                return False
            if self.spill_store is not None:
                new_cfg = dataclasses.replace(self.cfg, grid_origin=org)
                self.spill_store.spill_out_of_window(self.volume, new_cfg)
            self.volume = recenter_dense(self.volume, org)
            self.cfg = self.volume.cfg
            if self.spill_store is not None:
                # cap by pool headroom: an uncapped bulk restore after a
                # long paged drive would re-exhaust the pool and undo
                # maybe_page's eviction work
                free = int(np.asarray(self.volume.num_free))
                room = max(0, free - int(0.05 * self.cfg.num_blocks))
                if room:
                    self.volume, _ = self.spill_store.restore_into_window(
                        self.volume, max_restore=room
                    )
            # coverage moved: allow the watchdog to warn again, but only
            # about drops AFTER the move (oob_count is cumulative)
            self._warned_oob = False
            self._oob_base = int(np.asarray(self.volume.oob_count))
            logger.info(
                "[TSDF] recentered dense window to origin %s blocks", org
            )
            return True

    def maybe_recenter(
        self,
        cam_pos_world_m,
        margin_blocks: int | None = None,
        max_depth: float | None = None,
    ) -> bool:
        """Recenter only when the camera is within the margin of the
        window edge (pure host arithmetic when no move is needed — safe
        to call per frame; the actual move recompiles, see recenter).

        The margin should cover the view frustum: observations past the
        edge are dropped until the move happens, so pass `max_depth` to
        derive margin = ceil(max_depth / block metres) — the window then
        moves BEFORE the frustum outruns it.  Fallback margin is a
        quarter of the window; either is capped at 3/8 window so a
        frustum larger than the window cannot retrigger every frame."""
        from ..ops.hash import needs_recenter

        if not needs_recenter(
            self.cfg, cam_pos_world_m, margin_blocks, max_depth
        ):
            return False
        return self.recenter(cam_pos_world_m)

    def maybe_page(
        self,
        cam_pos_world_m,
        radius_m: float,
        min_free_frac: float = 0.05,
        target_free_frac: float = 0.15,
    ) -> Tuple[int, int]:
        """Pool-pressure paging against the host spill store (requires
        host_spill=True): restore stored blocks within radius_m of the
        camera while pool room allows, then — if free blocks fall below
        min_free_frac of the pool — evict the farthest live blocks
        (beyond radius_m when possible) until target_free_frac is free.

        The reference's pool simply stops allocating when exhausted
        (voxel_mem.cu AquireBlock); with paging, a bounded pool maps an
        unbounded drive and revisited areas come back voxel-for-voxel.
        Reads num_free (a host sync) — call at waypoint cadence, like
        maybe_recenter.  Returns (restored, evicted)."""
        if self.spill_store is None:
            return (0, 0)
        with self._lock:
            b = self.cfg.num_blocks
            free = int(np.asarray(self.volume.num_free))
            restored = evicted = 0
            # evict first: after a long drive the pool is full of FAR
            # blocks, and the near restores need their rows
            if free < min_free_frac * b:
                n_evict = int(target_free_frac * b) - free
                self.volume, evicted = self.spill_store.spill_cold(
                    self.volume, cam_pos_world_m, n_evict,
                    keep_radius_m=radius_m,
                )
                free = int(np.asarray(self.volume.num_free))
            room = free - int(min_free_frac * b)
            if room > 0 and len(self.spill_store):
                self.volume, restored = self.spill_store.restore_into_window(
                    self.volume, center_m=cam_pos_world_m,
                    radius_m=radius_m, max_restore=room,
                )
            return (restored, evicted)

    def num_active_blocks(self) -> int:
        with self._lock:
            return int(self.volume.num_active_blocks)

    def block_until_ready(self) -> None:
        with self._lock:
            jax.block_until_ready(self.volume.tsdf)

