"""One-dispatch online semantic fusion step.

The reference's online pipeline runs segmentation and TSDF integration
as separate GPU programs with a host round trip between them
(examples/tsdf/online.cc:23-70: infer_one -> cv::Mat -> TSDFSystem
queue -> Integrate).

Here the whole per-frame path is ONE jitted program:

    rgb, depth, pose --H2D--> [ seg forward -> ht/lt -> integrate ] -> volume'

so the semantic maps never leave the device and the online path costs one
dispatch + one H2D per frame.  The seg contract matches
InferenceEngine (models/segmentation.py): resize to 640x352, forward,
sigmoid, resize of the 2-channel probability map back to the frame
size (directly to the depth resolution, collapsing the reference's
640x360 intermediate — a linear resize of a probability map, values
within interpolation tolerance of the two-stage form).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TSDFConfig
from ..core.geometry import SE3, CameraIntrinsics, CameraParams
from ..core.state import TSDFVolume
from ..models.segmentation import INFER_H, INFER_W, resize_linear
from ..ops.integrate import FrameInput, integrate


class FusedOnlineStep:
    """Owns a volume and a single jitted rgb+depth+pose -> volume step.

    seg_model/seg_params None = no-segmentation mode (ht/lt all-ones,
    the online_no_seg.cc contract, tsdf_module.cc:32-33).
    """

    def __init__(
        self,
        cfg: TSDFConfig,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        max_depth: float,
        seg_model=None,
        seg_params=None,
        depth_factor: float = 1000.0,
        split_dispatch: bool = False,
    ):
        self.cfg = cfg
        self.img_h, self.img_w = img_h, img_w
        self.max_depth = float(max_depth)
        self.depth_factor = float(depth_factor)
        depth_factor = self.depth_factor
        intr = CameraIntrinsics.create(*intrinsics)
        cam = CameraParams.create(intr, img_h, img_w)
        self.volume = TSDFVolume.create(cfg)
        model, params = seg_model, seg_params
        self._seg_params = params
        self.split_dispatch = bool(split_dispatch and model is not None)

        def _seg(seg_p, rgb):
            # rgb f32 [H, W, 3] in [0, 255] -> (ht, lt) f32 [H, W]
            x = resize_linear(rgb, INFER_H, INFER_W) / 255.0
            logits = model.apply(seg_p, x[None])[0]
            probs = jax.nn.sigmoid(logits)
            probs = resize_linear(probs, img_h, img_w)
            return probs[..., 0], probs[..., 1]

        @partial(jax.jit, donate_argnums=0, static_argnames=("allocate",))
        def _step(vol, seg_p, rgb, depth, pose_mat, allocate=True):
            # Sensor-format inputs convert ON DEVICE (the jit
            # specializes per dtype): u8 rgb and u16 depth upload 3.3x
            # fewer bytes than f32 — the formats the reference's sensors
            # deliver (l515.cc:9-13 Z16 depth + RGB8 color).
            if rgb.dtype != jnp.float32:
                rgb = rgb.astype(jnp.float32)
            if depth.dtype == jnp.uint16:
                depth = depth.astype(jnp.float32) / depth_factor
            # rgb f32 [H, W, 3] in [0, 255]; depth f32 [H, W] metres
            if model is not None:
                with jax.named_scope("seg"):
                    ht, lt = _seg(seg_p, rgb)
            else:
                ht = jnp.ones_like(depth)
                lt = jnp.ones_like(depth)
            frame = FrameInput(rgb=rgb, depth=depth, ht=ht, lt=lt)
            return integrate(
                vol, frame, cam, SE3.from_matrix(pose_mat), max_depth,
                allocate=allocate,
            )

        # Split-dispatch mode: seg forward and fusion as TWO programs
        # with a device-resident (ht, lt) handoff.  The one-dispatch
        # form is usually right, but composing some seg architectures
        # with the fusion program can degrade the compiled convolutions;
        # two dispatches keep each program's layout assignment clean at
        # the cost of one extra dispatch.
        @jax.jit
        def _seg_only(seg_p, rgb):
            if rgb.dtype != jnp.float32:
                rgb = rgb.astype(jnp.float32)
            return _seg(seg_p, rgb)

        @partial(jax.jit, donate_argnums=0, static_argnames=("allocate",))
        def _fuse_only(vol, rgb, depth, ht, lt, pose_mat, allocate=True):
            if rgb.dtype != jnp.float32:
                rgb = rgb.astype(jnp.float32)
            if depth.dtype == jnp.uint16:
                depth = depth.astype(jnp.float32) / depth_factor
            frame = FrameInput(rgb=rgb, depth=depth, ht=ht, lt=lt)
            return integrate(
                vol, frame, cam, SE3.from_matrix(pose_mat), max_depth,
                allocate=allocate,
            )

        self._step = _step
        self._seg_only = _seg_only
        self._fuse_only = _fuse_only
        self._tick = 0

    # ------------------------------------------------------------------
    def step_device(self, rgb, depth, pose_mat) -> None:
        """Advance one frame from already-staged device arrays.

        Honors cfg.alloc_every (fusion every frame, allocation on every
        N-th — see config.py for the fail-open latency argument)."""
        allocate = self._tick % max(self.cfg.alloc_every, 1) == 0
        self._tick += 1
        if self.split_dispatch:
            ht, lt = self._seg_only(self._seg_params, rgb)
            self.volume = self._fuse_only(
                self.volume, rgb, depth, ht, lt, pose_mat, allocate=allocate,
            )
            return
        self.volume = self._step(
            self.volume, self._seg_params, rgb, depth, pose_mat,
            allocate=allocate,
        )

    def step(self, rgb: np.ndarray, depth: np.ndarray, pose: np.ndarray) -> None:
        """Advance one frame from host arrays (H2D included — this is
        the honest online path; staging is async so the upload of frame
        t+1 overlaps the compute of frame t).

        rgb u8 and depth u16 (raw sensor counts, scaled by depth_factor
        on device) upload as-is; f32 inputs are accepted unchanged."""
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        if rgb.dtype != np.uint8:
            rgb = rgb.astype(np.float32)
        if depth.dtype != np.uint16:
            depth = depth.astype(np.float32)
        self.step_device(
            jax.device_put(rgb),
            jax.device_put(depth),
            jax.device_put(np.asarray(pose, np.float32)),
        )

    def block_until_ready(self) -> None:
        jax.block_until_ready(self.volume.tsdf)

    def num_active_blocks(self) -> int:
        return int(self.volume.num_active_blocks)
