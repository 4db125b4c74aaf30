"""Loop closure, relocalization, and map persistence for the built-in
tracker.

The reference inherits all of this from ORB_SLAM3 / OpenVSLAM: the
external tracker runs bag-of-words place recognition, loop closing with
pose-graph optimization, relocalization after tracking loss, and map
database save/load (disinfect_slam.cc:89 `SLAM_->TrackStereo`,
modules/slam_module.cc:100-120, examples/visual_slam/run_zed_native.cc:88
`SLAM.save_map_database`).  The built-in DenseSLAM tracker
(systems/dense_slam.py) is frame-to-model only — unbounded drift on long
trajectories, no recovery after loss.  This module closes that gap
in JAX:

  keyframes     every K-th tracked frame stores a compact descriptor +
                a half-res depth map + its pose estimate
  place recog   descriptor matching is ONE matmul over the whole
                keyframe database ([cap, D] @ [D]) — the
                bag-of-words analogue, built from valid-aware cell
                means of the depth image (viewpoint-tolerant enough for
                the revisit-same-corridor case loop closure exists for)
  verification  candidate matches are confirmed geometrically by the
                SAME multi-level projective ICP the tracker runs
                (systems/odometry.py), frame(now) against frame(kf), at
                half resolution; the converged transform IS the loop
                constraint (rmse/inlier gated, like tracking itself)
  pose graph    keyframe poses + odometry edges + loop edges, relaxed
                by damped Gauss-Newton entirely in JAX: residuals are
                se3-log of edge misclosures, the Jacobian comes from
                jacfwd, and the normal equations solve on device.
                Static capacity padding keeps shapes compile-stable.
  correction    the newest keyframe's optimized-vs-estimated delta is
                applied to the live tracker pose, so fusion continues
                in the loop-consistent frame.  Like the reference
                (which never re-warps its TSDF on an ORB_SLAM3 loop
                closure either), already-fused drifted geometry stays;
                the trajectory output is corrected retroactively.
  reloc + map   after tracking loss the same match+verify pipeline
                re-seeds the pose against the keyframe database, which
                saves/loads as one npz — the save_map_database
                analogue, and it works across sessions.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import CameraParams
from .odometry import ICPOdometry, _exp_se3

# f32 matmuls at HIGHEST precision: on the GPU an f32 dot may otherwise
# run in TF32 (10-bit mantissa), which would perturb descriptor scores
# near the match threshold and the pose-graph normal equations, whose
# Gauss-Newton steps are small differences of large terms.
_HIGHEST = jax.lax.Precision.HIGHEST
_mm = functools.partial(jnp.matmul, precision=_HIGHEST)

# descriptor grid: 12x16 cells of (valid-aware mean depth, valid
# fraction, mean intensity) -> 576-dim, unit-norm (cosine similarity).
# The intensity cells are the appearance channel the reference's BoW
# place recognition has and a depth-only descriptor lacks: two
# geometrically identical rooms (the perceptual-aliasing case of
# repetitive corridors) differ only in texture, so without appearance
# the matcher would close a false loop (test_loop_closure's aliasing
# fixture).  RGB already arrives with every frame (online.cc:23-70).
DESC_GH, DESC_GW = 12, 16
DESC_DIM = DESC_GH * DESC_GW * 3
# geometry-only descriptor width of databases saved before the
# appearance channel existed (load() zero-pads them)
_DESC_DIM_V1 = DESC_GH * DESC_GW * 2


# ----------------------------------------------------------------------
# SE3 log / exp on 4x4 matrices (the pose-graph state)
# ----------------------------------------------------------------------
def _exp_se3_mat(xi: jnp.ndarray) -> jnp.ndarray:
    """se3 exp to a 4x4 matrix, DIFFERENTIABLE at xi=0.

    odometry._exp_se3 normalizes the axis (norm(0) has a NaN gradient);
    the pose graph jacfwd's through exp at exactly xi=0 every iteration,
    so this version uses the unnormalized-skew Rodrigues form with
    series coefficients below theta^2 = 1e-4 (double-where safe)."""
    omega, v = xi[:3], xi[3:]
    t2 = jnp.sum(omega * omega)
    ox = jnp.array(
        [
            [0.0, -omega[2], omega[1]],
            [omega[2], 0.0, -omega[0]],
            [-omega[1], omega[0], 0.0],
        ],
        jnp.float32,
    )
    small = t2 < 1e-4
    t2s = jnp.where(small, 1.0, t2)
    theta = jnp.sqrt(t2s)
    s, c = jnp.sin(theta), jnp.cos(theta)
    a = jnp.where(small, 1.0 - t2 / 6.0, s / theta)  # sin/theta
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - c) / t2s)
    cc = jnp.where(
        small, 1.0 / 6.0 - t2 / 120.0, (theta - s) / (t2s * theta)
    )
    ox2 = _mm(ox, ox)
    r = jnp.eye(3) + a * ox + b * ox2
    t = _mm(jnp.eye(3) + b * ox + cc * ox2, v)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(r)
    return m.at[:3, 3].set(t)


def _so3_log(r: jnp.ndarray) -> jnp.ndarray:
    """SO3 log: rotation matrix -> axis-angle vector [3].

    Written to be DIFFERENTIABLE at theta=0 (the pose graph jacfwd's
    through this at identity misclosures): no arccos (infinite slope at
    1) and no norm-of-zero — the small branch is a series in the smooth
    quantity |vee|^2, and the large branch's inputs are swapped to safe
    values where untaken so NaN can't leak through the where (the
    standard JAX double-where pattern).  Loop misclosures are small
    rotations, far from theta=pi."""
    vee = jnp.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]],
        jnp.float32,
    )  # = 2 sin(theta) * axis
    cos_t = jnp.clip((jnp.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    s2 = jnp.sum(vee * vee)  # = 4 sin^2(theta), smooth in r
    small = s2 < 4e-4  # sin(theta) < 0.01
    s2_safe = jnp.where(small, 1.0, s2)
    sin_t = 0.5 * jnp.sqrt(s2_safe)
    theta = jnp.arctan2(sin_t, cos_t)
    # theta/(2 sin) = 0.5 + theta^2/12 + ...; theta^2 ~= s2/4 near 0
    fac = jnp.where(small, 0.5 + s2 / 48.0, theta / (2.0 * sin_t))
    return fac * vee


def _se3_log(m: jnp.ndarray) -> jnp.ndarray:
    """SE3 log: 4x4 -> xi = (omega[3], v[3]); inverse of _exp_se3_mat.

    Same differentiable-at-identity construction as _so3_log: V^-1 is
    built from the UNnormalized skew (no axis normalization, no division
    by a vanishing theta), with the coefficient series-expanded in
    theta^2 below the f32 cancellation floor of 1-cos."""
    omega = _so3_log(m[:3, :3])
    t2 = jnp.sum(omega * omega)
    ox = jnp.array(
        [
            [0.0, -omega[2], omega[1]],
            [omega[2], 0.0, -omega[0]],
            [-omega[1], omega[0], 0.0],
        ],
        jnp.float32,
    )
    small = t2 < 1e-4
    t2_safe = jnp.where(small, 1.0, t2)
    theta = jnp.sqrt(t2_safe)
    s, c = jnp.sin(theta), jnp.cos(theta)
    # (1 - theta sin / (2 (1-cos))) / theta^2 -> 1/12 + theta^2/720 + ...
    coef = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - theta * s / (2.0 * (1.0 - c))) / t2_safe,
    )
    v_inv = jnp.eye(3) - 0.5 * ox + coef * _mm(ox, ox)
    return jnp.concatenate([omega, _mm(v_inv, m[:3, 3])])


def _inv_rigid(m: jnp.ndarray) -> jnp.ndarray:
    """Exact inverse of a rigid 4x4 (R^T | -R^T t)."""
    rt = m[..., :3, :3].swapaxes(-1, -2)
    t = jnp.einsum("...ij,...j->...i", rt, -m[..., :3, 3], precision=_HIGHEST)
    out = jnp.zeros_like(m).at[..., 3, 3].set(1.0)
    out = out.at[..., :3, :3].set(rt)
    return out.at[..., :3, 3].set(t)


# ----------------------------------------------------------------------
# Place-recognition descriptor + matcher
# ----------------------------------------------------------------------
def _unit(v: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(v)
    return v / jnp.where(n > 0, n, 1.0)


@functools.partial(jax.jit, static_argnames=("gh", "gw"))
def depth_descriptor(
    depth: jnp.ndarray,
    intensity: jnp.ndarray | None = None,
    gh: int = DESC_GH,
    gw: int = DESC_GW,
) -> jnp.ndarray:
    """[H, W] depth (+ optional [H, W] intensity) -> unit-norm
    descriptor [gh*gw*3].

    Valid-aware cell means + valid fractions (geometry) plus mean
    intensity per cell (appearance); the whole-database comparison is
    one matmul.  The bag-of-words analogue for the built-in tracker.
    Geometry and appearance halves are zero-meaned and unit-normed
    separately, then concatenated at weight 1/sqrt(2) each, so cosine
    similarity needs BOTH to agree: identical geometry with different
    texture tops out at ~0.5 + 0.5*sim_intensity — under any sane
    threshold (the perceptual-aliasing guard).  intensity=None fills
    the appearance half with zeros (geometry-only legacy databases)."""
    h, w = depth.shape
    ch, cw = h // gh, w // gw
    d = depth[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    valid = (d > 0).astype(jnp.float32)
    cnt = valid.sum(axis=(1, 3))
    mean = d.sum(axis=(1, 3)) / jnp.maximum(cnt, 1.0)
    frac = cnt / float(ch * cw)
    geo = jnp.concatenate([mean.reshape(-1), frac.reshape(-1)])
    geo = _unit(geo - jnp.mean(geo))
    if intensity is None:
        app = jnp.zeros((gh * gw,), jnp.float32)
        # keep the geometry half at full weight so legacy geometry-only
        # descriptors compare to each other with the old similarity
        return jnp.concatenate([geo, app])
    ii = intensity[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw)
    imean = ii.mean(axis=(1, 3)).reshape(-1)
    app = _unit(imean - jnp.mean(imean))
    inv_s2 = 0.7071067811865476
    return jnp.concatenate([geo * inv_s2, app * inv_s2])


@jax.jit
def _match_scores(
    desc: jnp.ndarray,  # [D]
    db_desc: jnp.ndarray,  # [cap, D]
    db_ids: jnp.ndarray,  # [cap] i32 frame ids
    count: jnp.ndarray,  # scalar i32
    cur_id: jnp.ndarray,  # scalar i32
    min_gap: jnp.ndarray,  # scalar i32 (frame-id gap; <=0 disables)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cosine similarity of desc vs the whole database (one matmul),
    masked to live slots older than min_gap; returns (best_idx, score)."""
    scores = _mm(db_desc, desc)
    idx = jnp.arange(db_desc.shape[0], dtype=jnp.int32)
    ok = (idx < count) & ((cur_id - db_ids) >= min_gap)
    scores = jnp.where(ok, scores, -2.0)
    best = jnp.argmax(scores)
    return best, scores[best]


# ----------------------------------------------------------------------
# Pose-graph optimization (damped Gauss-Newton, all-JAX)
# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    poses: jnp.ndarray,  # [N, 4, 4] world_T_cam per node
    ei: jnp.ndarray,  # [E] i32 edge source node
    ej: jnp.ndarray,  # [E] i32 edge target node
    z: jnp.ndarray,  # [E, 4, 4] measured inv(T_i) @ T_j
    w: jnp.ndarray,  # [E] f32 edge weight (0 = padding)
    iters: int = 12,
    damping: float = 1e-4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Relax keyframe poses against relative-pose constraints.

    Per edge the residual is se3_log(Z^-1 inv(T_i) T_j) — zero when the
    estimated relative pose agrees with the measurement.  Each iteration
    linearizes with jacfwd around xi=0 (left-multiplicative updates
    T <- exp(xi) T), assembles the damped normal equations, and solves
    on device.  Node 0 is gauge-anchored with a strong prior residual;
    padded nodes are held by the damping term.  Returns (optimized
    poses, per-iteration costs)."""
    n = poses.shape[0]

    def residuals(xi: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
        t = jax.vmap(lambda x, m: _mm(_exp_se3_mat(x), m))(xi, p)
        rel = jnp.einsum(
            "eab,ebc->eac", _inv_rigid(t[ei]), t[ej], precision=_HIGHEST
        )
        mis = jnp.einsum("eab,ebc->eac", _inv_rigid(z), rel, precision=_HIGHEST)
        r = jax.vmap(_se3_log)(mis) * w[:, None]
        anchor = xi[0] * 1e3  # gauge fix: node 0 stays put
        return jnp.concatenate([r.reshape(-1), anchor])

    def gn_step(p, _):
        f = lambda xi: residuals(xi, p)  # noqa: E731
        xi0 = jnp.zeros((n, 6), jnp.float32)
        r0 = f(xi0)
        jac = jax.jacfwd(f)(xi0).reshape(r0.shape[0], n * 6)
        h = _mm(jac.T, jac) + damping * jnp.eye(n * 6, dtype=jnp.float32)
        dx = -jnp.linalg.solve(h, _mm(jac.T, r0)).reshape(n, 6)
        p = jax.vmap(lambda x, m: _mm(_exp_se3_mat(x), m))(dx, p)
        return p, jnp.sum(r0 * r0)

    poses, costs = jax.lax.scan(gn_step, poses, None, length=iters)
    return poses, costs


def _pad_pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


# ----------------------------------------------------------------------
# Keyframe database + loop-closure manager
# ----------------------------------------------------------------------
class LoopClosureManager:
    """Keyframe store, loop detection/verification, pose-graph state.

    Owned by DenseSLAM (loop_closure=True) but usable standalone; all
    heavy math (descriptor, matching, ICP verify, pose graph) is jitted
    with static shapes.  Keyframe depths are kept on HOST at half
    resolution (f16) so the database scales to hundreds of keyframes
    without touching HBM; they move to the device only for the rare
    verification ICP.
    """

    def __init__(
        self,
        intrinsics: Tuple[float, float, float, float],
        img_h: int,
        img_w: int,
        kf_every: int = 10,
        min_gap_frames: int = 60,
        sim_thresh: float = 0.975,
        verify_max_rmse: float = 0.04,
        verify_min_inliers: int = 3000,
        max_keyframes: int = 256,
    ):
        self.kf_every = int(kf_every)
        self.min_gap_frames = int(min_gap_frames)
        self.sim_thresh = float(sim_thresh)
        self.verify_max_rmse = float(verify_max_rmse)
        self.verify_min_inliers = int(verify_min_inliers)
        self.cap = int(max_keyframes)
        self.img_h, self.img_w = img_h, img_w

        # verification tracker at HALF resolution (stored kf depths are
        # decimated 2x: quarter the ICP work, same convergence basin)
        fx, fy, cx, cy = intrinsics
        self._vh, self._vw = img_h // 2, img_w // 2
        self._verify_icp = ICPOdometry(
            (fx / 2, fy / 2, cx / 2, cy / 2), self._vh, self._vw,
            max_rmse=verify_max_rmse,
        )

        # device-side database (descriptors + ids: tiny)
        self.db_desc = jnp.zeros((self.cap, DESC_DIM), jnp.float32)
        self.db_ids = jnp.full((self.cap,), -(10**9), jnp.int32)
        self.count = 0
        # host-side per-keyframe state
        self.kf_frame_ids: List[int] = []
        self.kf_depth_half: List[np.ndarray] = []  # [H/2, W/2] f16
        self.kf_pose_est: List[np.ndarray] = []  # world_T_cam at creation
        self.kf_pose_opt: List[np.ndarray] = []  # current optimized pose
        # pose-graph edges: (i, j, Z 4x4, weight)
        self.edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.closures = 0  # accepted loop constraints so far
        # frame-id offset applied to incoming ids: load() sets it past
        # the loaded timeline so a NEW session's frame 0 counts as
        # "long after" every loaded keyframe — loaded keyframes are
        # immediately eligible loop candidates while the recency guard
        # still applies within the new session
        self.id_offset = 0
        # kf_every gate state (enforced HERE, not by the caller): the
        # effective frame id of the last stored keyframe
        self._last_kf_id: Optional[int] = None
        self.evictions = 0  # keyframes merged away at the cap
        self._cap_warned = False

    # ------------------------------------------------------------------
    def _verify(
        self, depth_half_cur: jnp.ndarray, kf_idx: int,
        seed_world_T_cam: np.ndarray,
    ) -> Optional[np.ndarray]:
        """Geometric check of a candidate: multi-level ICP of the current
        half-res depth against the keyframe's.  Returns the converged
        world_T_cam of the CURRENT frame in the keyframe's frame, or
        None when the rmse/inlier gate rejects."""
        icp = self._verify_icp
        kf_depth = jnp.asarray(
            self.kf_depth_half[kf_idx].astype(np.float32)
        )
        pyr_ref = icp._prep(kf_depth)
        pyr_cur = icp._prep(depth_half_cur)
        kf_pose = self.kf_pose_opt[kf_idx]
        ref_pose = jnp.asarray(np.linalg.inv(kf_pose).astype(np.float32))
        t, rmse, inl = icp._track(
            jnp.asarray(seed_world_T_cam, jnp.float32), pyr_cur, pyr_ref,
            ref_pose,
        )
        rmse_f, inl_f = float(rmse), float(inl)
        if not np.isfinite(rmse_f) or rmse_f >= self.verify_max_rmse:
            return None
        if inl_f <= self.verify_min_inliers:
            return None
        return np.asarray(t, np.float32)

    # ------------------------------------------------------------------
    def add_keyframe(
        self,
        depth: np.ndarray,
        world_T_cam_est: np.ndarray,
        frame_id: int,
        intensity: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Store a keyframe; detect + close loops.

        Returns a 4x4 world-frame CORRECTION (apply as
        world_T_cam <- C @ world_T_cam to the live tracker) when a loop
        closed, else None.  depth: full-res [H, W] float metres;
        intensity: optional full-res [H, W] grayscale (any scale) — the
        appearance channel of the place-recognition descriptor.

        The kf_every cadence is enforced HERE: frames closer than
        kf_every to the last stored keyframe are skipped (callers may
        submit every tracked frame).  At the max_keyframes cap the most
        redundant keyframe is merged away (see _evict_one) so a
        long-running robot keeps closing loops instead of silently
        losing drift correction."""
        frame_id = int(frame_id) + self.id_offset
        if (
            self._last_kf_id is not None
            and frame_id - self._last_kf_id < self.kf_every
        ):
            return None  # cadence gate (kf_every)
        if self.count >= self.cap:
            if not self._cap_warned:
                import logging

                logging.getLogger(__name__).warning(
                    "loop-closure keyframe database hit its cap (%d); "
                    "merging the most redundant keyframes from here on "
                    "(raise max_keyframes to keep full history)",
                    self.cap,
                )
                self._cap_warned = True
            self._evict_one()
        depth = np.asarray(depth, np.float32)
        d_half = depth[::2, ::2]
        d_half_dev = jnp.asarray(d_half)
        inten_half = (
            jnp.asarray(np.asarray(intensity, np.float32)[::2, ::2])
            if intensity is not None
            else None
        )
        desc = depth_descriptor(d_half_dev, inten_half)

        # --- detection BEFORE insertion (never match self) ---
        correction = None
        best, score = _match_scores(
            desc, self.db_desc, self.db_ids,
            jnp.int32(self.count), jnp.int32(frame_id),
            jnp.int32(self.min_gap_frames),
        )
        score_f = float(score)
        pose_est = np.asarray(world_T_cam_est, np.float32)

        j = self.count  # index of the node we are about to insert
        self.kf_frame_ids.append(int(frame_id))
        self.kf_depth_half.append(d_half.astype(np.float16))
        self.kf_pose_est.append(pose_est.copy())
        self.kf_pose_opt.append(pose_est.copy())
        self.db_desc = self.db_desc.at[j].set(desc)
        self.db_ids = self.db_ids.at[j].set(frame_id)
        self.count += 1
        self._last_kf_id = frame_id
        # odometry edge from the previous keyframe (in the pose_opt
        # frame: both estimates live in the same tracker frame between
        # corrections, and corrections re-base est too — see _rebase)
        if j > 0:
            z = np.linalg.inv(self.kf_pose_opt[j - 1]) @ pose_est
            self.edges.append((j - 1, j, z.astype(np.float32), 1.0))

        if score_f >= self.sim_thresh and j > 0:
            i = int(best)
            t_loop = self._verify(
                d_half_dev, i, self.kf_pose_opt[i]
            )
            if t_loop is not None:
                z = np.linalg.inv(self.kf_pose_opt[i]) @ t_loop
                # loop edges weigh more than odometry: the ICP verify
                # measured them directly against old geometry
                self.edges.append((i, j, z.astype(np.float32), 4.0))
                self.closures += 1
                correction = self._optimize_and_correct(j)
        return correction

    # ------------------------------------------------------------------
    def _evict_one(self) -> None:
        """Merge away the most redundant keyframe to make room at the cap.

        Redundancy = smallest motion to the PREVIOUS keyframe (a node
        whose neighbor sees nearly the same view adds no loop-closing
        power).  Node 0 (gauge anchor) and the newest node are never
        evicted; nodes holding loop edges are preferred KEPT (their
        constraints are what bounds drift) — only if every interior node
        carries a loop edge does the evictee drop its loop edges.  The
        evictee's two odometry edges compose into one (z = z1 @ z2), so
        the chain stays connected and the graph solution is unchanged up
        to the removed node's own residual."""
        n = self.count
        if n < 3:
            return
        has_loop = np.zeros(n, bool)
        for i, j, _z, _w in self.edges:
            if abs(i - j) != 1:
                has_loop[i] = has_loop[j] = True
        best_k, best_d = -1, np.inf
        for k in range(1, n - 1):
            if has_loop[k]:
                continue
            a, b = self.kf_pose_opt[k - 1], self.kf_pose_opt[k]
            dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            cos_t = np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)
            d = dt + 2.0 * float(np.arccos(cos_t))
            if d < best_d:
                best_k, best_d = k, d
        dropped_loops = 0
        if best_k < 0:
            # every interior node anchors a loop: evict the one whose
            # loop edges we can best afford to lose (fewest of them)
            counts = np.zeros(n, np.int32)
            for i, j, _z, _w in self.edges:
                if abs(i - j) != 1:
                    counts[i] += 1
                    counts[j] += 1
            best_k = 1 + int(np.argmin(counts[1 : n - 1]))
        k = best_k
        # stitch odometry chain through k, remap indices, drop k's loops
        z1 = z2 = None
        w1 = w2 = 1.0
        new_edges = []
        for i, j, z, w in self.edges:
            if abs(i - j) == 1 and j == k:
                z1, w1 = z, w
                continue
            if abs(i - j) == 1 and i == k:
                z2, w2 = z, w
                continue
            if i == k or j == k:
                dropped_loops += 1
                continue
            new_edges.append(
                (i - (i > k), j - (j > k), z, w)
            )
        if z1 is not None and z2 is not None:
            new_edges.append(
                (k - 1, k, (z1 @ z2).astype(np.float32), min(w1, w2))
            )
        self.edges = new_edges
        if dropped_loops:
            import logging

            logging.getLogger(__name__).warning(
                "keyframe eviction dropped %d loop edge(s) of node %d "
                "(every interior node anchored a loop)", dropped_loops, k,
            )
        for lst in (
            self.kf_frame_ids, self.kf_depth_half,
            self.kf_pose_est, self.kf_pose_opt,
        ):
            lst.pop(k)
        desc = np.array(self.db_desc, np.float32, copy=True)
        ids = np.array(self.db_ids, np.int32, copy=True)
        desc[k : n - 1] = desc[k + 1 : n]
        ids[k : n - 1] = ids[k + 1 : n]
        desc[n - 1] = 0.0
        ids[n - 1] = -(10**9)
        self.db_desc = jnp.asarray(desc)
        self.db_ids = jnp.asarray(ids)
        self.count -= 1
        self.evictions += 1

    # ------------------------------------------------------------------
    def _optimize_and_correct(self, newest: int) -> np.ndarray:
        """Relax the graph; return the world correction for the newest
        node (optimized @ inv(estimated))."""
        n = self.count
        n_pad = _pad_pow2(n)
        e = len(self.edges)
        e_pad = _pad_pow2(max(e, 1))
        poses = np.stack(
            self.kf_pose_opt + [np.eye(4, dtype=np.float32)] * (n_pad - n)
        )
        ei = np.zeros(e_pad, np.int32)
        ej = np.zeros(e_pad, np.int32)
        z = np.tile(np.eye(4, dtype=np.float32), (e_pad, 1, 1))
        w = np.zeros(e_pad, np.float32)
        for k, (i, j, zz, ww) in enumerate(self.edges):
            ei[k], ej[k], z[k], w[k] = i, j, zz, ww
        opt, _costs = optimize_pose_graph(
            jnp.asarray(poses), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(z), jnp.asarray(w),
        )
        opt = np.asarray(opt, np.float32)
        before = self.kf_pose_opt[newest].copy()
        for k in range(n):
            self.kf_pose_opt[k] = opt[k]
        return (opt[newest] @ np.linalg.inv(before)).astype(np.float32)

    # ------------------------------------------------------------------
    def relocalize(
        self, depth: np.ndarray, intensity: Optional[np.ndarray] = None
    ) -> Optional[np.ndarray]:
        """Recover a pose from the keyframe database after tracking
        loss: best descriptor match (no recency gap) + ICP verify,
        seeded at the matched keyframe's pose.  Returns world_T_cam or
        None.  Pass the same intensity channel used for add_keyframe —
        mixed geometry-only/appearance descriptors never clear the
        similarity threshold (by construction, see depth_descriptor)."""
        if self.count == 0:
            return None
        d_half_dev = jnp.asarray(np.asarray(depth, np.float32)[::2, ::2])
        inten_half = (
            jnp.asarray(np.asarray(intensity, np.float32)[::2, ::2])
            if intensity is not None
            else None
        )
        desc = depth_descriptor(d_half_dev, inten_half)
        best, score = _match_scores(
            desc, self.db_desc, self.db_ids,
            jnp.int32(self.count), jnp.int32(0), jnp.int32(-(10**9)),
        )
        if float(score) < self.sim_thresh:
            return None
        i = int(best)
        return self._verify(d_half_dev, i, self.kf_pose_opt[i])

    # ------------------------------------------------------------------
    def correct_trajectory(
        self, frame_ids: np.ndarray, poses_cam_T_world: np.ndarray
    ) -> np.ndarray:
        """Retro-correct a per-frame trajectory: each frame gets the
        optimized-vs-estimated delta of its most recent keyframe (frames
        between keyframes tracked in that keyframe's frame)."""
        if self.count == 0:
            return poses_cam_T_world
        kf_ids = np.asarray(self.kf_frame_ids)
        out = np.array(poses_cam_T_world, np.float32, copy=True)
        for n, fid in enumerate(np.asarray(frame_ids) + self.id_offset):
            k = int(np.searchsorted(kf_ids, fid, side="right")) - 1
            if k < 0:
                continue
            c = self.kf_pose_opt[k] @ np.linalg.inv(self.kf_pose_est[k])
            world_T_cam = np.linalg.inv(out[n])
            out[n] = np.linalg.inv(c @ world_T_cam)
        return out

    # ------------------------------------------------------------------
    # Map database persistence (run_zed_native.cc:88 save_map_database)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            desc=np.asarray(self.db_desc)[: self.count],
            frame_ids=np.asarray(self.kf_frame_ids, np.int64),
            depth_half=np.stack(self.kf_depth_half)
            if self.kf_depth_half else np.zeros((0, 1, 1), np.float16),
            pose_est=np.stack(self.kf_pose_est)
            if self.kf_pose_est else np.zeros((0, 4, 4), np.float32),
            pose_opt=np.stack(self.kf_pose_opt)
            if self.kf_pose_opt else np.zeros((0, 4, 4), np.float32),
            edges_ij=np.asarray(
                [(i, j) for i, j, _, _ in self.edges], np.int64
            ).reshape(-1, 2),
            edges_z=np.stack([z for _, _, z, _ in self.edges])
            if self.edges else np.zeros((0, 4, 4), np.float32),
            edges_w=np.asarray([w for _, _, _, w in self.edges], np.float32),
            meta=np.asarray(
                [self.img_h, self.img_w, self.kf_every], np.int64
            ),
        )

    def load(self, path: str) -> None:
        d = np.load(path)
        n = int(d["frame_ids"].shape[0])
        assert n <= self.cap, (n, self.cap)
        self.count = n
        self.kf_frame_ids = [int(x) for x in d["frame_ids"]]
        self.kf_depth_half = [x for x in d["depth_half"]]
        self.kf_pose_est = [x.astype(np.float32) for x in d["pose_est"]]
        self.kf_pose_opt = [x.astype(np.float32) for x in d["pose_opt"]]
        desc = np.zeros((self.cap, DESC_DIM), np.float32)
        loaded = np.asarray(d["desc"], np.float32)
        if loaded.shape[1] == _DESC_DIM_V1:
            # geometry-only database from before the appearance channel:
            # zero appearance cells match depth_descriptor(intensity=None)
            desc[:n, :_DESC_DIM_V1] = loaded
        else:
            desc[:n] = loaded
        ids = np.full((self.cap,), -(10**9), np.int64)
        ids[:n] = d["frame_ids"]
        self.db_desc = jnp.asarray(desc)
        self.db_ids = jnp.asarray(ids.astype(np.int32))
        self.edges = [
            (int(ij[0]), int(ij[1]), z.astype(np.float32), float(w))
            for ij, z, w in zip(d["edges_ij"], d["edges_z"], d["edges_w"])
        ]
        # place the NEW session's frame ids after the loaded timeline
        # (see id_offset comment in __init__)
        self.id_offset = (
            max(self.kf_frame_ids) + self.min_gap_frames + 1 if n else 0
        )
        # the id_offset already spaces new ids past the loaded timeline
        # by more than kf_every, so the cadence gate restarts cleanly
        self._last_kf_id = max(self.kf_frame_ids) if n else None
