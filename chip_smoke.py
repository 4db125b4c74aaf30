#!/usr/bin/env python
"""Smoke test of the semantic fusion path on one GPU (or four).

Drives the main path through its normal entry points at the reference
deployment's size (640x480 orbit_vga frames, 4 mm voxels, 24 mm
truncation, 4 m max depth, dense grid 2^8 blocks per axis, 2^18-block
pool = 1.61 GB of payload, 32768 candidates/visible, 8192 new blocks per
round, lossless allocation) and checks each result by the repo's own
means:

  online       FusedOnlineStep (H2D of u8/u16 frames + shipped U-Net at
               640x352 + integrate, one jitted program) over 60 frames;
               bbox query + mesh export of the final volume; the
               apps/online.py entry point in-process
  render       parity raycaster vs XLA splat on the final volume
  determinism  the online path twice over 10 frames: bit-identical
  parity       integrate (dense and hash backends) vs the numpy oracle
               (tests/oracle.py); index_hints off: bit-identical
  seg          U-Net forward on the GPU vs the in-process CPU backend;
               held-out IoU on the GPU
  dense_slam   DenseSLAM over 20 frames at 1 cm voxels: no lost frame,
               ATE below one voxel

Usage:
  python chip_smoke.py                 # one GPU, every phase above
  python chip_smoke.py --four-gpus     # DistributedTSDF over 4 GPUs vs
                                       # one GPU, and nothing else
  python chip_smoke.py --profile DIR   # online and render only, tracing
                                       # a short online window and one
                                       # render of each kind into DIR
                                       # (summary: scripts/trace_summary.py)

Refuses to run (exit 2, no result line) unless JAX's first device is a
GPU.  Every phase asserts its tolerance; the first failure ends the run
with a traceback.  The last stdout line is the result:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ORBIT = os.path.join(REPO, "datasets", "orbit_vga")
K_ORBIT = (525.1, 525.3, 319.6, 239.7)
DEPTH_FACTOR = 5000.0
MAX_DEPTH = 4.0
# hash-backend claim rounds in the parity phase (see phase_parity)
PARITY_INSERT_ROUNDS = 8


@dataclasses.dataclass(frozen=True)
class Workload:
    """Sizes of one smoke run.  FULL is the reference deployment; TINY
    is the same path cut down for the CPU tests."""

    stride: int  # decimation of the 640x480 orbit_vga frames
    voxel: float
    trunc: float
    num_blocks_log2: int
    num_buckets_log2: int  # hash backend only
    max_candidates: int
    max_visible: int
    max_new_per_round: int
    grid_log2: int
    # parity only: allocation caps that hold a whole first frame (the
    # oracle allocates every candidate block at once)
    parity_candidates: int
    parity_new_per_round: int
    parity_frames: int
    online_frames: int
    warmup_frames: int
    det_frames: int
    app_frames: int
    slam_frames: int
    slam_voxel: float
    iou_batch: int
    four_gpu_frames: int


FULL = Workload(
    stride=1, voxel=0.004, trunc=0.024, num_blocks_log2=18,
    num_buckets_log2=19, max_candidates=32768, max_visible=32768,
    max_new_per_round=8192, grid_log2=8, parity_candidates=1 << 18,
    parity_new_per_round=1 << 15, parity_frames=3,
    online_frames=60, warmup_frames=5, det_frames=10, app_frames=10,
    slam_frames=20, slam_voxel=0.01, iou_batch=8, four_gpu_frames=20,
)
TINY = Workload(
    stride=4, voxel=0.02, trunc=0.06, num_blocks_log2=12,
    num_buckets_log2=13, max_candidates=4096, max_visible=2048,
    max_new_per_round=1024, grid_log2=6, parity_candidates=1 << 14,
    parity_new_per_round=2048, parity_frames=2,
    online_frames=4, warmup_frames=1, det_frames=3, app_frames=2,
    slam_frames=4, slam_voxel=0.04, iou_batch=2, four_gpu_frames=3,
)


@dataclasses.dataclass
class Frame:
    pose: np.ndarray  # cam_T_world f32 [4, 4]
    rgb: np.ndarray  # f32 [H, W, 3] in [0, 255]
    depth: np.ndarray  # f32 [H, W] metres
    ht: np.ndarray  # f32 [H, W]
    lt: np.ndarray  # f32 [H, W]

    @property
    def sensor(self):
        """(rgb u8, depth u16 counts, pose): what an RGB-D sensor sends."""
        depth = np.round(self.depth * DEPTH_FACTOR).astype(np.uint16)
        return self.rgb.astype(np.uint8), depth, self.pose


def intrinsics(wl: Workload):
    s = wl.stride
    fx, fy, cx, cy = K_ORBIT
    return (fx / s, fy / s, (cx + 0.5) / s - 0.5, (cy + 0.5) / s - 0.5)


def load_frames(wl: Workload, n: int):
    """The first n orbit_vga frames, decimated by wl.stride."""
    from disinfect_slam.io.dataset import LoggedReplay

    replay = LoggedReplay(ORBIT, DEPTH_FACTOR)
    s = wl.stride
    out = []
    for fid, pose in replay.entries[:n]:
        fr = replay.load_frame(fid, pose)
        out.append(Frame(
            pose=np.asarray(fr.cam_T_world, np.float32),
            rgb=np.ascontiguousarray(fr.rgb[::s, ::s]),
            depth=np.ascontiguousarray(fr.depth[::s, ::s]),
            ht=np.ascontiguousarray(fr.ht[::s, ::s]),
            lt=np.ascontiguousarray(fr.lt[::s, ::s]),
        ))
    return out


def tsdf_config(wl: Workload, backend: str = "dense", **kw):
    from disinfect_slam.config import TSDFConfig

    base = dict(
        voxel_size=wl.voxel, truncation=wl.trunc,
        num_blocks_log2=wl.num_blocks_log2,
        num_buckets_log2=wl.num_buckets_log2,
        max_candidates=wl.max_candidates, max_visible=wl.max_visible,
        max_new_per_round=wl.max_new_per_round, grid_log2=wl.grid_log2,
        backend=backend,
    )
    return TSDFConfig(**{**base, **kw})


def camera(wl: Workload, frames):
    from disinfect_slam.core.geometry import CameraIntrinsics, CameraParams

    h, w = frames[0].depth.shape
    return CameraParams.create(CameraIntrinsics.create(*intrinsics(wl)), h, w)


def frame_input(f: Frame):
    import jax.numpy as jnp

    from disinfect_slam.ops.integrate import FrameInput

    return FrameInput(
        rgb=jnp.asarray(f.rgb), depth=jnp.asarray(f.depth),
        ht=jnp.asarray(f.ht), lt=jnp.asarray(f.lt),
    )


def volume_arrays(vol) -> dict:
    """Every array of a TSDFVolume on the host."""
    return {
        f.name: np.asarray(getattr(vol, f.name))
        for f in dataclasses.fields(vol) if f.name != "cfg"
    }


def assert_identical(a: dict, b: dict, what: str) -> None:
    for k in a:
        if not np.array_equal(a[k], b[k]):
            diff = int(np.sum(a[k] != b[k]))
            raise AssertionError(f"{what}: {k} differs in {diff} elements")


def report(phase: str, wall_s: float, **numbers) -> None:
    parts = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] wall_s={wall_s:.2f} {parts}", flush=True)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_online(wl: Workload, frames, model, params, profile_dir=None):
    """FusedOnlineStep over wl.online_frames frames; returns the step."""
    import jax

    from disinfect_slam.ops.gather import (
        BoundingCube,
        gather_voxels,
        to_numpy_records,
    )
    from disinfect_slam.ops.mesh import extract_mesh_chunked, merge_vertices
    from disinfect_slam.systems.online_step import FusedOnlineStep

    t_phase = time.perf_counter()
    h, w = frames[0].depth.shape
    step = FusedOnlineStep(
        tsdf_config(wl), intrinsics(wl), h, w, MAX_DEPTH,
        seg_model=model, seg_params=params, depth_factor=DEPTH_FACTOR,
    )
    sensor = [f.sensor for f in frames]
    t0 = time.perf_counter()
    step.step(*sensor[0])
    step.block_until_ready()
    compile_s = time.perf_counter() - t0
    for s in sensor[1:wl.warmup_frames]:
        step.step(*s)
    step.block_until_ready()
    t0 = time.perf_counter()
    for s in sensor[wl.warmup_frames:]:
        step.step(*s)
    step.block_until_ready()
    fps = (len(sensor) - wl.warmup_frames) / (time.perf_counter() - t0)
    active = step.num_active_blocks()

    rgb, depth, pose = (jax.device_put(a) for a in sensor[-1])
    compiled = step._step.lower(
        step.volume, params, rgb, depth, pose, allocate=True
    ).compile()
    mem = compiled.memory_analysis()
    mem_txt = (
        "n/a" if mem is None else
        f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes} "
        f"alias={mem.alias_size_in_bytes} temp={mem.temp_size_in_bytes}"
    )
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

    if profile_dir:
        # a short traced window, after the timed one; the optimized HLO
        # maps trace ops to name scopes (scripts/trace_summary.py)
        out = os.path.join(profile_dir, "online")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "online_step.hlo.txt"), "w") as f:
            f.write(compiled.as_text())
        with jax.profiler.trace(out):
            for s in sensor[:5]:
                step.step(*s)
            step.block_until_ready()

    # bbox query + mesh export of the final volume
    t0 = time.perf_counter()
    rec = to_numpy_records(gather_voxels(step.volume, BoundingCube(-1.5, 1.5, -1.5, 1.5, -0.5, 3.5)))
    query_s = time.perf_counter() - t0
    assert len(rec) > 0 and np.isfinite(rec).all(), "bbox query empty or non-finite"
    t0 = time.perf_counter()
    tris = extract_mesh_chunked(step.volume)
    mesh_s = time.perf_counter() - t0
    verts, faces = merge_vertices(tris)  # host-side vertex welding
    merge_s = time.perf_counter() - t0 - mesh_s
    assert len(faces) > 0 and np.isfinite(verts).all(), "mesh empty or non-finite"

    report(
        "online", time.perf_counter() - t_phase,
        frames=len(sensor), fps=f"{fps:.2f}", compile_s=f"{compile_s:.1f}",
        active_blocks=active, peak_bytes_in_use=peak,
        memory_analysis=f"[{mem_txt}]", bbox_voxels=len(rec),
        query_s=f"{query_s:.2f}", mesh_faces=len(faces),
        mesh_s=f"{mesh_s:.2f}", merge_s=f"{merge_s:.2f}",
    )
    assert active > 0
    return step


def phase_online_app(wl: Workload) -> None:
    """apps/online.py's main(argv) in-process: --segment --fused."""
    import importlib.util

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "online_app", os.path.join(REPO, "apps", "online.py")
    )
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    argv = [
        "--logdir", ORBIT, "--config", os.path.join(ORBIT, "cam.yaml"),
        "--segment", "--fused", "--max-frames", str(wl.app_frames),
    ]
    if wl is not FULL:
        argv += ["--preset", "small"]
    app.main(argv)
    report("online_app", time.perf_counter() - t0, frames=wl.app_frames)


def phase_render(wl: Workload, vol, frames, profile_dir=None) -> None:
    """Parity raycaster vs splat on the final volume, from three poses;
    the bounds of tests/test_render_divergence.py."""
    import jax

    from disinfect_slam.core.geometry import SE3
    from disinfect_slam.ops.raycast import raycast
    from disinfect_slam.ops.render_fast import splat_render

    t_phase = time.perf_counter()
    cam = camera(wl, frames)
    h, w = cam.img_h, cam.img_w
    # named functions: distinct program names in the trace
    def raycast_view(v, m):
        return raycast(v, cam, SE3.from_matrix(m), MAX_DEPTH)

    def splat_view(v, m):
        return splat_render(v, cam, SE3.from_matrix(m), MAX_DEPTH)

    rc, sp = jax.jit(raycast_view), jax.jit(splat_view)
    fx, fy, cx, cy = intrinsics(wl)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    nrm = np.linalg.norm(
        np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1), axis=-1
    )
    vox = wl.voxel
    worst_holes = worst_p95 = worst_bad = 0.0
    ms = {}
    for pose in (frames[0].pose, frames[len(frames) // 2].pose, frames[-1].pose):
        res = {}
        for name, fn in (("raycast", rc), ("splat", sp)):
            r = fn(vol, pose)
            jax.block_until_ready(r.depth)
            t0 = time.perf_counter()
            r = fn(vol, pose)
            jax.block_until_ready(r.depth)
            ms[name] = (time.perf_counter() - t0) * 1e3
            res[name] = r
        hit_r = np.asarray(res["raycast"].hit)
        hit_s = np.asarray(res["splat"].hit)
        both = hit_r & hit_s
        z_ray = np.asarray(res["raycast"].depth) / nrm  # range -> camera z
        derr = np.abs(z_ray - np.asarray(res["splat"].depth))
        worst_holes = max(worst_holes, (hit_r & ~hit_s).sum() / max(hit_r.sum(), 1))
        if both.any():
            worst_p95 = max(worst_p95, float(np.percentile(derr[both], 95)))
        worst_bad = max(worst_bad, float((both & (derr > 2 * vox)).mean()))
        assert hit_r.mean() > 0.1, "raycast sees almost nothing"
    if profile_dir:
        out = os.path.join(profile_dir, "render")
        os.makedirs(out, exist_ok=True)
        for name, fn in (("raycast", rc), ("splat", sp)):
            with open(os.path.join(out, f"{name}.hlo.txt"), "w") as f:
                f.write(fn.lower(vol, frames[-1].pose).compile().as_text())
        with jax.profiler.trace(out):
            for fn in (rc, sp):
                jax.block_until_ready(fn(vol, frames[-1].pose).depth)
    report(
        "render", time.perf_counter() - t_phase,
        raycast_ms=f"{ms['raycast']:.2f}", splat_ms=f"{ms['splat']:.2f}",
        holes=f"{worst_holes:.5f}", p95_depth_err_vox=f"{worst_p95 / vox:.3f}",
        disagree_gt2vox=f"{worst_bad:.5f}",
    )
    assert worst_holes < 0.005, f"splat holes {worst_holes}"
    assert worst_p95 < 1.0 * vox, f"p95 depth error {worst_p95 / vox} voxels"
    assert worst_bad < 0.03, f"disagreement {worst_bad}"


def phase_determinism(wl: Workload, step, frames) -> None:
    """The online path twice over wl.det_frames frames, from an empty
    volume each time: every array must come out bit-identical."""
    from disinfect_slam.core.state import TSDFVolume

    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        step.volume = TSDFVolume.create(step.cfg)
        for f in frames[: wl.det_frames]:
            step.step(*f.sensor)
        step.block_until_ready()
        runs.append(volume_arrays(step.volume))
    assert_identical(runs[0], runs[1], "online path run 1 vs run 2")
    report("determinism", time.perf_counter() - t0, frames=wl.det_frames,
           arrays=len(runs[0]), identical=True)


def phase_parity(wl: Workload, frames) -> None:
    """integrate on the device vs the numpy oracle, both backends, with
    the bounds of tests/test_integrate.py; dense with index_hints off
    must be bit-identical to hints on.

    The oracle allocates every block a frame touches at once (about 20k
    on the first full-size orbit_vga frame), so the allocation caps are
    raised to hold a whole frame (wl.parity_candidates,
    wl.parity_new_per_round, and PARITY_INSERT_ROUNDS: with the
    default 3 claim rounds, 84 of the first frame's 20.6k candidate
    blocks lose three hash-slot claims in a row and wait for a later
    frame); everything else is the main path's configuration.  With the main path's caps the first frames defer
    part of their allocation to later frames (fail-open), which the
    oracle does not model."""
    import jax

    from disinfect_slam.core.geometry import SE3
    from disinfect_slam.core.state import TSDFVolume
    from disinfect_slam.ops.integrate import integrate

    sys.path.insert(0, REPO)
    from tests.oracle import OracleVolume, volume_metrics

    t_phase = time.perf_counter()
    frames = frames[: wl.parity_frames]
    cam = camera(wl, frames)
    k = intrinsics(wl)
    t0 = time.perf_counter()
    ovol = OracleVolume(wl.voxel, wl.trunc)
    for f in frames:
        ovol.integrate(f.rgb, f.depth, f.ht, f.lt, MAX_DEPTH, k, f.pose)
    oracle_s = time.perf_counter() - t0

    def run(cfg):
        step = jax.jit(
            lambda v, fr, m: integrate(v, fr, cam, SE3.from_matrix(m), MAX_DEPTH),
            donate_argnums=0,
        )
        vol = TSDFVolume.create(cfg)
        for f in frames:
            vol = step(vol, frame_input(f), f.pose)
        jax.block_until_ready(vol.tsdf)
        return vol

    caps = dict(max_candidates=wl.parity_candidates,
                max_new_per_round=wl.parity_new_per_round,
                insert_rounds=PARITY_INSERT_ROUNDS)
    out = {}
    for backend in ("dense", "hash"):
        vol = run(tsdf_config(wl, backend, **caps))
        m = volume_metrics(vol, ovol)
        out[backend] = m
        if backend == "dense":
            hinted = volume_arrays(vol)
            del vol
            plain = volume_arrays(
                run(tsdf_config(wl, backend, index_hints=False, **caps))
            )
            assert_identical(hinted, plain, "index_hints on vs off")
            del hinted, plain
        else:
            del vol
    report(
        "parity", time.perf_counter() - t_phase, frames=len(frames),
        oracle_s=f"{oracle_s:.1f}", index_hints_identical=True,
        **{f"{b}_{k2}": (f"{v:.3g}" if isinstance(v, float) else v)
           for b, m in out.items() for k2, v in m.items()},
    )
    for b, m in out.items():
        assert m["missing"] == 0, (b, m)
        assert m["w_mismatch"] < 0.005, (b, m)
        assert m["tsdf_l1"] < 2e-3, (b, m)
        assert m["rgb_flip"] < 0.005, (b, m)
        assert m["prob_l1"] < 1e-3, (b, m)
        assert m["blocks"] == m["oracle_blocks"], (b, m)


def phase_seg(wl: Workload, frames, model, params) -> None:
    """U-Net on the accelerator vs the same params on the CPU backend
    (both bf16 convolutions with f32 accumulation), and held-out IoU."""
    import jax
    import jax.numpy as jnp

    from disinfect_slam.models.segmentation import INFER_H, INFER_W, resize_linear
    from disinfect_slam.models.synth_data import make_batch
    from disinfect_slam.models.train import iou_metric

    t0 = time.perf_counter()
    ih, iw = INFER_H // wl.stride, INFER_W // wl.stride
    acc, cpu = jax.devices()[0], jax.devices("cpu")[0]

    def fwd(p, img):
        x = resize_linear(img, ih, iw) / 255.0
        return jax.nn.sigmoid(model.apply(p, x[None])[0])

    f = jax.jit(fwd)
    probs = {}
    for name, dev in (("acc", acc), ("cpu", cpu)):
        probs[name] = np.asarray(f(jax.device_put(params, dev),
                                   jax.device_put(frames[0].rgb, dev)))
    d = np.abs(probs["acc"] - probs["cpu"])
    agree = [
        float(((probs["acc"][..., c] > 0.5) == (probs["cpu"][..., c] > 0.5)).mean())
        for c in range(2)
    ]
    imgs, labels = make_batch(np.random.default_rng(987654), wl.iou_batch, ih, iw)
    logits = jax.jit(model.apply)(jax.device_put(params, acc), jnp.asarray(imgs))
    iou = np.asarray(iou_metric(jnp.asarray(logits, jnp.float32), labels))
    report(
        "seg", time.perf_counter() - t0, input=f"{iw}x{ih}",
        mean_abs_dp=f"{d.mean():.2e}", max_abs_dp=f"{d.max():.2e}",
        mask_agree_ht=f"{agree[0]:.5f}", mask_agree_lt=f"{agree[1]:.5f}",
        iou_ht=f"{iou[0]:.4f}", iou_lt=f"{iou[1]:.4f}",
    )
    assert d.mean() <= 2e-3 and d.max() <= 3e-2, (d.mean(), d.max())
    assert min(agree) >= 0.995, agree
    assert iou[0] > 0.7 and iou[1] > 0.7, iou


def phase_dense_slam(wl: Workload, frames, ate_bound: float | None = None) -> dict:
    """DenseSLAM (the class behind apps/dense_slam.py) over
    wl.slam_frames frames: no lost frame, ATE rmse below one voxel
    (rigidly aligned, against the dataset's trajectory)."""
    from disinfect_slam.systems.dense_slam import DenseSLAM
    from disinfect_slam.utils.trajectory_eval import ate

    t_phase = time.perf_counter()
    frames = frames[: wl.slam_frames]
    h, w = frames[0].depth.shape
    vox = wl.slam_voxel
    slam = DenseSLAM(
        intrinsics(wl), h, w, voxel_size=vox, truncation=6 * vox,
        max_depth=MAX_DEPTH, cfg=tsdf_config(wl),
    )
    est = []
    t0 = None
    for i, f in enumerate(frames):
        if i == 1:
            t0 = time.perf_counter()
        e, _ok = slam.process_frame(f.rgb, f.depth, f.ht, f.lt)
        est.append(e)
    est = [np.asarray(e) for e in est]
    ms = (time.perf_counter() - t0) / max(len(frames) - 1, 1) * 1e3
    lost = slam.lost_count
    gt_wc = np.stack([np.linalg.inv(f.pose) for f in frames])
    est_wc = np.stack([np.linalg.inv(e) for e in est])
    rmse = ate(gt_wc, est_wc, align=True)["rmse"]
    bound = vox if ate_bound is None else ate_bound
    report(
        "dense_slam", time.perf_counter() - t_phase, frames=len(frames),
        voxel_m=vox, ms_per_frame=f"{ms:.1f}", lost=lost,
        ate_rmse_m=f"{rmse:.5f}", bound_m=f"{bound:.5f}",
    )
    assert lost == 0, f"{lost} lost frames"
    assert rmse < bound, f"ATE rmse {rmse} >= {bound}"
    return {"ate_rmse": rmse, "lost": lost}


def _block_rows(entry_key, entry_block, tsdf, rgbw, prob):
    """(keys, tsdf, rgbw, prob) of every live block, sorted by key."""
    live = entry_block >= 0
    keys = entry_key[live]
    rows = entry_block[live]
    order = np.argsort(keys, kind="stable")
    rows = rows[order]
    return keys[order], tsdf[rows], rgbw[rows], prob[rows]


def phase_four_gpus(wl: Workload, frames) -> None:
    """DistributedTSDF over 4 devices (2^(num_blocks_log2 - 2) blocks per
    shard) vs one device's volume of the same frames, with the
    comparisons of tests/test_parallel.py; plus the distributed bbox
    query (all_gather) and render (pmin/pmax).

    Both sides use the parity allocation caps: each shard applies the
    per-frame caps to its own candidates, so with binding caps the two
    sides would legitimately allocate at different rates."""
    import jax

    from disinfect_slam.core.geometry import SE3
    from disinfect_slam.core.state import TSDFVolume
    from disinfect_slam.ops.gather import BoundingCube, gather_voxels, to_numpy_records
    from disinfect_slam.ops.integrate import integrate
    from disinfect_slam.ops.render_fast import splat_render
    from disinfect_slam.parallel.sharding import DistributedTSDF, make_mesh

    t_phase = time.perf_counter()
    assert len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}"
    frames = frames[: wl.four_gpu_frames]
    cfg = tsdf_config(wl, max_candidates=wl.parity_candidates,
                      max_new_per_round=wl.parity_new_per_round)
    cam = camera(wl, frames)
    k = intrinsics(wl)
    dist = DistributedTSDF(cfg, make_mesh(4))
    inputs = [frame_input(f) for f in frames]
    dist.integrate(inputs[0], k, frames[0].pose, MAX_DEPTH)
    jax.block_until_ready(dist.volume.tsdf)
    t0 = time.perf_counter()
    for fr, f in zip(inputs[1:], frames[1:]):
        dist.integrate(fr, k, f.pose, MAX_DEPTH)
    jax.block_until_ready(dist.volume.tsdf)
    dist_ms = (time.perf_counter() - t0) / max(len(frames) - 1, 1) * 1e3

    step = jax.jit(
        lambda v, fr, m: integrate(v, fr, cam, SE3.from_matrix(m), MAX_DEPTH),
        donate_argnums=0,
    )
    vol = TSDFVolume.create(cfg)
    for fr, f in zip(inputs, frames):
        vol = step(vol, fr, f.pose)
    jax.block_until_ready(vol.tsdf)

    n_dist, n_single = dist.num_active_blocks(), int(vol.num_active_blocks)
    per_shard = np.asarray(dist.sub_cfg.num_blocks - dist.volume.num_free)
    single = _block_rows(*(np.asarray(getattr(vol, n)) for n in
                           ("entry_key", "entry_block", "tsdf", "rgbw", "prob")))
    dv = {n: np.asarray(getattr(dist.volume, n)) for n in
          ("entry_key", "entry_block", "tsdf", "rgbw", "prob")}
    parts = [_block_rows(*(dv[n][d] for n in dv)) for d in range(4)]
    merged = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    order = np.argsort(merged[0], kind="stable")
    merged = [m[order] for m in merged]
    assert n_dist == n_single, (n_dist, n_single)
    np.testing.assert_array_equal(merged[0], single[0])  # block coords
    np.testing.assert_allclose(merged[1], single[1], atol=1e-5)  # tsdf
    w_d = (merged[2] >> 24).astype(np.int32)
    w_s = (single[2] >> 24).astype(np.int32)
    w_mismatch = float((w_d != w_s).mean())
    p_err = float(np.abs(merged[3] - single[3]).max())

    bbox = BoundingCube(-0.5, 0.5, -0.5, 0.5, 0.5, 1.5)
    rec_d = dist.query_bbox(bbox)
    rec_s = to_numpy_records(gather_voxels(vol, bbox))

    def srt(r):
        return r[np.lexsort((r[:, 2], r[:, 1], r[:, 0]))]

    assert len(rec_d) > 0 and rec_d.shape == rec_s.shape, (rec_d.shape, rec_s.shape)
    np.testing.assert_allclose(srt(rec_d), srt(rec_s), atol=1e-5)

    pose = frames[-1].pose
    res_d = dist.render(cam, pose, MAX_DEPTH)
    res_s = splat_render(vol, cam, SE3.from_matrix(pose), MAX_DEPTH)
    hit_d, hit_s = np.asarray(res_d.hit), np.asarray(res_s.hit)
    hit_agree = float((hit_d == hit_s).mean())
    both = hit_d & hit_s
    depth_err = float(np.abs(np.asarray(res_d.depth)[both]
                             - np.asarray(res_s.depth)[both]).max())
    report(
        "four_gpus", time.perf_counter() - t_phase, frames=len(frames),
        blocks_per_shard_cap=dist.sub_cfg.num_blocks,
        active_blocks=n_dist, per_shard=per_shard.tolist(),
        dist_ms_per_frame=f"{dist_ms:.1f}", weight_mismatch=f"{w_mismatch:.2e}",
        prob_max_err=f"{p_err:.2e}", bbox_voxels=len(rec_d),
        render_hit_agree=f"{hit_agree:.5f}", render_depth_max_err=f"{depth_err:.2e}",
    )
    assert w_mismatch < 0.005 and p_err < 1e-3, (w_mismatch, p_err)
    assert hit_agree > 0.995 and hit_d.mean() > 0.1, hit_agree
    assert depth_err < 2e-3, depth_err


# ----------------------------------------------------------------------
def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", " | ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-device sharded volume vs one device")
    ap.add_argument("--profile", metavar="DIR",
                    help="run only the online and render phases, tracing "
                         "a short online window and one render of each "
                         "kind to DIR")
    args = ap.parse_args(argv)
    if args.profile:
        # one kernel per trace event: a CUDA graph (command buffer) shows
        # as a single event and hides the per-op split
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
        )

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, REPO)
    from disinfect_slam.utils import cache

    cache_dir = cache.enable()
    print(
        f"[chip] {card_line()} | jax {jax.__version__} | "
        f"{dev.device_kind} x{len(jax.devices())} | compile cache {cache_dir}",
        flush=True,
    )
    wl = FULL
    if args.four_gpus:
        phase_four_gpus(wl, load_frames(wl, wl.four_gpu_frames))
    else:
        from disinfect_slam.models.segmentation import (
            create_model,
            load_default_params,
        )

        model, params = create_model(), load_default_params()
        assert params is not None, "shipped U-Net weights missing"
        frames = load_frames(wl, wl.online_frames)
        step = phase_online(wl, frames, model, params, args.profile)
        phase_render(wl, step.volume, frames, args.profile)
        if args.profile:
            return 0
        phase_determinism(wl, step, frames)
        del step
        phase_online_app(wl)
        phase_parity(wl, frames)
        phase_seg(wl, frames, model, params)
        phase_dense_slam(wl, frames)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
