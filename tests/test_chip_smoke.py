"""chip_smoke.py: the platform gate, and every phase at a tiny size on
the CPU (the same code the GPU run executes at full size)."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses resolve it by name
    spec.loader.exec_module(mod)
    return mod


cs = _load()
WL = cs.TINY


@pytest.fixture(scope="module")
def frames():
    n = max(WL.online_frames, WL.slam_frames, WL.parity_frames,
            WL.four_gpu_frames)
    return cs.load_frames(WL, n)


@pytest.fixture(scope="module")
def small_seg():
    from disinfect_slam.models.segmentation import create_model

    model = create_model(widths=(8, 8, 16, 16))
    return model, model.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 32, 32, 3)))


def test_refuses_without_gpu():
    """On a CPU-only JAX the script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 2, out.stderr[-2000:]
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_frames_and_intrinsics_decimate_consistently(frames):
    f = frames[0]
    assert f.depth.shape == (480 // WL.stride, 640 // WL.stride)
    rgb, depth, pose = f.sensor
    assert rgb.dtype.name == "uint8" and depth.dtype.name == "uint16"
    # the u16 sensor counts reproduce the metric depth exactly
    assert (depth.astype("float32") / cs.DEPTH_FACTOR == f.depth).all()
    fx, fy, cx, cy = cs.intrinsics(WL)
    assert abs(cx - (cs.K_ORBIT[2] + 0.5) / WL.stride + 0.5) < 1e-9
    # the result line format the driver reads
    line = json.dumps({"ok": True, "device": {"platform": "gpu", "kind": "x", "count": 1}})
    assert set(json.loads(line)["device"]) == {"platform", "kind", "count"}


def test_online_render_determinism_phases(frames, small_seg):
    model, params = small_seg
    step = cs.phase_online(WL, frames, model, params)
    assert step.num_active_blocks() > 0
    cs.phase_render(WL, step.volume, frames)
    cs.phase_determinism(WL, step, frames)


def test_parity_phase(frames):
    cs.phase_parity(WL, frames)


def test_seg_phase(frames):
    from disinfect_slam.models.segmentation import create_model, load_default_params

    cs.phase_seg(WL, frames, create_model(), load_default_params())


def test_dense_slam_phase(frames):
    out = cs.phase_dense_slam(WL, frames)
    assert out["lost"] == 0


def test_four_device_phase(frames):
    """The sharded path on 4 of the test session's virtual CPU devices."""
    cs.phase_four_gpus(WL, frames)


def test_online_app_phase():
    cs.phase_online_app(WL)
