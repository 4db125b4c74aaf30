"""The main path runs without flax, PyYAML, OpenCV or PIL.

Only numpy, scipy, optax, chex, einops, pytest and hypothesis can be
counted on beside JAX where the GPU runs, so the online fusion path
(camera config, PNG replay, U-Net, integrate, render, mesh, DenseSLAM)
must import and run with those four packages unavailable.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
for name in ("flax", "yaml", "cv2", "PIL"):
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path.insert(0, REPO)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from disinfect_slam.io.config_reader import get_intrinsics, load_yaml
from disinfect_slam.io.dataset import LoggedReplay
from disinfect_slam.models.segmentation import create_model, load_default_params
from disinfect_slam.models.train import load_params_npz, save_params_npz
from disinfect_slam.systems.online_step import FusedOnlineStep
from disinfect_slam.systems.tsdf_grid import TSDFGrid
from disinfect_slam.systems.dense_slam import DenseSLAM
from disinfect_slam.ops import mesh, gather, render_fast, raycast
from disinfect_slam.parallel import sharding
import disinfect_slam.io.png_io as png_io
assert not png_io._HAS_CV2 and not png_io._HAS_PIL
orbit = REPO + "/datasets/orbit_vga"
K = get_intrinsics(load_yaml(orbit + "/cam.yaml"))
frame = next(iter(LoggedReplay(orbit, 5000.0)))
assert frame.depth.shape == (480, 640) and frame.rgb.shape == (480, 640, 3)
params = load_default_params()
x = jax.numpy.zeros((1, 32, 32, 3))
assert create_model().apply(params, x).shape == (1, 32, 32, 2)
for name in ("flax", "yaml", "cv2", "PIL"):
    assert sys.modules[name] is None, name
print("MAIN PATH OK")
"""


def test_main_path_runs_without_optional_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", f"REPO = {REPO!r}\n" + SCRIPT],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MAIN PATH OK" in out.stdout
