"""TUM RGB-D loader test on a synthesized fixture (rgb.txt / depth.txt /
groundtruth.txt + 16-bit depth PNGs, factor 5000)."""

import os

import numpy as np

from disinfect_slam.io.dataset import TUMReplay
from disinfect_slam.io.png_io import write_image


def make_tum_fixture(root, n=4):
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rng = np.random.default_rng(0)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n):
        t = 1000.0 + i * 0.033
        rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        depth_m = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
        write_image(os.path.join(root, "rgb", f"{t:.4f}.png"), rgb)
        write_image(
            os.path.join(root, "depth", f"{t + 0.004:.4f}.png"),
            (depth_m * 5000).astype(np.uint16),
        )
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        depth_lines.append(f"{t + 0.004:.4f} depth/{t + 0.004:.4f}.png")
        # world_T_cam translation along x, identity rotation
        gt_lines.append(f"{t + 0.002:.4f} {0.1 * i:.4f} 0 0 0 0 0 1")
    for name, lines in [
        ("rgb.txt", rgb_lines),
        ("depth.txt", depth_lines),
        ("groundtruth.txt", gt_lines),
    ]:
        with open(os.path.join(root, name), "w") as f:
            f.write("# header\n" + "\n".join(lines) + "\n")


def test_tum_replay(tmp_path):
    make_tum_fixture(str(tmp_path))
    replay = TUMReplay(str(tmp_path))
    assert len(replay) == 4
    frames = list(replay)
    assert frames[0].depth.shape == (24, 32)
    assert 0.4 < frames[0].depth.min() and frames[0].depth.max() < 3.1
    # pose: cam_T_world = inv(world_T_cam) -> translation -0.1*i along x
    np.testing.assert_allclose(frames[2].cam_T_world[0, 3], -0.2, atol=1e-5)
    # default semantics: ht zeros, lt ones (no masks in TUM data)
    assert frames[0].ht.max() == 0 and frames[0].lt.min() == 1


def test_tum_association_drops_unmatched(tmp_path):
    make_tum_fixture(str(tmp_path))
    # add an rgb frame with no depth/gt near it
    with open(os.path.join(tmp_path, "rgb.txt"), "a") as f:
        f.write("2000.0 rgb/none.png\n")
    replay = TUMReplay(str(tmp_path))
    assert len(replay) == 4  # the orphan is dropped
