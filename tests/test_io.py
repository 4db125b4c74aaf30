"""I/O tests: logger->replay roundtrip, config reading, rectification."""

import glob
import os

import numpy as np
import pytest

from disinfect_slam.io.config_reader import (
    get_depth_factor,
    get_extrinsics,
    get_intrinsics,
    parse_yaml,
)
from disinfect_slam.io.dataset import LoggedReplay
from disinfect_slam.io.logger import FrameLogger
from disinfect_slam.io.png_io import read_image, write_image


def test_png_16bit_roundtrip(tmp_path):
    d16 = np.random.default_rng(0).integers(0, 65535, (24, 32)).astype(np.uint16)
    p = str(tmp_path / "d.png")
    write_image(p, d16)
    back = read_image(p, unchanged=True)
    np.testing.assert_array_equal(back, d16)


def test_frame_logger_replay_roundtrip(tmp_path):
    """FrameLogger writes the pseudo_online_capture layout; LoggedReplay
    must read it back (the record/replay integration-test pattern of
    SURVEY.md §4)."""
    logdir = str(tmp_path / "log")
    lg = FrameLogger(logdir, depth_factor=1000.0)
    rng = np.random.default_rng(1)
    poses = []
    for fid in range(3):
        rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (fid * 0.1, 0, 0)
        lg.log_data((fid, rgb, depth, pose))
        poses.append((rgb, depth, pose))
    lg.close()

    replay = LoggedReplay(logdir, depth_factor=1000.0)
    assert len(replay) == 3
    for frame, (rgb, depth, pose) in zip(replay, poses):
        np.testing.assert_allclose(frame.cam_T_world, pose, atol=1e-6)
        np.testing.assert_allclose(frame.depth, depth, atol=1e-3)  # u16 quantized
        np.testing.assert_array_equal(frame.rgb.astype(np.uint8), rgb)
        # missing ht -> defaults ht=0, lt=1 (offline.cc:79-82)
        assert frame.ht.max() == 0.0 and frame.lt.min() == 1.0


def test_config_reader(tmp_path):
    cfg = {
        "Camera.fx": 517.3,
        "Camera.fy": 516.5,
        "Camera.cx": 318.6,
        "Camera.cy": 255.3,
        "depthmap_factor": 5000.0,
        "Extrinsics": list(np.eye(4).reshape(-1)),
    }
    assert get_intrinsics(cfg) == (517.3, 516.5, 318.6, 255.3)
    assert get_depth_factor(cfg) == 5000.0
    np.testing.assert_array_equal(get_extrinsics(cfg), np.eye(4))
    # absent extrinsics -> identity (offline.cc:40-43)
    np.testing.assert_array_equal(get_extrinsics({}), np.eye(4))


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_YAMLS = sorted(glob.glob(os.path.join(_REPO, "configs", "*.yaml"))) + [
    os.path.join(_REPO, "datasets", "orbit_vga", "cam.yaml")
]


@pytest.mark.parametrize("path", _YAMLS, ids=os.path.basename)
def test_yaml_subset_parser_matches_pyyaml(path):
    """The stdlib parser reads every shipped config exactly as PyYAML's
    safe_load does (keys, value types and values)."""
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    ref = yaml.safe_load(text)
    ours = parse_yaml(text)
    assert ours == ref
    assert {k: type(v) for k, v in ours.items()} == {k: type(v) for k, v in ref.items()}


class TestRectification:
    def test_identity_remap(self):
        import jax.numpy as jnp

        from disinfect_slam.ops.image_ops import bilinear_remap

        img = np.random.default_rng(2).uniform(0, 255, (16, 20)).astype(np.float32)
        yy, xx = np.mgrid[0:16, 0:20].astype(np.float32)
        out = np.asarray(bilinear_remap(jnp.asarray(img), jnp.asarray(xx), jnp.asarray(yy)))
        np.testing.assert_allclose(out, img, atol=1e-4)

    def test_halfpixel_shift_interpolates(self):
        import jax.numpy as jnp

        from disinfect_slam.ops.image_ops import bilinear_remap

        img = np.arange(16, dtype=np.float32).reshape(4, 4)
        yy, xx = np.mgrid[0:4, 0:4].astype(np.float32)
        out = np.asarray(
            bilinear_remap(jnp.asarray(img), jnp.asarray(xx + 0.5), jnp.asarray(yy))
        )
        np.testing.assert_allclose(out[:, :3], (img[:, :3] + img[:, 1:]) / 2, atol=1e-4)

    def test_rectify_maps_vs_opencv(self):
        cv2 = pytest.importorskip("cv2")

        from disinfect_slam.ops.image_ops import StereoRectifier, build_rectify_maps

        K_l = np.array([[458.0, 0, 320.0], [0, 457.0, 240.0], [0, 0, 1]])
        K_r = np.array([[459.0, 0, 321.0], [0, 458.0, 241.0], [0, 0, 1]])
        D = np.array([-0.28, 0.07, 0.0002, 0.00002, 0.0])
        from scipy.spatial.transform import Rotation

        R_rl = Rotation.from_rotvec([0.002, -0.001, 0.0015]).as_matrix()
        t_rl = np.array([-0.11, 0.0002, 0.0003])
        maps = build_rectify_maps(K_l, D, K_r, D, R_rl, t_rl, (128, 96))

        # OpenCV ground truth maps
        R_l, R_r, P_l, P_r, *_ = cv2.stereoRectify(
            K_l, D, K_r, D, (128, 96), R_rl, t_rl.reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
        )
        mx, my = cv2.initUndistortRectifyMap(K_l, D, R_l, P_l, (128, 96), cv2.CV_32FC1)
        np.testing.assert_allclose(maps.left_x, mx, atol=1e-2)
        np.testing.assert_allclose(maps.left_y, my, atol=1e-2)

        # rectified pair comes out with valid values
        rect = StereoRectifier(maps)
        img = np.random.default_rng(3).uniform(0, 255, (96, 128)).astype(np.float32)
        l, r = rect.rectify(img, img)
        assert l.shape == img.shape and np.isfinite(l).all()
        fx, fy, cx, cy = rect.rectified_intrinsics()
        assert fx > 0 and fy > 0


def test_zed_factory_conf_parsing(tmp_path):
    """ZED factory .conf -> K/D/R/T with the reference's quirks
    (utils/zed/calib.py:43-98): baseline negated mm->m, CV_ key is the
    pitch, missing keys read 0."""
    from disinfect_slam.io.zed_calib import (
        parse_factory_conf,
        rectifier_from_factory_conf,
    )

    conf = tmp_path / "SN12345.conf"
    conf.write_text(
        "[LEFT_CAM_VGA]\n"
        "fx=350.1\nfy=350.7\ncx=336.2\ncy=188.9\n"
        "k1=-0.17\nk2=0.025\n"
        "[RIGHT_CAM_VGA]\n"
        "fx=349.8\nfy=350.2\ncx=336.9\ncy=189.4\n"
        "k1=-0.171\nk2=0.026\np1=0.0002\n"
        "[STEREO]\n"
        "Baseline=119.887\nTY=0.05\nTZ=-0.21\n"
        "RX_VGA=0.001\nCV_VGA=0.003\nRZ_VGA=-0.0004\n"
    )
    c = parse_factory_conf(str(conf), "VGA")
    assert c.K_l[0, 0] == 350.1 and c.K_r[1, 2] == 189.4
    # k3 missing -> 0; p1 present only on the right
    assert c.D_l[4] == 0.0 and c.D_r[2] == 0.0002
    # baseline mm -> m with flipped sign
    np.testing.assert_allclose(c.T, [-0.119887, 0.05e-3, -0.21e-3])
    # Rodrigues: orthonormal, close to identity for tiny angles
    np.testing.assert_allclose(c.R @ c.R.T, np.eye(3), atol=1e-12)
    assert abs(c.R[0, 2] - 0.003) < 1e-4  # pitch from the CV_ key
    assert c.size == (672, 376)

    import pytest as _pytest

    with _pytest.raises(ValueError):
        parse_factory_conf(str(conf), "8K")

    # end-to-end: maps build and rectify an image pair
    rect = rectifier_from_factory_conf(str(conf), "VGA")
    img = np.random.default_rng(0).integers(0, 255, (376, 672), np.uint8)
    l, r = rect.rectify(img.astype(np.float32), img.astype(np.float32))
    assert np.asarray(l).shape == (376, 672)


def test_prefetch_replay_order_len_and_errors():
    from disinfect_slam.io.dataset import PrefetchReplay

    class FakeReplay:
        def __init__(self, n, fail_at=None):
            self.n, self.fail_at = n, fail_at

        def __len__(self):
            return self.n

        def __iter__(self):
            for i in range(self.n):
                if i == self.fail_at:
                    raise IOError(f"decode failed at {i}")
                yield i

    pf = PrefetchReplay(FakeReplay(50), depth=3)
    assert len(pf) == 50
    assert list(pf) == list(range(50))
    # re-iterable (fresh worker per pass)
    assert list(pf) == list(range(50))

    # worker exceptions surface at the failing frame, in order
    pf2 = PrefetchReplay(FakeReplay(10, fail_at=4), depth=2)
    got = []
    try:
        for x in pf2:
            got.append(x)
        assert False, "expected IOError"
    except IOError as e:
        assert "at 4" in str(e)
    assert got == [0, 1, 2, 3]
