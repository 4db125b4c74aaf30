"""Stereo block matching: recover a known depth map from a synthetic
rectified pair (the stereo->depth path the reference lacks — it feeds
stereo only to SLAM, cameras/zed_native.cc:24-33)."""

import numpy as np

from disinfect_slam.ops.stereo import (
    StereoDepthEstimator,
    block_match,
    stereo_depth,
)

FX = 120.0
BASELINE = 0.1


def make_pair(h=96, w=160, seed=0):
    """Textured fronto-parallel planes at known disparities.

    For a constant-disparity region, the same world point appears at
    x in the left view and x-d in the right view, so
    right[y, x] = left[y, x+d] within the region.
    """
    rng = np.random.default_rng(seed)
    # smooth random texture with fine detail so windows are discriminative
    tex = rng.uniform(0, 1, (h, w + 64)).astype(np.float32)
    k = np.ones(5) / 5
    for axis in (0, 1):
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, tex
        )
    tex += rng.uniform(0, 0.35, tex.shape)
    tex = (tex - tex.min()) / (tex.max() - tex.min())

    disp = np.full((h, w), 6, np.int32)  # far background
    disp[h // 4 : h // 2, w // 5 : w // 2] = 16  # mid plane
    disp[h // 2 : 3 * h // 4, w // 2 : 4 * w // 5] = 28  # near plane

    xs = np.arange(w)
    left = tex[:, :w].copy()
    right = np.empty_like(left)
    for y in range(h):
        right[y] = tex[y, np.clip(xs + disp[y], 0, tex.shape[1] - 1)]
    # left view of each region shows tex at x (disparity-region-consistent
    # by construction); rebuild left the same way for exactness
    for y in range(h):
        left[y] = tex[y, xs]
    return left, right, disp.astype(np.float32)


def interior_mask(disp, margin=6):
    """Pixels away from depth discontinuities and image borders."""
    h, w = disp.shape
    m = np.ones_like(disp, bool)
    m[:margin] = m[-margin:] = False
    m[:, :margin] = m[:, -margin:] = False
    edge = np.zeros_like(m)
    edge[:, 1:] |= disp[:, 1:] != disp[:, :-1]
    edge[:, :-1] |= disp[:, 1:] != disp[:, :-1]
    edge[1:] |= disp[1:] != disp[:-1]
    edge[:-1] |= disp[1:] != disp[:-1]
    for _ in range(margin):
        grown = edge.copy()
        grown[1:] |= edge[:-1]
        grown[:-1] |= edge[1:]
        grown[:, 1:] |= edge[:, :-1]
        grown[:, :-1] |= edge[:, 1:]
        edge = grown
    return m & ~edge


def test_block_match_recovers_disparity_within_one():
    left, right, true_disp = make_pair()
    disp, valid = block_match(left, right, max_disp=40)
    disp, valid = np.asarray(disp), np.asarray(valid)
    m = interior_mask(true_disp) & valid
    assert m.mean() > 0.4, f"too few valid interior pixels ({m.mean():.2f})"
    err = np.abs(disp[m] - true_disp[m])
    assert np.quantile(err, 0.95) <= 1.0, f"p95 disparity err {np.quantile(err, 0.95):.2f}"
    assert err.mean() < 0.5


def test_stereo_depth_metric_conversion():
    left, right, true_disp = make_pair()
    res = stereo_depth(left, right, fx=FX, baseline_m=BASELINE, max_disp=40)
    depth = np.asarray(res.depth)
    valid = np.asarray(res.valid)
    m = interior_mask(true_disp) & valid
    true_depth = FX * BASELINE / true_disp
    rel = np.abs(depth[m] - true_depth[m]) / true_depth[m]
    # within-1-disparity accuracy implies bounded relative depth error
    assert np.quantile(rel, 0.95) < 0.2
    assert (depth[~valid] == 0).all()


def test_lr_check_kills_occluded_and_textureless():
    """A textureless band must be marked invalid, not hallucinated."""
    left, right, true_disp = make_pair()
    left[:, 40:70] = 0.5
    right[:, 40 - 16 : 70] = 0.5  # flatten the same world region
    _, valid = block_match(left, right, max_disp=40)
    valid = np.asarray(valid)
    band = valid[:, 48:62]
    assert band.mean() < 0.5, f"textureless band {band.mean():.2f} marked valid"


def test_estimator_wrapper_uint8():
    left, right, true_disp = make_pair()
    est = StereoDepthEstimator(fx=FX, baseline_m=BASELINE, max_disp=40)
    depth = est((left * 255).astype(np.uint8), (right * 255).astype(np.uint8))
    m = interior_mask(true_disp) & (depth > 0)
    assert m.mean() > 0.3
    true_depth = FX * BASELINE / true_disp
    rel = np.abs(depth[m] - true_depth[m]) / true_depth[m]
    assert np.quantile(rel, 0.9) < 0.25


def test_pyramid_recovers_disparity_in_smooth_regions():
    """Coarse-to-fine matcher: sub-0.1px accuracy on valid pixels away
    from depth discontinuities, and the discontinuity guard keeps the
    valid set clean near them (confidently-wrong pixels are the failure
    mode coarse-to-fine must not have)."""
    from disinfect_slam.ops.stereo import block_match_pyramid

    left, right, true_disp = make_pair()
    disp, valid = block_match_pyramid(left, right, max_disp=40, levels=2, band=2)
    disp, valid = np.asarray(disp), np.asarray(valid)
    m = interior_mask(true_disp) & valid
    assert m.mean() > 0.3, f"too few valid interior pixels ({m.mean():.2f})"
    err = np.abs(disp[m] - true_disp[m])
    # measured 0.061/0.128 on this fixture; generous headroom
    assert np.quantile(err, 0.95) <= 0.5, f"p95 {np.quantile(err, 0.95):.2f}"
    assert err.mean() < 0.3
    # away from discontinuities the accuracy is sub-pixel-fit limited
    m12 = interior_mask(true_disp, margin=12) & valid
    err12 = np.abs(disp[m12] - true_disp[m12])
    assert np.quantile(err12, 0.95) <= 0.15


def test_pyramid_single_level_matches_flat_closely():
    from disinfect_slam.ops.stereo import block_match_pyramid

    left, right, true_disp = make_pair()
    d_flat, v_flat = block_match(left, right, max_disp=40)
    d_pyr, v_pyr = block_match_pyramid(left, right, max_disp=40, levels=1, band=2)
    m = interior_mask(true_disp) & np.asarray(v_flat) & np.asarray(v_pyr)
    dd = np.abs(np.asarray(d_flat)[m] - np.asarray(d_pyr)[m])
    assert np.quantile(dd, 0.95) <= 1.0


def test_stereo_depth_pyramid_method():
    left, right, true_disp = make_pair()
    res = stereo_depth(
        left, right, fx=FX, baseline_m=BASELINE, max_disp=40, method="pyramid"
    )
    depth = np.asarray(res.depth)
    valid = np.asarray(res.valid)
    m = interior_mask(true_disp) & valid
    true_depth = FX * BASELINE / true_disp
    rel = np.abs(depth[m] - true_depth[m]) / true_depth[m]
    assert np.quantile(rel, 0.95) < 0.2
    assert (depth[~valid] == 0).all()
