"""Shipped segmentation weights: held-out IoU and inference contract.

The reference consumed a pre-trained torch model it never shipped
(segmentation/inference.cc:39-44); here the trained checkpoint IS part
of the repo, so lock its quality: IoU on held-out synthetic ht/lt
scenes (a seed the training loop never saw) must beat 0.7 by a margin.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from disinfect_slam.models.segmentation import (
    InferenceEngine,
    create_model,
    load_default_params,
)
from disinfect_slam.models.synth_data import make_batch
from disinfect_slam.models.train import iou_metric


@pytest.fixture(scope="module")
def shipped():
    params = load_default_params()
    if params is None:
        pytest.skip("no shipped weights")
    return create_model(), params


def test_shipped_weights_holdout_iou(shipped):
    model, params = shipped
    # held-out seed: training used seed-0 streams (apps/train_seg.py)
    imgs, labels = make_batch(np.random.default_rng(987654), 8, 352, 640)
    logits = model.apply(params, imgs)
    iou = np.asarray(iou_metric(jnp.asarray(logits, jnp.float32), labels))
    assert iou[0] > 0.7, f"ht IoU {iou[0]:.3f}"
    assert iou[1] > 0.7, f"lt IoU {iou[1]:.3f}"


def test_shipped_weights_inference_engine_contract(shipped):
    model, params = shipped
    eng = InferenceEngine(model, params)
    rgb = (np.random.default_rng(3).uniform(0, 255, (480, 640, 3))).astype(np.uint8)
    ht, lt = eng.infer_one(rgb)
    # reference output contract: 640x360 prob maps (inference.cc:46-69)
    assert ht.shape == (360, 640) and lt.shape == (360, 640)
    assert np.all(ht >= 0) and np.all(ht <= 1)
    assert np.all(lt >= 0) and np.all(lt <= 1)


@pytest.fixture(scope="module")
def shipped_fast():
    params = load_default_params(arch="fast")
    if params is None:
        pytest.skip("no shipped FastSeg weights")
    return create_model(arch="fast"), params


def test_shipped_fastseg_holdout_iou(shipped_fast):
    """The latency-first arch ships with a (documented) lower quality
    bar than the U-Net: it trades skip depth for a 2-resolution trunk.
    Gate it so regressions in the arch or training pipeline surface."""
    model, params = shipped_fast
    imgs, labels = make_batch(np.random.default_rng(987654), 8, 352, 640)
    logits = model.apply(params, imgs)
    iou = np.asarray(iou_metric(jnp.asarray(logits, jnp.float32), labels))
    assert iou[0] > 0.7, f"ht IoU {iou[0]:.3f}"
    assert iou[1] > 0.9, f"lt IoU {iou[1]:.3f}"
