"""Segmentation model tests: contract shapes, jit stability, training
convergence, inference-engine API parity."""

import jax
import jax.numpy as jnp
import numpy as np

from disinfect_slam.models.segmentation import (
    INFER_H,
    INFER_W,
    InferenceEngine,
    create_model,
)
from disinfect_slam.models.train import (
    bce_loss,
    create_train_state,
    load_params,
    make_train_step,
    save_checkpoint,
)

SMALL = dict(widths=(8, 16, 32, 32))


def test_forward_contract_shape():
    model = create_model(**SMALL)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    out = model.apply(params, jnp.zeros((2, 64, 96, 3)))
    assert out.shape == (2, 64, 96, 2)  # 2-channel ht/lt logits
    assert out.dtype == jnp.float32


def test_full_res_contract():
    """The reference contract: 640x352 input (inference.cc:49-50)."""
    model = create_model(**SMALL)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, INFER_H, INFER_W, 3)))
    out = model.apply(params, jnp.zeros((1, INFER_H, INFER_W, 3)))
    assert out.shape == (1, INFER_H, INFER_W, 2)


def test_train_step_decreases_loss():
    model = create_model(**SMALL)
    state, tx = create_train_state(model, jax.random.PRNGKey(1), lr=1e-3, h=32, w=32)
    step = jax.jit(make_train_step(model, tx))
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32))
    # learnable target: left half ht, right half lt
    labels = np.zeros((4, 32, 32, 2), np.float32)
    labels[:, :, :16, 0] = 1
    labels[:, :, 16:, 1] = 1
    labels = jnp.asarray(labels)
    losses = []
    for _ in range(10):
        state, loss = step(state, images, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_inference_engine_api():
    """infer_one returns [ht, lt] resized to 640x360 like
    float_tensor_to_float_mat (inference.cc:25)."""
    model = create_model(**SMALL)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, INFER_H, INFER_W, 3)))
    eng = InferenceEngine(model, params)
    rgb = np.random.default_rng(2).integers(0, 255, (480, 848, 3)).astype(np.uint8)
    ht, lt = eng.infer_one(rgb)
    assert ht.shape == (360, 640) and lt.shape == (360, 640)
    assert ht.dtype == np.float32
    assert 0 <= ht.min() and ht.max() <= 1
    ht8, lt8 = eng.infer_one(rgb, ret_uint8=True)
    assert ht8.dtype == np.uint8 and lt8.shape == (360, 640)


def test_checkpoint_roundtrip(tmp_path):
    model = create_model(**SMALL)
    state, _ = create_train_state(model, jax.random.PRNGKey(3), h=32, w=32)
    path = str(tmp_path / "seg.ckpt")
    save_checkpoint(path, state)
    params2 = load_params(path)
    x = jnp.ones((1, 32, 32, 3))
    np.testing.assert_allclose(
        np.asarray(model.apply(state.params, x)),
        np.asarray(model.apply(params2, x)),
        atol=1e-6,
    )


def test_bce_loss_masked():
    logits = jnp.zeros((1, 4, 4, 2))
    labels = jnp.ones((1, 4, 4, 2))
    mask = jnp.zeros((1, 4, 4)).at[0, 0, 0].set(1.0)
    full = bce_loss(logits, labels)
    masked = bce_loss(logits, labels, mask)
    assert np.isfinite(float(full)) and np.isfinite(float(masked))
    np.testing.assert_allclose(float(full), float(masked), atol=1e-6)


def test_fast_arch_contract():
    model = create_model(widths=(8, 16, 32, 64), arch="fast")
    import jax

    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    out = model.apply(params, jnp.zeros((2, 64, 96, 3)))
    assert out.shape == (2, 64, 96, 2)
    assert out.dtype == jnp.float32


def test_iou_and_eval_step():
    from disinfect_slam.models.train import iou_metric, make_eval_step

    logits = jnp.full((1, 4, 4, 2), -10.0).at[0, :2, :, 0].set(10.0)
    labels = jnp.zeros((1, 4, 4, 2)).at[0, :2, :, 0].set(1.0)
    iou = np.asarray(iou_metric(logits, labels))
    assert iou[0] == 1.0  # perfect channel 0
    # channel 1: no predictions, no labels -> union 0 -> IoU 0 by convention
    assert iou[1] == 0.0

    model = create_model(**SMALL)
    import jax

    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    ev = jax.jit(make_eval_step(model))
    out = ev(params, jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 32, 32, 2)))
    assert np.isfinite(float(out["loss"])) and out["iou"].shape == (2,)


def test_resize_linear_matches_jax_image():
    """The matmul resize must reproduce jax.image.resize('linear')
    (same half-pixel triangle kernel) — it replaced it in the inference
    engine because the original lowers to a gather chain."""
    import jax

    from disinfect_slam.models.segmentation import resize_linear

    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.uniform(0, 255, (48, 64, 3)).astype(np.float32))
    for oh, ow in ((35, 64), (36, 64), (96, 128), (48, 64)):
        a = np.asarray(resize_linear(img, oh, ow))
        b = np.asarray(jax.image.resize(img, (oh, ow, 3), "linear"))
        assert np.max(np.abs(a - b)) < 1e-3, (oh, ow)
