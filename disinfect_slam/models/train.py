"""Training for the segmentation model: loss, train step, checkpointing.

The reference consumes a pre-trained TorchScript model and ships no
training code; this module closes that gap so the ht/lt model can be
(re)trained natively.  The train step is pure and pjit-able: see
parallel/sharding.py for the multi-chip (data-parallel + spatially
sharded) version.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .segmentation import UNetSeg


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def bce_loss(logits: jnp.ndarray, labels: jnp.ndarray, mask=None) -> jnp.ndarray:
    """Per-channel binary cross entropy on the 2-channel ht/lt maps."""
    losses = optax.sigmoid_binary_cross_entropy(logits, labels)
    if mask is not None:
        losses = losses * mask[..., None]
        return losses.sum() / jnp.maximum(mask.sum() * logits.shape[-1], 1.0)
    return losses.mean()


def create_train_state(
    model: UNetSeg, rng, lr: float = 3e-4, h: int = 352, w: int = 640
) -> Tuple[TrainState, optax.GradientTransformation]:
    params = model.init(rng, jnp.zeros((1, h, w, 3), jnp.float32))
    tx = optax.adamw(lr, weight_decay=1e-4)
    return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)), tx


def make_train_step(model: UNetSeg, tx: optax.GradientTransformation):
    """Returns a jittable (state, images, labels) -> (state, loss) step.

    images: f32 [N, H, W, 3] in [0, 1]; labels: f32 [N, H, W, 2].
    """

    def train_step(state: TrainState, images, labels):
        def loss_fn(params):
            logits = model.apply(params, images)
            return bce_loss(logits, labels)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def save_params_npz(path: str, params, dtype=np.float16) -> None:
    """Flattened param tree as an .npz ("/"-joined keys).  The default
    float16 storage halves the repo cost of the committed weights; the
    loader casts back to f32."""
    flat = _flatten(params)
    # a file object keeps numpy from appending ".npz" to the name
    with open(path, "wb") as f:
        np.savez_compressed(
            f, **{k: np.asarray(v).astype(dtype) for k, v in flat.items()}
        )


def load_params_npz(path: str, dtype=jnp.float32):
    with np.load(path) as z:
        flat = {k: jnp.asarray(z[k], dtype) for k in z.files}
    return _unflatten(flat)


def save_checkpoint(path: str, state: TrainState) -> None:
    """Training checkpoint: the params at full f32 precision, as npz."""
    save_params_npz(path, state.params, dtype=np.float32)


def load_params(path: str):
    """Params saved by save_checkpoint."""
    return load_params_npz(path)


def iou_metric(logits: jnp.ndarray, labels: jnp.ndarray, thresh: float = 0.5):
    """Per-channel intersection-over-union of thresholded predictions.

    logits/labels: [N, H, W, C]; returns [C] IoU in [0, 1].
    """
    pred = jax.nn.sigmoid(logits) > thresh
    lab = labels > 0.5
    inter = jnp.sum(pred & lab, axis=(0, 1, 2)).astype(jnp.float32)
    union = jnp.sum(pred | lab, axis=(0, 1, 2)).astype(jnp.float32)
    return inter / jnp.maximum(union, 1.0)


def make_eval_step(model: UNetSeg):
    """Jittable eval: (params, images, labels) -> {loss, iou[C]}."""

    def eval_step(params, images, labels):
        logits = model.apply(params, images)
        return {
            "loss": bce_loss(logits, labels),
            "iou": iou_metric(logits, labels),
        }

    return eval_step
