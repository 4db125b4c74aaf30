"""Multi-chip training/inference shardings for the segmentation model.

The flagship training step runs under a 2-D ('data', 'model') mesh:

  - data parallelism: batch dimension over 'data'; gradients are
    all-reduced by XLA from the sharding specs (no hand-written psum).
  - tensor parallelism: convolution output channels over 'model' for the
    wide trunk stages, so activations and weights split across chips.
  - spatial/sequence parallelism: activations additionally shard the
    image height dimension over 'data' during eval sweeps (halo exchange
    is inserted by XLA for the 3x3 convs).

All of this is expressed with NamedSharding constraints + jit; XLA
chooses the collectives (all-gather / reduce-scatter; NCCL on GPUs).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.segmentation import UNetSeg
from ..models.train import TrainState, bce_loss


def make_mesh_2d(n_devices: Optional[int] = None, data: int = 0, devices=None) -> Mesh:
    """Mesh over (data, model); default splits devices as evenly as possible."""
    if devices is None:
        devices = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    elif n_devices is not None:
        devices = devices[:n_devices]
    devs = list(devices)
    n = len(devs)
    if data <= 0:
        data = 1
        while data * 2 <= n and (n // (data * 2)) * (data * 2) == n:
            data *= 2
        data = max(n // 2, 1) if n > 1 else 1
    model = n // data
    return Mesh(np.array(devs).reshape(data, model), ("data", "model"))


def _param_spec(x: jnp.ndarray, tp_min_width: int = 64) -> P:
    """Shard conv kernels over output channels when divisible; replicate
    the rest."""
    if x.ndim == 4 and x.shape[-1] % 2 == 0 and x.shape[-1] >= tp_min_width:
        return P(None, None, None, "model")
    if x.ndim == 1 and x.shape[0] % 2 == 0 and x.shape[0] >= tp_min_width:
        return P("model")
    return P()


def shard_params(params, mesh: Mesh, tp_min_width: int = 64):
    def put(x):
        spec = _param_spec(x, tp_min_width)
        try:
            return jax.device_put(x, NamedSharding(mesh, spec))
        except ValueError:
            return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, params)


def make_sharded_train_step(model: UNetSeg, tx: optax.GradientTransformation, mesh: Mesh):
    """jit-compiled training step with dp/tp shardings over the mesh."""

    batch_sharding = NamedSharding(mesh, P("data"))
    replicated = NamedSharding(mesh, P())

    @partial(jax.jit, donate_argnums=0)
    def step(state: TrainState, images, labels):
        images = jax.lax.with_sharding_constraint(images, batch_sharding)
        labels = jax.lax.with_sharding_constraint(labels, batch_sharding)

        def loss_fn(params):
            logits = model.apply(params, images)
            return bce_loss(logits, labels)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def make_sharded_infer(model: UNetSeg, mesh: Mesh):
    """Inference sweep with batch + spatial sharding over 'data'/'model'."""

    spatial = NamedSharding(mesh, P("data", "model"))

    @jax.jit
    def infer(params, images):
        # shard batch over 'data' and image height over 'model'
        images = jax.lax.with_sharding_constraint(images, spatial)
        return jax.nn.sigmoid(model.apply(params, images))

    return infer
