"""The plain-JAX segmentation nets against their flax.linen definitions.

The nets were first written with flax.linen, and the shipped weights
(models/weights/*.npz) were trained that way.  The flax modules below
are that definition, kept as the reference, with two changes that the
plain-JAX nets share: their bf16 convolutions return the f32
accumulator, and GroupNorm returns f32 (activations are rounded to bf16
only as convolution operands).  On
identical params the plain-JAX forward must agree with it, and the
shipped checkpoint's tree must match what `init` builds.
"""

import functools
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from disinfect_slam.models.segmentation import (
    create_model,
    default_weights_path,
    load_default_params,
    resize_linear,
)
from disinfect_slam.models.train import (
    TrainState,
    load_params,
    load_params_npz,
    save_checkpoint,
)


def _flax_nets():
    nn = pytest.importorskip("flax.linen")
    conv_f32_out = functools.partial(
        jax.lax.conv_general_dilated, preferred_element_type=jnp.float32
    )

    class ConvBlock(nn.Module):
        features: int
        stride: int = 1
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            x = nn.Conv(
                self.features, (3, 3), strides=(self.stride, self.stride),
                padding="SAME", use_bias=False, dtype=self.dtype,
                conv_general_dilated=conv_f32_out,
            )(x)
            x = nn.GroupNorm(num_groups=min(32, self.features), dtype=jnp.float32)(x)
            return nn.silu(x)

    class UNetSeg(nn.Module):
        widths: Sequence[int] = (32, 64, 128, 256)
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            x = x.astype(self.dtype)
            skips = []
            for i, w in enumerate(self.widths):
                x = ConvBlock(w, stride=1 if i == 0 else 2)(x)
                x = ConvBlock(w)(x)
                skips.append(x)
            x = ConvBlock(self.widths[-1], stride=2)(x)
            x = ConvBlock(self.widths[-1])(x)
            for w, skip in zip(reversed(self.widths), reversed(skips)):
                _, h, w_, _ = skip.shape
                x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)[:, :h, :w_, :]
                x = nn.Conv(w, (3, 3), padding="SAME", use_bias=False,
                            dtype=self.dtype, conv_general_dilated=conv_f32_out)(x)
                x = nn.silu(nn.GroupNorm(num_groups=min(32, w), dtype=jnp.float32)(x))
                x = jnp.concatenate([x, skip], axis=-1)
                x = ConvBlock(w)(x)
            return nn.Conv(2, (1, 1), dtype=jnp.float32)(x)

    class FastSeg(nn.Module):
        width: int = 128
        depth: int = 6
        dtype: Any = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            _, h, w, _ = x.shape
            x = x.astype(self.dtype)
            s2 = ConvBlock(self.width // 2, stride=2)(x)
            x = ConvBlock(self.width, stride=2)(s2)
            for i in range(self.depth):
                d = 2 ** (i % 3)
                y = nn.Conv(self.width, (3, 3), kernel_dilation=(d, d),
                            padding="SAME", use_bias=False, dtype=self.dtype,
                            conv_general_dilated=conv_f32_out)(x)
                y = nn.GroupNorm(num_groups=32, dtype=jnp.float32)(y)
                x = x + nn.silu(y)
            x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
            x = x[:, : s2.shape[1], : s2.shape[2], :]
            x = jnp.concatenate([x, s2], axis=-1)
            x = ConvBlock(self.width // 2)(x)
            logits = nn.Conv(2, (1, 1), dtype=jnp.float32)(x)
            return jax.vmap(lambda l: resize_linear(l, h, w))(logits)

    return UNetSeg, FastSeg


def _tree_shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch", ["unet", "fast"])
def test_forward_matches_flax_reference(arch):
    """Same params, same input: the plain-JAX forward reproduces the
    flax definition bit for bit.  Both run op by op (no jit): under jit
    XLA fuses the bf16 elementwise chains differently per program, which
    moves results by bf16 rounding noise on either side."""
    UNetRef, FastRef = _flax_nets()
    if arch == "unet":
        ref = UNetRef(widths=(8, 16, 32, 32))
        ours = create_model(widths=(8, 16, 32, 32))
    else:
        ref = FastRef(width=64, depth=3)
        ours = create_model(widths=(64,), arch="fast")
        ours.depth = 3
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 48, 64, 3))
    params = ref.init(jax.random.PRNGKey(0), x)
    # identical tree: names, nesting and shapes
    assert _tree_shapes(params) == _tree_shapes(
        ours.init(jax.random.PRNGKey(0), x)
    )
    want = np.asarray(ref.apply(params, x))
    got = np.asarray(ours.apply(params, x))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_checkpoint_roundtrip_exact_and_shipped_tree(tmp_path):
    """save_checkpoint/load_params is a bit-exact f32 round trip through
    npz, and the shipped U-Net checkpoint has exactly the tree `init`
    builds."""
    model = create_model(widths=(8, 16, 16, 16))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, TrainState(params, None, jnp.zeros((), jnp.int32)))
    back = load_params(path)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    shipped = load_default_params()
    assert shipped is not None
    full = create_model()
    assert _tree_shapes(shipped) == _tree_shapes(
        jax.eval_shape(full.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    )
    assert load_params_npz(default_weights_path()).keys() == shipped.keys()
