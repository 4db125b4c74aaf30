"""High-touch / low-touch semantic segmentation in plain JAX.

Replaces the reference's TorchScript inference engine
(segmentation/inference.{h,cc}).  The reference ships no model weights
(the .pt is external); its *contract* is what matters and is preserved:

  - input: RGB image resized to 640x352, normalized to [0, 1]
    (inference.cc:8-9, 50)
  - output: a 2-channel probability map — channel 0 = high-touch (ht),
    channel 1 = low-touch (lt) — returned as two float32 maps resized to
    640x360, or uint8 maps scaled by 255 (inference.cc:46-69)

The network is a compact U-Net over NHWC activations: convolutions take
bf16 operands and accumulate and return f32, and the activations between
them stay f32 (rounded to bf16 only as convolution operands).  It has
strided-conv downsampling and nearest-upsample + conv decoding, all
shapes static so XLA fuses the whole forward into a handful of
convolution kernels.

Parameters are a nested dict {"params": {"ConvBlock_0": {"Conv_0":
{"kernel"}, "GroupNorm_0": {"scale", "bias"}}, ...}}: module names are
the class name plus a per-parent creation counter, so the shipped
checkpoints (models/weights/*.npz, "/"-joined keys) load unchanged.
Models expose `init(rng, x) -> variables` and `apply(variables, x)`.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# reference contract (inference.cc:49-50, 25)
INFER_W, INFER_H = 640, 352
OUTPUT_W, OUTPUT_H = 640, 360

# flax.linen.GroupNorm's default epsilon, which the shipped weights
# were trained with
GN_EPS = 1e-6
_HIGHEST = lax.Precision.HIGHEST


def _linear_resize_matrix(n_in: int, n_out: int) -> jnp.ndarray:
    """Dense [n_out, n_in] row-stochastic linear-resample matrix with
    half-pixel centers and triangle anti-aliasing on downscale — the
    same kernel jax.image.resize(..., "linear") applies, but as a
    matrix so the resize is two matmuls instead of a gather chain."""
    scale = n_in / n_out
    s = max(scale, 1.0)
    src = (jnp.arange(n_out, dtype=jnp.float32) + 0.5) * scale - 0.5
    j = jnp.arange(n_in, dtype=jnp.float32)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(j[None, :] - src[:, None]) / s)
    return w / jnp.sum(w, axis=1, keepdims=True)


def resize_linear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """[H, W, C] -> [out_h, out_w, C] linear resize via two matmuls.

    HIGHEST precision: an f32 matmul may otherwise run in TF32 on the
    GPU (10-bit mantissa), which would perturb pixel values by ~0.1 of
    a grey level."""
    h, w, c = img.shape
    a_v = _linear_resize_matrix(h, out_h)
    a_u = _linear_resize_matrix(w, out_w)
    tmp = jnp.einsum("oh,hwc->owc", a_v, img, precision=_HIGHEST)
    return jnp.einsum("pw,owc->opc", a_u, tmp, precision=_HIGHEST)


# ----------------------------------------------------------------------
# Parameter scopes: flax-compatible names without flax
# ----------------------------------------------------------------------
class _Scope:
    """One module's parameter dict.  Init mode (rng given) creates
    missing parameters; apply mode only reads them."""

    def __init__(self, params: dict, rng=None):
        self.params = params
        self.rng = rng
        self._counts: dict = {}

    def _next_rng(self):
        self.rng, sub = jax.random.split(self.rng)
        return sub

    def child(self, kind: str) -> "_Scope":
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        name = f"{kind}_{i}"
        if self.rng is None:
            return _Scope(self.params[name])
        return _Scope(self.params.setdefault(name, {}), self._next_rng())

    def param(self, name: str, init_fn, shape) -> jnp.ndarray:
        if self.rng is not None and name not in self.params:
            self.params[name] = init_fn(self._next_rng(), shape, jnp.float32)
        return self.params[name]


_kernel_init = jax.nn.initializers.lecun_normal()
_DN = ("NHWC", "HWIO", "NHWC")


def _conv_raw(x, k, stride, dilation, out_dtype=None, precision=None):
    return lax.conv_general_dilated(
        x, k, (stride, stride), "SAME", rhs_dilation=(dilation, dilation),
        dimension_numbers=_DN, precision=precision,
        preferred_element_type=out_dtype,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _conv_bf16(x, k, stride, dilation):
    """bf16 operands, products accumulated and returned in f32."""
    return _conv_raw(x, k, stride, dilation, jnp.float32)


def _conv_bf16_fwd(x, k, stride, dilation):
    return _conv_bf16(x, k, stride, dilation), (x, k)


def _conv_bf16_bwd(stride, dilation, res, g):
    # lax's transpose rule rejects an f32 cotangent against bf16
    # operands; the gradient is the bf16 convolution's, fed a bf16
    # cotangent
    x, k = res
    _, vjp = jax.vjp(lambda a, b: _conv_raw(a, b, stride, dilation), x, k)
    return vjp(g.astype(x.dtype))


_conv_bf16.defvjp(_conv_bf16_fwd, _conv_bf16_bwd)


def _round_bf16(x):
    """x rounded to bf16 (round to nearest even), as a bf16 array.

    Written as reduce_precision first so that every backend rounds here:
    XLA may otherwise keep an f32 value in place of an f32->bf16->f32
    convert pair (excess precision), and where it does so differs
    between XLA:CPU and XLA:GPU."""
    return lax.reduce_precision(x.astype(jnp.float32), 8, 7).astype(jnp.bfloat16)


def _conv(scope: _Scope, x, features: int, kernel=(3, 3), stride: int = 1,
          dilation: int = 1, dtype=jnp.bfloat16, use_bias: bool = False):
    """SAME-padded NHWC/HWIO convolution.

    bf16: operands rounded to bf16 (tensor cores), products accumulated
    and returned in f32.  An f32 result rather than a bf16 one, and the
    explicit operand rounding, make the result the same up to
    accumulation order on every backend (GPU vs CPU agreement of the
    shipped U-Net: PERF.md).  f32: HIGHEST
    precision, so the GPU does not drop to TF32."""
    s = scope.child("Conv")
    k = s.param("kernel", _kernel_init, tuple(kernel) + (x.shape[-1], features))
    if dtype == jnp.bfloat16:
        y = _conv_bf16(_round_bf16(x), _round_bf16(k), stride, dilation)
    else:
        y = _conv_raw(x.astype(dtype), k.astype(dtype), stride, dilation,
                      precision=_HIGHEST)
    if use_bias:
        y = y + s.param("bias", jax.nn.initializers.zeros, (features,)).astype(y.dtype)
    return y


def _group_norm(scope: _Scope, x, groups: int):
    """GroupNorm with f32 statistics (E[x^2] - E[x]^2, clipped at 0) and
    learned f32 scale/bias.  The output stays f32: activations are
    rounded to bf16 only where a convolution takes them (_conv), so
    every rounding point is explicit and the same on every backend."""
    s = scope.child("GroupNorm")
    c = x.shape[-1]
    scale = s.param("scale", jax.nn.initializers.ones, (c,))
    bias = s.param("bias", jax.nn.initializers.zeros, (c,))
    xf = x.astype(jnp.float32)
    xg = xf.reshape(x.shape[:-1] + (groups, c // groups))
    axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    mu = jnp.mean(xg, axis=axes)
    mu2 = jnp.mean(xg * xg, axis=axes)
    var = jnp.maximum(0.0, mu2 - mu * mu)
    mean = jnp.repeat(mu, c // groups, axis=-1)[:, None, None, :]
    var = jnp.repeat(var, c // groups, axis=-1)[:, None, None, :]
    return (xf - mean) * (lax.rsqrt(var + GN_EPS) * scale) + bias


def _conv_block(scope: _Scope, x, features: int, stride: int = 1,
                dtype=jnp.bfloat16):
    s = scope.child("ConvBlock")
    x = _conv(s, x, features, stride=stride, dtype=dtype)
    x = _group_norm(s, x, min(32, features))
    return jax.nn.silu(x)


def _upsample2(x, like):
    """2x nearest upsample cropped to `like`'s spatial shape: the stage
    shapes are exact halvings, so this is a broadcast, not a gather."""
    x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return x[:, : like.shape[1], : like.shape[2], :]


class _Model:
    """init/apply surface shared by the segmentation nets."""

    def _forward(self, scope: _Scope, x):
        raise NotImplementedError

    def init(self, rng, x):
        params: dict = {}
        self._forward(_Scope(params, rng), jnp.asarray(x, jnp.float32))
        return {"params": params}

    def apply(self, variables, x):
        return self._forward(_Scope(variables["params"]), x)


class UNetSeg(_Model):
    """Encoder-decoder segmentation net with skip connections."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 num_classes: int = 2, dtype: Any = jnp.bfloat16):
        self.widths = tuple(widths)
        self.num_classes = num_classes
        self.dtype = dtype

    def _forward(self, scope: _Scope, x):
        # x: f32 [N, H, W, 3] in [0, 1]
        dt = self.dtype
        x = x.astype(dt)
        skips = []
        for i, w in enumerate(self.widths):
            x = _conv_block(scope, x, w, stride=1 if i == 0 else 2, dtype=dt)
            x = _conv_block(scope, x, w, dtype=dt)
            skips.append(x)
        # bottleneck
        x = _conv_block(scope, x, self.widths[-1], stride=2, dtype=dt)
        x = _conv_block(scope, x, self.widths[-1], dtype=dt)
        # decoder
        for w, skip in zip(reversed(self.widths), reversed(skips)):
            x = _conv(scope, _upsample2(x, skip), w, dtype=dt)
            x = jax.nn.silu(_group_norm(scope, x, min(32, w)))
            x = jnp.concatenate([x, skip], axis=-1)
            x = _conv_block(scope, x, w, dtype=dt)
        return _conv(scope, x, self.num_classes, kernel=(1, 1),
                     dtype=jnp.float32, use_bias=True)  # [N, H, W, 2]


class FastSeg(_Model):
    """Latency-first variant: a dilated-conv trunk at 1/4 resolution
    plus ONE half-res skip for small-object recall — two resolutions
    total (vs the U-Net's five).
    """

    def __init__(self, width: int = 128, depth: int = 6, num_classes: int = 2,
                 dtype: Any = jnp.bfloat16):
        self.width = width
        self.depth = depth
        self.num_classes = num_classes
        self.dtype = dtype

    def _forward(self, scope: _Scope, x):
        dt = self.dtype
        n, h, w, _ = x.shape
        x = x.astype(dt)
        s2 = _conv_block(scope, x, self.width // 2, stride=2, dtype=dt)
        x = _conv_block(scope, s2, self.width, stride=2, dtype=dt)
        for i in range(self.depth):
            y = _conv(scope, x, self.width, dilation=2 ** (i % 3), dtype=dt)
            x = x + jax.nn.silu(_group_norm(scope, y, 32))
        # half-res skip: concat with the stride-2 features, one fuse conv
        x = jnp.concatenate([_upsample2(x, s2), s2], axis=-1)
        x = _conv_block(scope, x, self.width // 2, dtype=dt)
        logits = _conv(scope, x, self.num_classes, kernel=(1, 1),
                       dtype=jnp.float32, use_bias=True)
        return jax.vmap(lambda l: resize_linear(l, h, w))(logits)


def create_model(widths=(32, 64, 128, 256), dtype=jnp.bfloat16, arch: str = "unet"):
    """Model family: 'unet' (quality) or 'fast' (latency)."""
    if arch == "fast":
        return FastSeg(width=max(widths), dtype=dtype)
    return UNetSeg(widths=widths, dtype=dtype)


def init_params(model: UNetSeg, rng, h: int = INFER_H, w: int = INFER_W):
    return model.init(rng, jnp.zeros((1, h, w, 3), jnp.float32))


def default_weights_path(arch: str = "unet") -> str:
    import os

    return os.path.join(os.path.dirname(__file__), "weights", f"seg_{arch}_f16.npz")


def load_default_params(arch: str = "unet"):
    """Shipped checkpoint (trained by apps/train_seg.py on procedural
    ht/lt scenes), or None if absent.  The reference never shipped its
    weights (inference.cc:39-44 loads an external .pt); we do."""
    import os

    path = default_weights_path(arch)
    if not os.path.exists(path):
        return None
    from .train import load_params_npz

    return load_params_npz(path)


class InferenceEngine:
    """API parity with segmentation::inference_engine (inference.h:11-22).

    infer_one(rgb, ret_uint8) -> [ht_map, lt_map], each resized to
    640x360 like float_tensor_to_float_mat (inference.cc:25).
    """

    def __init__(self, model: UNetSeg, params, out_size: Tuple[int, int] = (OUTPUT_H, OUTPUT_W)):
        self.model = model
        self.params = params
        self.out_h, self.out_w = out_size

        @jax.jit
        def _forward(params, img):
            # img: [H, W, 3] in [0, 255] at arbitrary size; u8 uploads
            # 4x fewer bytes and widens on device (the jit specializes
            # per input dtype)
            if img.dtype != jnp.float32:
                img = img.astype(jnp.float32)
            x = resize_linear(img, INFER_H, INFER_W) / 255.0
            logits = self.model.apply(params, x[None])[0]  # [h, w, 2]
            probs = jax.nn.sigmoid(logits)
            probs = resize_linear(probs, self.out_h, self.out_w)
            return probs

        self._forward = _forward

    def infer_one(self, rgb_img: np.ndarray, ret_uint8: bool = False):
        rgb_img = np.asarray(rgb_img)
        if rgb_img.dtype != np.uint8:
            rgb_img = rgb_img.astype(np.float32)
        probs = np.asarray(self._forward(self.params, jnp.asarray(rgb_img)))
        ht, lt = probs[..., 0], probs[..., 1]
        if ret_uint8:
            ht = np.clip(ht * 255, 0, 255).astype(np.uint8)
            lt = np.clip(lt * 255, 0, 255).astype(np.uint8)
        return [ht, lt]
