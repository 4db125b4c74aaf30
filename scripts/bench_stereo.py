#!/usr/bin/env python
"""Stereo matcher latency A/B: flat cost volume vs coarse-to-fine
pyramid, at VGA with 64 disparities (a ZED-native 30-60 FPS stream
needs <= 33 ms, cameras/zed_native.cc:24-33).

Each iteration's output feeds the next input and the loop syncs once
at the end, so iterations cannot be collapsed or reordered.

  python scripts/bench_stereo.py
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


from disinfect_slam.ops.stereo import block_match, block_match_pyramid  # noqa: E402
from disinfect_slam.utils import cache  # noqa: E402

cache.enable()

H, W, D = 480, 640, 64
rng = np.random.default_rng(0)
left = rng.uniform(0, 1, (H, W)).astype(np.float32)
right = np.roll(left, -13, axis=1)
ld, rd = jax.device_put(left), jax.device_put(right)


@partial(jax.jit, static_argnames=("kind", "levels", "band"))
def step(l, r, kind, levels=2, band=2):
    if kind == "flat":
        disp, valid = block_match(l, r, max_disp=D)
    else:
        disp, valid = block_match_pyramid(
            l, r, max_disp=D, levels=levels, band=band
        )
    # chain the outputs into the next input (anti-DCE, anti-reorder)
    return l + (jnp.sum(disp) + jnp.sum(valid)) * 0.0, disp


def timeit(kind, n=30, **kw):
    l, disp = step(ld, rd, kind, **kw)
    float(jnp.sum(disp))  # compile + settle
    t0 = time.perf_counter()
    for _ in range(n):
        l, disp = step(l, rd, kind, **kw)
    float(jnp.sum(disp))  # one sync at the end
    return (time.perf_counter() - t0) / n * 1e3


if __name__ == "__main__":
    flat = timeit("flat")
    print(f"flat      : {flat:.1f} ms")
    for levels in (1, 2):
        for band in (2, 3):
            ms = timeit("pyr", levels=levels, band=band)
            print(f"pyr L{levels} B{band} : {ms:.1f} ms ({flat / ms:.1f}x)")
