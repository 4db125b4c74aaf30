#!/usr/bin/env python
"""Train the ht/lt segmentation model on procedural scenes.

The reference's model weights were never published (its inference engine
loads an external TorchScript .pt, segmentation/inference.cc:39-44); this
closes the gap by training natively and shipping a checkpoint.  The net
is fully convolutional, so training runs at a reduced resolution (fast
enough on a CPU) and the weights apply unchanged at the 640x352
inference contract.

  python apps/train_seg.py --cpu --steps 400 \
      --out disinfect_slam/models/weights/seg_unet_f16.npz
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--arch", default="unet", choices=["unet", "fast"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from disinfect_slam.utils import cache

    cache.enable()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from disinfect_slam.models.segmentation import create_model
    from disinfect_slam.models.synth_data import make_batch
    from disinfect_slam.models.train import (
        TrainState,
        make_eval_step,
        make_train_step,
        save_params_npz,
    )

    model = create_model(arch=args.arch)
    rng = np.random.default_rng(args.seed)
    params = model.init(
        jax.random.PRNGKey(args.seed),
        jnp.zeros((1, args.height, args.width, 3), jnp.float32),
    )
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    print(f"[train_seg] {args.arch}: {n_params/1e6:.2f} M params", flush=True)

    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(50, args.steps // 5),
        decay_steps=args.steps,
    )
    tx = optax.adamw(sched, weight_decay=1e-4)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step_fn = jax.jit(make_train_step(model, tx), donate_argnums=0)
    eval_fn = jax.jit(make_eval_step(model))

    # held-out eval set (fixed seed disjoint from training stream)
    eval_rng = np.random.default_rng(10_000 + args.seed)
    ev_imgs, ev_labs = make_batch(eval_rng, 8, args.height, args.width)

    t0 = time.time()
    for i in range(args.steps):
        imgs, labs = make_batch(rng, args.batch, args.height, args.width)
        state, loss = step_fn(state, jnp.asarray(imgs), jnp.asarray(labs))
        if (i + 1) % args.eval_every == 0 or i == 0:
            m = eval_fn(state.params, jnp.asarray(ev_imgs), jnp.asarray(ev_labs))
            iou = np.asarray(m["iou"])
            print(
                f"[train_seg] step {i+1}/{args.steps} loss={float(loss):.4f} "
                f"eval_loss={float(m['loss']):.4f} "
                f"iou_ht={iou[0]:.3f} iou_lt={iou[1]:.3f} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )

    out = args.out or os.path.join(
        os.path.dirname(__file__), "..", "disinfect_slam", "models",
        "weights", f"seg_{args.arch}_f16.npz",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_params_npz(out, state.params)
    m = eval_fn(state.params, jnp.asarray(ev_imgs), jnp.asarray(ev_labs))
    iou = np.asarray(m["iou"])
    print(
        f"[train_seg] saved {out} ({os.path.getsize(out)/1e6:.1f} MB) "
        f"final iou_ht={iou[0]:.3f} iou_lt={iou[1]:.3f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
