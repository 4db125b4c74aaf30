"""Volume checkpoint / resume.

The reference has no live resume — its persistence is the raw voxel dump
+ trajectory export (SURVEY.md §5 "Checkpoint/resume").  Because the
volume is a plain pytree of arrays, full checkpointing is trivial: this
module saves/loads the complete TSDFVolume (hash entries, free heap,
payloads) so a reconstruction session can stop and resume exactly.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from ..config import TSDFConfig
from ..core.state import TSDFVolume

_FIELDS = (
    "entry_key",
    "entry_block",
    "block_table",
    "heap",
    "num_free",
    "oob_count",
    "tsdf",
    "rgbw",
    "prob",
)


def save_volume(path: str, vol: TSDFVolume) -> None:
    """Write the full volume state + config to one .npz file."""
    arrays = {f: np.asarray(getattr(vol, f)) for f in _FIELDS}
    arrays["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(vol.cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_volume(path: str) -> TSDFVolume:
    data = np.load(path)
    fields = json.loads(bytes(data["__config__"]).decode())
    # drop config keys this version no longer has (e.g. the excised
    # visible_buckets) so old checkpoints keep loading
    known = {f.name for f in dataclasses.fields(TSDFConfig)}
    fields = {k: v for k, v in fields.items() if k in known}
    # JSON has no tuples; restore tuple-typed fields exactly
    if fields.get("grid_origin") is not None:
        fields["grid_origin"] = tuple(fields["grid_origin"])
    cfg = TSDFConfig(**fields)
    kwargs = {
        f: jnp.asarray(data[f]) for f in _FIELDS if f in data.files
    }
    # pre-round-4 checkpoints stored the unpacked [E, 3] coordinate
    # array; pack it into the entry_key storage (core/state.py)
    if "entry_key" not in kwargs and "entry_pos" in data.files:
        from ..core import voxel as _vx

        kwargs["entry_key"] = _vx.pack_block_coord(
            jnp.asarray(data["entry_pos"]), cfg
        )
    # pre-round-3 checkpoints lack the oob accumulator
    kwargs.setdefault("oob_count", jnp.zeros((), jnp.int32))
    if "rgbw" not in kwargs:
        # older checkpoints stored separate weight + rgb arrays (all-f32
        # or u8); pack them into the RGBW word exactly
        w8 = np.asarray(data["weight"]).astype(np.uint32)
        rgb8 = np.asarray(data["rgb"]).astype(np.uint32)
        kwargs["rgbw"] = jnp.asarray(
            rgb8[..., 0] | (rgb8[..., 1] << 8) | (rgb8[..., 2] << 16)
            | (w8 << 24)
        )
    return TSDFVolume(cfg=cfg, **kwargs)
