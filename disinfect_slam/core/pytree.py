"""Frozen dataclasses registered as JAX pytrees.

`pytree_dataclass` makes every field a pytree leaf except those declared
with `static_field()`, which travel as hashable aux data (so they stay
compile-time constants under jit), and gives instances a `.replace`.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls
