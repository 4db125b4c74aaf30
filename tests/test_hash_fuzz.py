"""Property test: random insert/delete sequences against a dict model.

Exercises tombstone reuse, heap cycling, and duplicate handling across
both index backends over many randomized rounds.
"""

import numpy as np
import pytest

from disinfect_slam.config import TINY, TINY_DENSE
from disinfect_slam.core.state import TSDFVolume
from disinfect_slam.ops import hash as h

import jax.numpy as jnp


@pytest.mark.parametrize("cfg", [TINY, TINY_DENSE], ids=["hash", "dense"])
def test_random_insert_delete_matches_model(cfg):
    rng = np.random.default_rng(7)
    vol = TSDFVolume.create(cfg)
    model = set()
    universe = rng.integers(-12, 12, (64, 3)).astype(np.int32)
    universe = np.unique(universe, axis=0)

    for round_i in range(12):
        # random batch insert
        idx = rng.integers(0, len(universe), 16)
        coords = universe[idx]
        vol, dropped = h.insert(
            vol, jnp.asarray(coords), jnp.ones(len(coords), bool)
        )
        dropped = np.asarray(dropped)
        for c, d in zip(coords, dropped):
            if not d:
                model.add(tuple(c))
        # for coords reported dropped, they must not be resident unless
        # already present from before
        # random batch delete of some present coords
        if model and round_i % 2 == 1:
            present = [list(c) for c in list(model)[: rng.integers(1, 6)]]
            entries = h.lookup_entry(vol, jnp.asarray(present, jnp.int32))
            vol = h.delete_entries(vol, entries, jnp.ones(len(present), bool))
            for c in present:
                model.discard(tuple(c))

        # invariant: model contents all resident with distinct pool slots
        if model:
            q = np.array(sorted(model), np.int32)
            pools = np.asarray(h.lookup(vol, jnp.asarray(q)))
            assert (pools >= 0).all(), (round_i, q[pools < 0])
            assert len(np.unique(pools)) == len(q)
        # invariant: non-model coords miss
        absent = [c for c in universe.tolist() if tuple(c) not in model]
        if absent:
            pools = np.asarray(h.lookup(vol, jnp.asarray(absent, jnp.int32)))
            assert (pools == -1).all()
        # invariant: active count bookkeeping
        assert int(vol.num_active_blocks) == len(model)
