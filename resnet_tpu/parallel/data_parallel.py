"""Explicit-collective data parallelism via shard_map.

The pjit-auto path (train/step.py make_train_step) lets the partitioner
place the gradient all-reduce. This module is the manual-control variant:
per-device shards run the local forward/backward, then gradients (and
batch-summed metrics) are combined with an explicit jax.lax.psum over the
'data' axis — the gradient-sync layer the reference never had (SURVEY.md
section 2.7).

BN statistics remain per-device ("local BN", the standard DP choice —
equivalent to the reference semantics when each device sees the full batch
it normalizes over); running stats are averaged across devices when merged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import TrainConfig


def make_shard_map_train_step(cfg: TrainConfig, mesh: Mesh, donate: bool = True):
    # local import: train imports parallel for mesh helpers, so importing
    # train at module scope here would be circular
    from ..train.state import TrainState
    from ..train.step import _apply_optimizer, _loss_fn, _merge_running_stats

    axis = cfg.parallel.data_axis

    def local_step(state: TrainState, batch):
        (loss_sum, (logits, aux)), grads = jax.value_and_grad(
            _loss_fn, has_aux=True
        )(state.params, batch, state.bn_state, cfg)

        # all-reduce: sum-of-gradients across the global batch, exactly
        # the semantics of the reference's summed (not averaged) CE grad
        # (resnet.cu:1806-1811) extended across devices.
        grads = jax.lax.psum(grads, axis)
        loss_sum = jax.lax.psum(loss_sum, axis)
        correct = jax.lax.psum(
            jnp.sum((jnp.argmax(logits, -1) == batch["labels"]).astype(jnp.float32)),
            axis,
        )
        global_n = batch["labels"].shape[0] * jax.lax.psum(1, axis)

        new_params, new_opt, lr = _apply_optimizer(grads, state, cfg)
        local_bn = _merge_running_stats(
            state.bn_state, aux["bn_stats"], cfg.model.bn_momentum
        )
        # average running stats across devices so replicas stay identical
        new_bn = None if local_bn is None else jax.lax.pmean(local_bn, axis)

        metrics = {
            "loss": loss_sum / global_n,
            "loss_sum": loss_sum,
            "accuracy": correct / global_n,
            "learning_rate": lr,
            "grad_norm": jnp.sqrt(
                sum(
                    jnp.sum(jnp.square(g.astype(jnp.float32)))
                    for g in jax.tree.leaves(grads)
                )
            ),
        }
        return (
            TrainState(new_params, new_opt, new_bn, state.step + 1),
            metrics,
        )

    mapped = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), {"images": P(axis), "labels": P(axis)}),
        out_specs=(P(), P()),
        check_vma=False,
    )
    kwargs = {"donate_argnums": (0,)} if donate else {}
    return jax.jit(mapped, **kwargs)
