"""Jitted train / eval steps.

One train step fuses the reference's four per-iteration phases —
forward_pass, loss/accuracy, backwards_pass, update_parameters
(resnet.cu:3340-3404) — into a single XLA program: forward + CE + autodiff
backward + guarded Adam, with no host synchronization between phases (the
reference calls cudaDeviceSynchronize between each, resnet.cu:3342-3404).

Gradient convention matches the reference: CE grad is summed over the batch,
not averaged (resnet.cu:1806-1811). The *reported* loss is the batch mean of
-log p[label] (resnet.cu:3360-3380).

Data parallelism: with a mesh, the same step function is jitted with the
batch sharded over the 'data' axis and state replicated; XLA inserts the
gradient all-reduce (NCCL across GPUs, SURVEY.md section 2.7). An explicit shard_map
variant lives in parallel/data_parallel.py.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp

from ..config import TrainConfig
from ..models import forward
from ..ops import cross_entropy, top1_accuracy, topk_accuracy, update_running_stats
from ..optim import adam_update, make_schedule, sgd_update
from .state import TrainState


def _loss_fn(params, batch, bn_state, cfg: TrainConfig):
    images, labels = batch["images"], batch["labels"]
    logits, aux = forward(
        params, images, cfg.model, cfg.execution, train=True, bn_state=bn_state
    )
    loss = cross_entropy(
        logits, labels, reduction="sum",
        label_smoothing=cfg.optimizer.label_smoothing,
    )
    return loss, (logits, aux)


def _merge_running_stats(bn_state, bn_stats, momentum: float):
    """EMA running-stat update keyed to matching pytree paths."""
    if bn_state is None:
        return None

    def upd(state_leaf, mean, var):
        new_mean, new_var = update_running_stats(
            state_leaf["mean"], state_leaf["var"], mean, var, momentum
        )
        return {"mean": new_mean, "var": new_var}

    new_state = {
        "init_bn": upd(bn_state["init_bn"], *bn_stats["init_bn"]),
        "blocks": [
            {k: upd(sb[k], *bb[k]) for k in sb}
            for sb, bb in zip(bn_state["blocks"], bn_stats["blocks"])
        ],
    }
    return new_state


def _wd_mask_tree(params, mode: str):
    """Per-leaf weight-decay multiplier. 'no_bn' zeroes decay on BN
    gamma/beta and biases (Goyal et al. 2017 recipe)."""
    if mode == "all":
        return None
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = []
    for path, leaf in flat:
        keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        decayed = not any(t in keys for t in ("gamma", "beta", "/b"))
        out.append(jnp.float32(1.0 if decayed else 0.0))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), out
    )


def _apply_optimizer(grads, state: TrainState, cfg: TrainConfig):
    ocfg = cfg.optimizer
    schedule = make_schedule(ocfg)
    lr = schedule(state.opt_state.step)
    if ocfg.name == "adam":
        new_params, new_opt = adam_update(
            grads,
            state.opt_state,
            state.params,
            learning_rate=lr,
            weight_decay=ocfg.weight_decay,
            beta1=ocfg.beta1,
            beta2=ocfg.beta2,
            eps=ocfg.eps,
            nonfinite_guard=ocfg.nonfinite_guard,
            wd_mask=_wd_mask_tree(state.params, ocfg.wd_mask),
        )
    elif ocfg.name == "sgd":
        new_params, new_opt = sgd_update(
            grads,
            state.opt_state,
            state.params,
            learning_rate=lr,
            momentum=ocfg.momentum,
            weight_decay=ocfg.weight_decay,
            wd_mask=_wd_mask_tree(state.params, ocfg.wd_mask),
        )
    else:
        raise ValueError(f"unknown optimizer {ocfg.name!r}")
    return new_params, new_opt, lr


def train_step(state: TrainState, batch, cfg: TrainConfig,
               micro_shardings=None):
    """Pure train step: (state, batch) -> (new_state, metrics)."""
    if cfg.execution.grad_accum > 1:
        loss_sum, n_correct, grads, new_bn = _accum_grads(
            state, batch, cfg, micro_shardings
        )
    else:
        (loss_sum, (logits, aux)), grads = jax.value_and_grad(
            _loss_fn, has_aux=True
        )(state.params, batch, state.bn_state, cfg)
        n_correct = top1_accuracy(logits, batch["labels"], mean=False)
        # Only batch-stats BN produces real statistics worth merging:
        # 'frozen' returns the running stats themselves and 'off' returns
        # (0, 1) placeholders — EMA-merging either would silently corrupt
        # the stored running statistics of a checkpointed diagnostic run.
        if cfg.execution.bn_mode == "batch":
            new_bn = _merge_running_stats(
                state.bn_state, aux["bn_stats"], cfg.model.bn_momentum
            )
        else:
            new_bn = state.bn_state

    new_params, new_opt, lr = _apply_optimizer(grads, state, cfg)
    batch_n = batch["labels"].shape[0]
    metrics = {
        "loss": loss_sum / batch_n,  # reported mean, resnet.cu:3360-3380
        "loss_sum": loss_sum,
        "accuracy": n_correct / batch_n,
        "learning_rate": lr,
        "grad_norm": jnp.sqrt(
            sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jax.tree.leaves(grads))
        ),
    }
    new_state = TrainState(
        params=new_params,
        opt_state=new_opt,
        bn_state=new_bn,
        step=state.step + 1,
    )
    return new_state, metrics


def _accum_grads(state: TrainState, batch, cfg: TrainConfig,
                 micro_shardings=None):
    """Summed gradients over grad_accum microbatches via one device-side
    lax.scan: one microbatch's activations live at a time (the lowmem
    memory strategy, SURVEY.md appendix), while the summed-CE convention
    (resnet.cu:1806-1811) makes the accumulated gradient EXACTLY the
    full-batch gradient wherever the per-sample compute is batch-independent
    (frozen/off BN; with batch-stats BN the statistics sample is the
    microbatch — see ExecutionConfig.grad_accum).

    micro_shardings: optional {name: NamedSharding} for the RESHAPED
    (accum, micro, ...) batch arrays. When the batch comes in with a
    non-trivial input sharding (e.g. the spatially-partitioned
    P('data','spatial') images), XLA's sharding propagation through the
    microbatch reshape is not reliable: the partitioner can mis-derive
    the scan body's conv filter-gradient partitioning and over-count
    each microbatch's stem weight-grad contribution by the accumulation
    factor (loss and every other leaf stay correct, which is why only a
    grad-norm equivalence gate catches it). Pinning the reshaped arrays
    to leading-dim-replicated versions of the input specs restores
    1-device-exact numerics; make_train_step derives and threads these
    automatically."""
    a = cfg.execution.grad_accum
    n = batch["labels"].shape[0]
    if n % a != 0:
        raise ValueError(
            f"batch size {n} is not divisible by grad_accum={a}"
        )
    micro = jax.tree.map(
        lambda x: x.reshape((a, n // a) + x.shape[1:]), batch
    )
    if micro_shardings is not None:
        micro = {
            k: jax.lax.with_sharding_constraint(
                v, micro_shardings[k]["stacked"]
            ) if k in micro_shardings else v
            for k, v in micro.items()
        }
    grad_fn = jax.value_and_grad(_loss_fn, has_aux=True)

    def body(carry, mb):
        if micro_shardings is not None:
            # Re-pin each scanned microbatch to the accum=1 batch
            # shardings: this recreates, inside the scan body, exactly
            # the partitioning environment of the (equivalence-tested)
            # unaccumulated step, instead of trusting propagation
            # through the scan slice.
            mb = {
                k: jax.lax.with_sharding_constraint(
                    v, micro_shardings[k]["slice"]
                ) if k in micro_shardings else v
                for k, v in mb.items()
            }
        loss_acc, correct_acc, grads_acc, bn_state = carry
        (loss_sum, (logits, aux)), grads = grad_fn(
            state.params, mb, bn_state, cfg
        )
        grads_acc = jax.tree.map(jnp.add, grads_acc, grads)
        if cfg.execution.bn_mode == "batch":
            bn_state = _merge_running_stats(
                bn_state, aux["bn_stats"], cfg.model.bn_momentum
            )
        correct_acc = correct_acc + top1_accuracy(
            logits, mb["labels"], mean=False
        )
        return (loss_acc + loss_sum, correct_acc, grads_acc, bn_state), None

    init = (
        jnp.float32(0.0),
        jnp.float32(0.0),
        jax.tree.map(jnp.zeros_like, state.params),
        state.bn_state,
    )
    (loss_sum, n_correct, grads, bn_state), _ = jax.lax.scan(
        body, init, micro,
        unroll=min(cfg.execution.grad_accum_unroll, a),
    )
    return loss_sum, n_correct, grads, bn_state


def eval_step(state: TrainState, batch, cfg: TrainConfig):
    logits, _ = forward(
        state.params,
        batch["images"],
        cfg.model,
        cfg.execution,
        train=False,
        bn_state=state.bn_state,
    )
    loss = cross_entropy(logits, batch["labels"], reduction="mean")
    return {
        "loss": loss,
        "accuracy": top1_accuracy(logits, batch["labels"]),
        "top5": topk_accuracy(logits, batch["labels"], 5),
    }


def make_train_step(
    cfg: TrainConfig, mesh=None, donate: bool = True, state_shardings=None,
    batch_shardings=None,
):
    """Jit the train step, optionally sharded over a device mesh.

    With a mesh, batch arrays are sharded along the 'data' axis and state is
    replicated; jit's partitioner inserts the gradient all-reduce (the
    NCCL layer the reference lacks, SURVEY.md 2.7).
    state_shardings overrides the replicated state placement for composite
    meshes (e.g. parallel.composite_shardings: FC head tensor-parallel over
    a 'model' axis); batch_shardings overrides the batch placement (e.g.
    images P('data', 'spatial') for spatially-partitioned large-image
    training, parallel.spatial_shard_batch) — the partitioner derives the
    matching collectives (gradient psums, conv halo exchanges).
    """
    fn = functools.partial(train_step, cfg=cfg)
    kwargs: Dict[str, Any] = {}
    if donate:
        kwargs["donate_argnums"] = (0,)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        replicated = NamedSharding(mesh, P())
        state_sh = state_shardings if state_shardings is not None else replicated
        batch_sharded = batch_shardings if batch_shardings is not None else {
            "images": NamedSharding(mesh, P(cfg.parallel.data_axis)),
            "labels": NamedSharding(mesh, P(cfg.parallel.data_axis)),
        }
        if cfg.execution.grad_accum > 1:
            # Spatially-sharded inputs (image dims carrying a mesh axis)
            # cannot be combined with in-step microbatch accumulation on
            # this stack: jax 0.9.0's SPMD partitioner derives WRONG
            # conv/BN gradient collectives for the microbatched body
            # (stem filter-grad over-counted by the accumulation factor,
            # BN beta grads under-reduced by the data-axis size — loss
            # stays exact, only gradients corrupt; guard asserted in
            # tests/test_parallel.py::
            # test_grad_accum_composes_with_spatial_and_zero).
            # Explicit sharding constraints on the reshaped stack, on
            # the scanned slice, and a dynamic-slice formulation were
            # all tried and all still miscompile; accum=1 spatial and
            # accum>1 non-spatial are each exact. Fail loudly at config
            # level rather than train on silently corrupt gradients.
            for k, sh in batch_sharded.items():
                spec = tuple(sh.spec)
                if any(ax is not None for ax in spec[1:]):
                    raise ValueError(
                        "grad_accum > 1 cannot be combined with "
                        f"non-batch-dim sharding (batch[{k!r}] spec "
                        f"{sh.spec}): XLA SPMD miscompiles the "
                        "microbatched gradient collectives for "
                        "spatially-sharded inputs (see "
                        "train/step.py:make_train_step). Use "
                        "grad_accum=1 with spatial partitioning, or "
                        "drop --spatial-devices."
                    )
            # Pin the microbatch-reshaped batch's shardings (input spec
            # with a replicated leading accum dim): sharding propagation
            # through the reshape is otherwise ambiguous, and for purely
            # batch-sharded inputs the pin keeps the scan body's
            # partitioning identical to the accum=1 step's.
            micro_sh = {
                k: {
                    "stacked": NamedSharding(
                        mesh, P(*((None,) + tuple(sh.spec)))
                    ),
                    "slice": sh,
                }
                for k, sh in batch_sharded.items()
            }
            fn = functools.partial(fn, micro_shardings=micro_sh)
        kwargs["in_shardings"] = (state_sh, batch_sharded)
        kwargs["out_shardings"] = (state_sh, replicated)
    return jax.jit(fn, **kwargs)


def make_eval_step(cfg: TrainConfig, mesh=None, batch_shardings=None,
                   state_shardings=None):
    fn = functools.partial(eval_step, cfg=cfg)
    kwargs: Dict[str, Any] = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        replicated = NamedSharding(mesh, P())
        state_sh = state_shardings if state_shardings is not None else replicated
        batch_sharded = batch_shardings if batch_shardings is not None else {
            "images": NamedSharding(mesh, P(cfg.parallel.data_axis)),
            "labels": NamedSharding(mesh, P(cfg.parallel.data_axis)),
        }
        kwargs["in_shardings"] = (state_sh, batch_sharded)
        kwargs["out_shardings"] = replicated
    return jax.jit(fn, **kwargs)
