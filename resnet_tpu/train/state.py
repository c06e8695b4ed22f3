"""Training state pytree.

The counterpart of Train_ResNet (resnet.h:195-215): model params, optimizer
state (Adam m/v + decay products ~ Backprop_Buffer.prev_means/prev_vars +
cur_mean_decay/cur_var_decay), BN running stats (new capability — the
reference keeps none), and the global step (~ cur_dump_id). Being a pytree,
the whole thing jits, shards, donates, and checkpoints as one value.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import TrainConfig
from ..models import init_bn_state, init_params
from ..optim import adam_init, sgd_init


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # GuardedAdamState | SGDState
    bn_state: Optional[Any]  # running BN stats pytree or None
    step: jax.Array  # global step (~ cur_dump_id, resnet.cu:1323)


def init_train_state(cfg: TrainConfig, key: Optional[jax.Array] = None) -> TrainState:
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    params = init_params(key, cfg.model, dtype=cfg.execution.pdtype)
    if cfg.optimizer.name == "adam":
        opt_state = adam_init(params)
    elif cfg.optimizer.name == "sgd":
        opt_state = sgd_init(params)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer.name!r}")
    bn_state = init_bn_state(cfg.model) if cfg.model.track_running_stats else None
    return TrainState(
        params=params,
        opt_state=opt_state,
        bn_state=bn_state,
        step=jnp.zeros((), jnp.int32),
    )
