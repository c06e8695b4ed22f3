"""End-to-end learning test: the full training loop (model + BN + Adam +
running-stat EMA + eval path) must actually learn a separable problem —
the CPU-scale stand-in for the 76% top-1 recipe (docs/imagenet_76_recipe.md).

Synthetic task: 6 classes of oriented gratings + class-specific color bias,
distinguishable by a small convnet but not linearly trivial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from resnet_tpu.config import (
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    TrainConfig,
    tiny_model_config,
)
from resnet_tpu.train import init_train_state, make_eval_step, make_train_step

N_CLASSES = 6
DIM = 16


def make_sample(rng, cls):
    yy, xx = np.mgrid[0:DIM, 0:DIM].astype(np.float32)
    angle = cls * np.pi / N_CLASSES
    freq = 0.8 + 0.15 * (cls % 3)
    grating = np.sin(freq * (np.cos(angle) * xx + np.sin(angle) * yy))
    img = np.stack([grating] * 3, axis=-1) * 40.0
    img[..., cls % 3] += 15.0  # color bias
    img += rng.normal(0, 8.0, img.shape)  # noise
    return img.astype(np.float32)


def make_batch(rng, n):
    labels = rng.integers(0, N_CLASSES, (n,))
    images = np.stack([make_sample(rng, int(c)) for c in labels])
    return {
        "images": jnp.asarray(images),
        "labels": jnp.asarray(labels.astype(np.int32)),
    }


def test_learns_synthetic_classification(rng):
    cfg = TrainConfig(
        model=tiny_model_config(num_classes=N_CLASSES),
        execution=ExecutionConfig(),
        optimizer=OptimizerConfig(learning_rate=2e-3),
        data=DataConfig(batch_size=32),
    )
    state = init_train_state(cfg)
    step = make_train_step(cfg, donate=False)
    for i in range(120):
        state, m = step(state, make_batch(rng, 32))
    train_acc = float(m["accuracy"])
    assert train_acc > 0.9, f"train acc {train_acc}"

    # eval path: fresh samples, running BN statistics (never seen in train)
    eval_step = make_eval_step(cfg)
    accs = [
        float(eval_step(state, make_batch(rng, 32))["accuracy"])
        for _ in range(4)
    ]
    assert float(np.mean(accs)) > 0.8, accs


def test_learns_with_ghost_bn(rng):
    """bn_stats_batch (ghost BN) must not break learning — stats from a
    quarter of the batch, normalization over all of it (the per-replica-BN
    situation of any data-parallel run; Hoffer et al. 2017)."""
    cfg = TrainConfig(
        model=tiny_model_config(num_classes=N_CLASSES),
        execution=ExecutionConfig(bn_stats_batch=8),
        optimizer=OptimizerConfig(learning_rate=2e-3),
        data=DataConfig(batch_size=32),
    )
    state = init_train_state(cfg)
    step = make_train_step(cfg, donate=False)
    for i in range(120):
        state, m = step(state, make_batch(rng, 32))
    train_acc = float(m["accuracy"])
    assert train_acc > 0.85, f"train acc with ghost BN {train_acc}"
