"""Learning-rate schedules.

The reference uses a constant LR per variant (1e-4 or 1e-3, resnet.cu:3286).
Schedules are new capability required for the accuracy target
(docs/imagenet_76_recipe.md: 76% top-1 needs warmup + decay per Goyal et al. 2017, whose zero-gamma trick
the reference's comments already cite at resnet.cu:695-698).

All schedules are step -> lr functions built from jnp so they trace cleanly
inside jit (no python branching on the traced step).
"""

from __future__ import annotations

import jax.numpy as jnp


def constant(base_lr: float):
    def fn(step):
        return jnp.float32(base_lr)

    return fn


def cosine(base_lr: float, total_steps: int, warmup_steps: int = 0, final_lr: float = 0.0):
    def fn(step):
        step = jnp.asarray(step, jnp.float32)
        warm = base_lr * step / jnp.maximum(warmup_steps, 1)
        decay_steps = jnp.maximum(total_steps - warmup_steps, 1)
        t = jnp.clip((step - warmup_steps) / decay_steps, 0.0, 1.0)
        cos = final_lr + 0.5 * (base_lr - final_lr) * (1 + jnp.cos(jnp.pi * t))
        return jnp.where(step < warmup_steps, warm, cos).astype(jnp.float32)

    return fn


def step_decay(base_lr: float, boundaries, factor: float = 0.1, warmup_steps: int = 0):
    """Piecewise-constant decay (the classic /10 at epochs 30/60/80)."""
    bounds = jnp.asarray(sorted(boundaries), jnp.float32)

    def fn(step):
        step = jnp.asarray(step, jnp.float32)
        n_passed = jnp.sum(step >= bounds)
        lr = base_lr * (factor**n_passed.astype(jnp.float32))
        warm = base_lr * step / jnp.maximum(warmup_steps, 1)
        return jnp.where(step < warmup_steps, warm, lr).astype(jnp.float32)

    return fn


def make_schedule(cfg):
    """Build a schedule from an OptimizerConfig."""
    if cfg.schedule == "constant":
        return constant(cfg.learning_rate)
    if cfg.schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("cosine schedule requires total_steps > 0")
        return cosine(cfg.learning_rate, cfg.total_steps, cfg.warmup_steps)
    if cfg.schedule == "step":
        if cfg.total_steps <= 0:
            raise ValueError("step schedule requires total_steps > 0")
        boundaries = [cfg.total_steps * f for f in (0.3, 0.6, 0.8)]
        return step_decay(cfg.learning_rate, boundaries, 0.1, cfg.warmup_steps)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
