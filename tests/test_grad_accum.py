"""Gradient accumulation (ExecutionConfig.grad_accum): lax.scan over
microbatches inside one jitted step — the JAX version of the
reference's lowmem memory strategy (rotating scratch buffers,
resnet_cudnn_lowmem.cu; SURVEY.md appendix). The summed-CE convention
(resnet.cu:1806-1811) makes the accumulated gradient exactly the
full-batch gradient for batch-independent per-sample compute."""

import dataclasses

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
from resnet_tpu.train import init_train_state, make_train_step
from resnet_tpu.train.step import _loss_fn, _merge_running_stats


def cfg_with(accum, bn_mode="batch", **opt_kw):
    return TrainConfig(
        model=tiny_model_config(),
        execution=ExecutionConfig(grad_accum=accum, bn_mode=bn_mode),
        optimizer=OptimizerConfig(learning_rate=1e-3, **opt_kw),
        data=DataConfig(batch_size=8, synthetic=True),
    )


def batch_of(rng, cfg, n=8):
    d = cfg.model.input_dim
    return {
        "images": jnp.asarray(
            rng.normal(0, 50, (n, d, d, 3)).astype(np.float32)
        ),
        "labels": jnp.asarray(
            rng.integers(0, cfg.model.num_classes, (n,)).astype(np.int32)
        ),
    }


def test_frozen_bn_accum_matches_single_pass_exactly(rng):
    """With batch-independent per-sample compute (frozen BN), grad_accum=4
    must reproduce the single-pass step: same summed loss, same updated
    params, same metrics (up to fp reassociation)."""
    cfg1 = cfg_with(1, bn_mode="frozen")
    cfg4 = cfg_with(4, bn_mode="frozen")
    state = init_train_state(cfg1)
    batch = batch_of(rng, cfg1)

    s1, m1 = make_train_step(cfg1, donate=False)(state, batch)
    s4, m4 = make_train_step(cfg4, donate=False)(state, batch)

    np.testing.assert_allclose(
        float(m1["loss_sum"]), float(m4["loss_sum"]), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-5
    )
    assert float(m1["accuracy"]) == float(m4["accuracy"])
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s4.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7
        )


def test_batch_bn_accum_matches_manual_microbatch_oracle(rng):
    """With batch-stats BN the statistics sample is the microbatch; the
    accumulated gradient must equal the hand-computed sum of per-microbatch
    gradients with sequential running-stat merges."""
    accum, n = 2, 8
    cfg = cfg_with(accum)
    state = init_train_state(cfg)
    batch = batch_of(rng, cfg, n)

    # oracle: per-microbatch value_and_grad + sequential EMA merge
    grad_fn = jax.jit(
        jax.value_and_grad(_loss_fn, has_aux=True), static_argnums=(3,)
    )
    want_loss, want_grads, bn = 0.0, None, state.bn_state
    for i in range(accum):
        sl = slice(i * n // accum, (i + 1) * n // accum)
        mb = {"images": batch["images"][sl], "labels": batch["labels"][sl]}
        (loss, (_, aux)), g = grad_fn(state.params, mb, bn, cfg)
        want_loss += float(loss)
        want_grads = (
            g if want_grads is None else jax.tree.map(jnp.add, want_grads, g)
        )
        bn = _merge_running_stats(bn, aux["bn_stats"], cfg.model.bn_momentum)

    s2, m2 = make_train_step(cfg, donate=False)(state, batch)
    np.testing.assert_allclose(float(m2["loss_sum"]), want_loss, rtol=1e-6)
    want_norm = float(
        jnp.sqrt(
            sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(want_grads))
        )
    )
    np.testing.assert_allclose(float(m2["grad_norm"]), want_norm, rtol=1e-5)
    # sequential running-stat merge matches
    for a, b in zip(jax.tree.leaves(s2.bn_state), jax.tree.leaves(bn)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_accum_trains_and_composes_with_sgd_and_remat(rng):
    cfg = cfg_with(2, schedule="constant", name="sgd", momentum=0.9)
    cfg = dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, remat="block")
    )
    state = init_train_state(cfg)
    step = make_train_step(cfg, donate=False)
    batch = batch_of(rng, cfg)
    losses = []
    for _ in range(25):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::8]
    assert np.all(np.isfinite(losses))


def test_accum_validation():
    with pytest.raises(ValueError, match="grad_accum"):
        ExecutionConfig(grad_accum=0)
    cfg = cfg_with(3)  # batch 8 not divisible by 3
    state = init_train_state(cfg)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(cfg, donate=False)(state, batch_of(rng, cfg))


def test_unroll_is_numerically_identical(rng):
    """grad_accum_unroll changes only the lowered control flow (while
    loop vs straight-line); the math — and therefore every metric and
    updated parameter — must be IDENTICAL to the rolled scan."""
    base = cfg_with(4)
    cfg_unrolled = dataclasses.replace(
        base,
        execution=dataclasses.replace(base.execution, grad_accum_unroll=4),
    )
    state = init_train_state(base)
    batch = batch_of(rng, base)

    s_r, m_r = make_train_step(base, donate=False)(state, batch)
    s_u, m_u = make_train_step(cfg_unrolled, donate=False)(state, batch)

    for k in ("loss_sum", "accuracy", "grad_norm"):
        np.testing.assert_array_equal(
            np.asarray(m_r[k]), np.asarray(m_u[k]), err_msg=k
        )
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        s_r.params,
        s_u.params,
    )


def test_unroll_validation():
    with pytest.raises(ValueError, match="grad_accum_unroll"):
        ExecutionConfig(grad_accum_unroll=0)
