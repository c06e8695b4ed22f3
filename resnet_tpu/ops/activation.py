"""Activations.

relu matches doActivation/doActivationDeriv (resnet.cu:545-566): forward
max(0,x); backward passes gradient only where x > 0 strictly (the reference
zeroes at x <= 0, resnet.cu:558-563). Implemented via where() so autodiff
produces exactly that gate (jnp.maximum would split the subgradient at 0).

relu_cap matches the cuDNN-fast variant's clipped ReLU with ceiling 10
(resnet_cudnn_fast.cu:1143-1145).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def relu(x: jax.Array) -> jax.Array:
    return jnp.where(x > 0, x, jnp.zeros_like(x))


def relu_cap(x: jax.Array, cap: float = 10.0) -> jax.Array:
    return jnp.clip(x, 0.0, cap)


def residual_join(a: jax.Array, b: jax.Array, *,
                  relu_cap: Optional[float] = None) -> jax.Array:
    """relu(a + b), optionally capped — the residual join
    (resnet.cu:1717-1723)."""
    y = relu(a + b)
    if relu_cap is not None:
        y = jnp.minimum(y, jnp.asarray(relu_cap, y.dtype))
    return y
