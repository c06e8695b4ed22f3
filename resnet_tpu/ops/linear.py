"""Fully-connected layer.

The reference keeps a hand-rolled naive matMul for the FC layer in ALL
variants, including the cuDNN ones (resnet.cu:70-88, used at resnet.cu:1759;
resnet_cudnn_fast.cu:1612-1639). Backward is transpose+matmul pairs
(resnet.cu:1823-1830). Here it is one jnp.dot (a cuBLAS GEMM on the GPU); backward from
autodiff. No bias (the reference has none).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_PRECISION = {
    "default": lax.Precision.DEFAULT,
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,
}


def linear(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    precision: str = "highest",
) -> jax.Array:
    y = jnp.dot(x, w.astype(x.dtype), precision=_PRECISION[precision])
    if b is not None:
        y = y + b.astype(y.dtype)
    return y
