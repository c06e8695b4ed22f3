"""Pooling ops.

Max pool replaces doMaxPool/maxPoolDeriv (resnet.cu:433-497). The reference
records argmax indices in forward and scatters the gradient to them in
backward; on TPU that materialized index buffer is unnecessary. Two backward
realizations are provided (ExecutionConfig.maxpool_vjp):

- 'select_scatter': XLA's autodiff of reduce_window (SelectAndScatter).
  Tie-breaking matches the reference (first maximum wins) because the
  reference's strict '>' comparison (resnet.cu:461) picks the first max in
  scan order, as does SelectAndScatter.
- 'mask': custom VJP that reconstructs the scatter as k*k out-grid
  elementwise passes — for each window offset, compare the stride-s slice
  of the (-inf-padded) input against the pooled output, gate dy by
  "equal AND not matched by an earlier offset" (the reference's first-win
  scan order), and accumulate on the input grid via an interior-dilated
  pad. Semantics are identical to the reference scatter including ties.
  'mask' is a semantics cross-check; 'select_scatter' is the default
  (neither has been timed on the GPU).

Global average pool replaces doFilterAvgPool/filterAvgPoolDeriv
(resnet.cu:500-543): mean over 7x7, backward broadcasts grad/49.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .conv import spatial_dims
from .padding import reference_padding


def max_pool(
    x: jax.Array,
    *,
    kernel: int = 3,
    stride: int = 2,
    layout: str = "NHWC",
    vjp: str = "select_scatter",
) -> jax.Array:
    if vjp == "mask":
        return _max_pool_maskvjp(x, kernel, stride, layout)
    if vjp != "select_scatter":
        raise ValueError(f"max_pool vjp={vjp!r}; expected 'select_scatter' or 'mask'")
    return _max_pool_fwd_only(x, kernel, stride, layout)


def _max_pool_fwd_only(x, kernel, stride, layout):
    hdim, wdim = spatial_dims(layout)
    pad_h = reference_padding(x.shape[hdim], kernel, stride)
    pad_w = reference_padding(x.shape[wdim], kernel, stride)
    window = [1, 1, 1, 1]
    strides = [1, 1, 1, 1]
    window[hdim], window[wdim] = kernel, kernel
    strides[hdim], strides[wdim] = stride, stride
    padding = [(0, 0), (0, 0), (0, 0), (0, 0)]
    padding[hdim], padding[wdim] = pad_h, pad_w
    # NB: the init value must be a weakly-typed scalar — a concrete
    # jnp.array(-inf, dtype) breaks reduce_window's reverse-mode rule
    # under jit on jax 0.9 ("Linearization failed...").
    return lax.reduce_window(
        x, -jnp.inf, lax.max, tuple(window), tuple(strides), tuple(padding)
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _max_pool_maskvjp(x, kernel, stride, layout):
    return _max_pool_fwd_only(x, kernel, stride, layout)


def _max_pool_maskvjp_fwd(x, kernel, stride, layout):
    y = _max_pool_fwd_only(x, kernel, stride, layout)
    return y, (x, y)


def _max_pool_maskvjp_bwd(kernel, stride, layout, res, dy):
    x, y = res
    return (_mask_maxpool_grad(x, y, dy, kernel=kernel, stride=stride, layout=layout),)


_max_pool_maskvjp.defvjp(_max_pool_maskvjp_fwd, _max_pool_maskvjp_bwd)


def _mask_maxpool_grad(x, y, dy, *, kernel, stride, layout):
    """Reconstruct maxPoolDeriv's scatter (resnet.cu:476-497) from (x, y, dy)."""
    hdim, wdim = spatial_dims(layout)
    oh, ow = y.shape[hdim], y.shape[wdim]
    pad_h = reference_padding(x.shape[hdim], kernel, stride)
    pad_w = reference_padding(x.shape[wdim], kernel, stride)
    pad_cfg = [(0, 0, 0)] * 4
    pad_cfg[hdim] = (pad_h[0], pad_h[1], 0)
    pad_cfg[wdim] = (pad_w[0], pad_w[1], 0)
    # -inf padding: OOB window cells can never equal the max, matching the
    # reference's OOB-skip (resnet.cu:458-460).
    xp = lax.pad(x, jnp.array(-jnp.inf, x.dtype), pad_cfg)
    acc = jnp.zeros(xp.shape, dtype=dy.dtype)
    matched = jnp.zeros(y.shape, dtype=bool)
    span_h = (oh - 1) * stride + 1
    span_w = (ow - 1) * stride + 1
    zero = jnp.zeros((), dy.dtype)
    for kh in range(kernel):
        for kw in range(kernel):
            starts = [0] * 4
            limits = list(xp.shape)
            strides_ = [1] * 4
            starts[hdim], limits[hdim], strides_[hdim] = kh, kh + span_h, stride
            starts[wdim], limits[wdim], strides_[wdim] = kw, kw + span_w, stride
            x_k = lax.slice(xp, starts, limits, strides_)
            eq = x_k == y
            take = eq & ~matched
            matched = matched | eq
            contrib = jnp.where(take, dy, zero)
            scat = [(0, 0, 0)] * 4
            scat[hdim] = (kh, xp.shape[hdim] - kh - span_h, stride - 1)
            scat[wdim] = (kw, xp.shape[wdim] - kw - span_w, stride - 1)
            acc = acc + lax.pad(contrib, zero, scat)
    starts = [0] * 4
    limits = list(xp.shape)
    starts[hdim], limits[hdim] = pad_h[0], pad_h[0] + x.shape[hdim]
    starts[wdim], limits[wdim] = pad_w[0], pad_w[0] + x.shape[wdim]
    return lax.slice(acc, starts, limits)


def global_avg_pool(x: jax.Array, *, layout: str = "NHWC") -> jax.Array:
    """(N,H,W,C)->(N,C): mean over space (doFilterAvgPool, resnet.cu:500)."""
    hdim, wdim = spatial_dims(layout)
    return jnp.mean(x, axis=(hdim, wdim))
