"""Batch normalization with the reference's training semantics.

The reference BN (doBatchNormAndActivate, resnet.cu:289-343; cuDNN
SPATIAL_PERSISTENT mode, resnet_cudnn.cu:1655-1695):

  * per-channel statistics over (N, H, W) of the current batch,
  * biased variance (divide by n, not n-1),
  * no running statistics in training (cuDNN call passes NULL,
    resnet_cudnn.cu:1679),
  * forward caches (mean, var) — or (mean, inv_std) in the cuDNN variants —
    for backward; the lean variant recomputes x_hat from them
    (resnet_clean.cu:656).

Here forward/backward come from autodiff of the closed-form expression; the
fused three-kernel backward pipeline of resnet_clean.cu:785-905 maps to XLA
fusion. Statistics are always computed in float32 even under bf16 compute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _reduce_axes(layout: str) -> Tuple[int, ...]:
    return (0, 1, 2) if layout == "NHWC" else (0, 2, 3)


def _param_shape(x_ndim: int, layout: str) -> Tuple[int, ...]:
    # broadcastable shape for per-channel gamma/beta
    if layout == "NHWC":
        return (1,) * (x_ndim - 1) + (-1,)
    return (1, -1) + (1,) * (x_ndim - 2)


import functools as _functools


def _moments_value(x, layout):
    """One-pass (mean, biased var): the two reductions (sum x, sum x^2) are
    sibling jnp.sums, which XLA's multi-output fusion merges into one read
    of the activation. Written as two plain reduces, not one variadic
    lax.reduce, which XLA's reduction emitters handle less well."""
    axes = _reduce_axes(layout)
    acc = jnp.result_type(x.dtype, jnp.float32)
    xf = x.astype(acc)
    s = jnp.sum(xf, axis=axes)
    s2 = jnp.sum(xf * xf, axis=axes)
    n = 1
    for ax in axes:
        n *= x.shape[ax]
    mean = s / n
    var = s2 / n - jnp.square(mean)
    # clamp tiny negative values from the E[x^2]-E[x]^2 form
    var = jnp.maximum(var, 0.0)
    return mean, var


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def batch_moments(x: jax.Array, layout: str = "NHWC") -> Tuple[jax.Array, jax.Array]:
    """Per-channel (mean, biased var) over batch+space, fp32 accumulation.

    Matches getMeansAndVars (resnet_clean.cu:620-654). Closed-form custom
    VJP: the analytic gradient d(mean)/dx = 1/n, d(var)/dx = 2(x - mean)/n
    is one fused elementwise pass, where autodiff of the reductions would
    leave XLA a transpose of a reduce to lower.
    """
    return _moments_value(x, layout)


def _batch_moments_fwd(x, layout):
    mean, var = _moments_value(x, layout)
    return (mean, var), (x, mean)


def _batch_moments_bwd(layout, res, cts):
    x, mean = res
    dmean, dvar = cts
    axes = _reduce_axes(layout)
    n = 1
    for ax in axes:
        n *= x.shape[ax]
    shape = _param_shape(x.ndim, layout)
    xf = x.astype(jnp.float32)
    dx = dmean.reshape(shape) / n + dvar.reshape(shape) * 2.0 * (
        xf - mean.reshape(shape)
    ) / n
    return (dx.astype(x.dtype),)


batch_moments.defvjp(_batch_moments_fwd, _batch_moments_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _bn_ghost(x, gamma, beta, eps: float, layout: str, k: int):
    """Ghost BN (stats over the first k images, normalization over all)
    as ONE differentiable op with a hand-written VJP.

    Autodiff of the sliced-moments formulation makes XLA materialize a
    full-size zero-pad of every activation in backward (the slice's
    transpose). The closed form needs no pad: with full-batch sums dbeta = sum(dy), dgamma =
    sum(dy*x_hat) (required for the parameter grads anyway),

        dx_i = gamma/sigma * (dy_i - [i<k] * (dbeta + x_hat_i*dgamma)/m_k)

    where m_k = k*H*W is the per-channel stats-sample size. The [i<k]
    indicator is an iota mask fused into the dx pass. Setting k = N gives
    exactly the standard full-batch BN backward.
    """
    mean, var = _moments_value(x[:k], layout)
    stat_dtype = jnp.result_type(x.dtype, jnp.float32)
    shape = _param_shape(x.ndim, layout)
    inv_std = jax.lax.rsqrt(var + jnp.asarray(eps, stat_dtype))
    scale = (gamma.astype(stat_dtype) * inv_std).reshape(shape)
    shift = (
        beta.astype(stat_dtype) - gamma.astype(stat_dtype) * mean * inv_std
    ).reshape(shape)
    y = x.astype(stat_dtype) * scale + shift
    return y.astype(x.dtype), (mean, var)


def _bn_ghost_fwd(x, gamma, beta, eps, layout, k):
    x, gamma, beta = x.value, gamma.value, beta.value  # symbolic_zeros wrap
    out = _bn_ghost(x, gamma, beta, eps, layout, k)
    y, (mean, var) = out
    stat_dtype = jnp.result_type(x.dtype, jnp.float32)
    inv_std = jax.lax.rsqrt(var + jnp.asarray(eps, stat_dtype))
    return out, (x, gamma, mean, inv_std)


def _bn_ghost_bwd(eps, layout, k, res, cts):
    from jax.custom_derivatives import SymbolicZero

    x, gamma, mean, inv_std = res
    dy, (dmean_ct, dvar_ct) = cts
    axes = _reduce_axes(layout)
    shape = _param_shape(x.ndim, layout)
    acc = jnp.result_type(x.dtype, jnp.float32)
    # per-channel element count of the stats sample (batch is dim 0)
    m_k = k
    for ax in axes:
        if ax != 0:
            m_k *= x.shape[ax]
    xf = x.astype(acc)
    dyf = (
        jnp.zeros(x.shape, acc)
        if isinstance(dy, SymbolicZero)
        else dy.astype(acc)
    )
    xhat = (xf - mean.reshape(shape)) * inv_std.reshape(shape)
    # full-batch sums (these ARE the parameter gradients)
    dbeta = jnp.sum(dyf, axis=axes)
    dgamma = jnp.sum(dyf * xhat, axis=axes)
    # elementwise dx with the stats-sample mask fused in
    in_sample = (
        jax.lax.broadcasted_iota(jnp.int32, (x.shape[0],) + (1,) * (x.ndim - 1), 0)
        < k
    )
    g_inv = (gamma.astype(acc) * inv_std).reshape(shape)
    corr = (dbeta.reshape(shape) + xhat * dgamma.reshape(shape)) / m_k
    dx = g_inv * (dyf - jnp.where(in_sample, corr, 0.0))
    if not isinstance(dmean_ct, SymbolicZero):
        dx = dx + jnp.where(
            in_sample, dmean_ct.astype(acc).reshape(shape) / m_k, 0.0
        )
    if not isinstance(dvar_ct, SymbolicZero):
        dx = dx + jnp.where(
            in_sample,
            dvar_ct.astype(acc).reshape(shape) * 2.0 * (xf - mean.reshape(shape)) / m_k,
            0.0,
        )
    return (
        dx.astype(x.dtype),
        dgamma.astype(gamma.dtype),
        dbeta.astype(gamma.dtype),
    )


_bn_ghost.defvjp(_bn_ghost_fwd, _bn_ghost_bwd, symbolic_zeros=True)


def batch_norm_ghost(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    stats_batch: int,
    *,
    eps: float = 1e-7,
    layout: str = "NHWC",
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Ghost batch norm (Hoffer et al. 2017): statistics from the first
    ``stats_batch`` images, normalization over the whole batch — the
    per-replica-BN situation of a data-parallel run, as a single-chip
    execution axis (ExecutionConfig.bn_stats_batch)."""
    k = int(stats_batch)
    if k <= 0 or k >= x.shape[0]:
        return batch_norm(x, gamma, beta, eps=eps, layout=layout)
    return _bn_ghost(x, gamma, beta, eps, layout, k)


def batch_norm(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    eps: float = 1e-7,
    layout: str = "NHWC",
    mean: Optional[jax.Array] = None,
    var: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """Training-mode BN. Returns (y, (mean, var)) with stats in fp32.

    If mean/var are given (eval mode / recompute mode) they are used instead
    of batch statistics.
    """
    if mean is None or var is None:
        mean, var = batch_moments(x, layout)
        # name the stats so remat policies can save them: recomputing the
        # full-tensor reductions in backward is the expensive part of
        # rematerializing BN (see remat='elementwise')
        from jax.ad_checkpoint import checkpoint_name

        mean = checkpoint_name(mean, "bn_stats")
        var = checkpoint_name(var, "bn_stats")
    stat_dtype = jnp.result_type(x.dtype, jnp.float32)
    shape = _param_shape(x.ndim, layout)
    inv_std = jax.lax.rsqrt(var + jnp.asarray(eps, stat_dtype))
    scale = (gamma.astype(stat_dtype) * inv_std).reshape(shape)
    shift = (
        beta.astype(stat_dtype) - gamma.astype(stat_dtype) * mean * inv_std
    ).reshape(shape)
    y = x.astype(stat_dtype) * scale + shift
    return y.astype(x.dtype), (mean, var)


def bn_act(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    *,
    eps: float,
    layout: str,
    relu: bool,
    relu_cap: Optional[float] = None,
    mean: Optional[jax.Array] = None,
    var: Optional[jax.Array] = None,
) -> Tuple[jax.Array, Tuple[jax.Array, jax.Array]]:
    """BN followed by the optional (capped) ReLU, doBatchNormAndActivate
    (resnet.cu:289). Returns (y, (mean, var)); explicit mean/var select eval
    mode. XLA fuses the normalisation, the ReLU and the cap into one pass."""
    from .activation import relu as _relu

    y, stats = batch_norm(x, gamma, beta, eps=eps, layout=layout, mean=mean,
                          var=var)
    if relu:
        y = _relu(y)
        if relu_cap is not None:
            y = jnp.minimum(y, jnp.asarray(relu_cap, y.dtype))
    return y, stats


def batch_norm_inference(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    running_mean: jax.Array,
    running_var: jax.Array,
    *,
    eps: float = 1e-7,
    layout: str = "NHWC",
) -> jax.Array:
    y, _ = batch_norm(
        x, gamma, beta, eps=eps, layout=layout, mean=running_mean, var=running_var
    )
    return y


def update_running_stats(
    running_mean: jax.Array,
    running_var: jax.Array,
    mean: jax.Array,
    var: jax.Array,
    momentum: float,
) -> Tuple[jax.Array, jax.Array]:
    """EMA update for inference statistics (new capability; the reference
    tracks none)."""
    m = jnp.float32(momentum)
    return (
        m * running_mean + (1 - m) * mean,
        m * running_var + (1 - m) * var,
    )
