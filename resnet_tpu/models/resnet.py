"""Functional ResNet forward pass (bottleneck and basic blocks).

Reproduces the reference network exactly in its default config
(forward_pass, resnet.cu:1526-1775):

  stem 7x7/s2 conv -> BN+ReLU -> 3x3/s2 maxpool
  -> 16 bottleneck blocks [1x1 reduce -> BN+ReLU -> 3x3 (stride here)
     -> BN+ReLU -> 1x1 expand -> BN -> (+ projected residual) -> ReLU]
  -> global 7x7 avg pool -> FC 2048x1000 (no bias)

Projection shortcuts sit on the first block of each stage; at stage
transitions the projection is a 3x3/s2 conv (reference quirk,
resnet.cu:770-797). Returned logits are fp32; softmax is applied by the
caller (loss or prediction path).

Unlike the reference's six memory variants, caching-vs-recompute is a
config axis: ecfg.remat='block' wraps each residual block in
jax.checkpoint, the counterpart of resnet_clean.cu's recompute-in-backward
strategy (resnet_clean.cu:2459-2958).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ExecutionConfig, ModelConfig
from ..ops import (
    bn_act,
    conv2d,
    global_avg_pool,
    linear,
    max_pool,
    residual_join,
    softmax,
)


def _save_convs_policy(prim, *_, **__):
    """jax.checkpoint policy: conv/matmul outputs are saveable, everything
    elementwise is recomputed in backward."""
    return prim.name in ("conv_general_dilated", "dot_general")


# save convs AND the named BN statistics — without the stats, the policy
# forces the full-tensor moment reductions to re-run in backward (measured
# 2x slower than no remat at all)
_SAVE_CONVS = jax.checkpoint_policies.save_from_both_policies(
    _save_convs_policy,
    jax.checkpoint_policies.save_only_these_names("bn_stats"),
)


def _conv(x, w, *, stride, ecfg, groups=1):
    return conv2d(
        x, w, stride=stride, layout=ecfg.layout,
        precision=ecfg.matmul_precision, groups=groups,
    )


def _bn_apply(x, bn_params, *, eps, layout, state=None, train=True,
              relu_fused=False, relu_cap=None, mode="batch", stats_batch=0):
    """BN in train (batch stats) or eval (running stats) mode, with the
    following ReLU fused in when relu_fused=True (doBatchNormAndActivate,
    resnet.cu:289). Returns (y, (mean, var)).

    mode='frozen' normalizes with running stats even in train mode
    (frozen-BN fine-tuning); mode='off' skips normalization (diagnostic).
    stats_batch>0 = ghost BN: statistics over the first stats_batch images
    only (ExecutionConfig.bn_stats_batch); still fully differentiable —
    the moments VJP correction just flows to the stats sample alone.
    """
    if mode == "off":
        y = x
        if relu_fused:
            y = jnp.maximum(y, jnp.zeros((), y.dtype))
            if relu_cap is not None:
                y = jnp.minimum(y, jnp.asarray(relu_cap, y.dtype))
        c = x.shape[-1] if layout == "NHWC" else x.shape[1]
        zero = jnp.zeros((c,), jnp.float32)
        return y, (zero, zero + 1.0)
    mean = var = None
    if not train or mode == "frozen":
        if state is None:
            raise ValueError(
                "eval-mode/frozen BN requires running statistics"
            )
        mean, var = state["mean"], state["var"]
    elif stats_batch and stats_batch < x.shape[0]:
        # ghost BN rides its own closed-form VJP (autodiff of the sliced
        # moments materializes a full-size zero-pad per layer in backward)
        from ..ops.batchnorm import batch_norm_ghost

        y, stats = batch_norm_ghost(
            x, bn_params["gamma"], bn_params["beta"], stats_batch,
            eps=eps, layout=layout,
        )
        if relu_fused:
            y = jnp.maximum(y, jnp.zeros((), y.dtype))
            if relu_cap is not None:
                y = jnp.minimum(y, jnp.asarray(relu_cap, y.dtype))
        return y, stats
    return bn_act(
        x, bn_params["gamma"], bn_params["beta"], eps=eps, layout=layout,
        relu=relu_fused, relu_cap=relu_cap, mean=mean, var=var,
    )


def _bottleneck_block(
    block_params, x, *, stride, mcfg, ecfg, state=None, train=True, tape=None
):
    layout = ecfg.layout
    eps = mcfg.bn_eps
    stats: Dict[str, Any] = {}

    out = _conv(x, block_params["reduce"]["w"], stride=1, ecfg=ecfg)
    if tape is not None:
        tape["post_reduced"] = out
    out, stats["bn_reduce"] = _bn_apply(
        out, block_params["bn_reduce"], eps=eps, layout=layout,
        state=None if state is None else state["bn_reduce"], train=train,
        relu_fused=True, relu_cap=ecfg.relu_cap, mode=ecfg.bn_mode,
        stats_batch=ecfg.bn_stats_batch,
    )

    out = _conv(
        out, block_params["spatial"]["w"], stride=stride, ecfg=ecfg,
        groups=mcfg.groups,
    )
    if tape is not None:
        tape["post_spatial"] = out
    out, stats["bn_spatial"] = _bn_apply(
        out, block_params["bn_spatial"], eps=eps, layout=layout,
        state=None if state is None else state["bn_spatial"], train=train,
        relu_fused=True, relu_cap=ecfg.relu_cap, mode=ecfg.bn_mode,
        stats_batch=ecfg.bn_stats_batch,
    )

    out = _conv(out, block_params["expand"]["w"], stride=1, ecfg=ecfg)
    if tape is not None:
        tape["post_expanded"] = out
    out, stats["bn_expand"] = _bn_apply(
        out, block_params["bn_expand"], eps=eps, layout=layout,
        state=None if state is None else state["bn_expand"], train=train,
        mode=ecfg.bn_mode, stats_batch=ecfg.bn_stats_batch,
    )

    if "proj" in block_params:
        residual = _conv(x, block_params["proj"]["w"], stride=stride, ecfg=ecfg)
        residual, stats["bn_proj"] = _bn_apply(
            residual, block_params["bn_proj"], eps=eps, layout=layout,
            state=None if state is None else state["bn_proj"], train=train,
            mode=ecfg.bn_mode, stats_batch=ecfg.bn_stats_batch,
        )
        if tape is not None:
            tape["transformed_residual"] = residual
    else:
        residual = x

    out = residual_join(out, residual, relu_cap=ecfg.relu_cap)
    if tape is not None:
        tape["output_activated"] = out
    return out, stats


def _basic_block(
    block_params, x, *, stride, mcfg, ecfg, state=None, train=True, tape=None
):
    layout = ecfg.layout
    eps = mcfg.bn_eps
    stats: Dict[str, Any] = {}

    out = _conv(x, block_params["conv1"]["w"], stride=stride, ecfg=ecfg)
    out, stats["bn1"] = _bn_apply(
        out, block_params["bn1"], eps=eps, layout=layout,
        state=None if state is None else state["bn1"], train=train,
        relu_fused=True, relu_cap=ecfg.relu_cap, mode=ecfg.bn_mode,
        stats_batch=ecfg.bn_stats_batch,
    )
    out = _conv(out, block_params["conv2"]["w"], stride=1, ecfg=ecfg)
    out, stats["bn2"] = _bn_apply(
        out, block_params["bn2"], eps=eps, layout=layout,
        state=None if state is None else state["bn2"], train=train,
        mode=ecfg.bn_mode, stats_batch=ecfg.bn_stats_batch,
    )

    if "proj" in block_params:
        residual = _conv(x, block_params["proj"]["w"], stride=stride, ecfg=ecfg)
        residual, stats["bn_proj"] = _bn_apply(
            residual, block_params["bn_proj"], eps=eps, layout=layout,
            state=None if state is None else state["bn_proj"], train=train,
            mode=ecfg.bn_mode, stats_batch=ecfg.bn_stats_batch,
        )
    else:
        residual = x

    out = residual_join(out, residual, relu_cap=ecfg.relu_cap)
    return out, stats


def forward(
    params,
    x: jax.Array,
    mcfg: ModelConfig,
    ecfg: Optional[ExecutionConfig] = None,
    *,
    train: bool = True,
    bn_state=None,
    capture: bool = False,
) -> Tuple[jax.Array, Dict[str, Any]]:
    """Run the network. Returns (fp32 logits, aux).

    aux["bn_stats"]: pytree of per-layer batch (mean, var) — the
    counterpart of the reference's Cache_BatchNorm buffers (resnet.h:90-97).
    aux["activations"]: intermediate tensors when capture=True, keyed after
    the reference's Activations struct fields (resnet.h:99-152) for the
    dump/fidelity harness.
    """
    ecfg = ecfg or ExecutionConfig()
    layout = ecfg.layout
    eps = mcfg.bn_eps
    prec = ecfg.matmul_precision
    block_fn = _bottleneck_block if mcfg.bottleneck else _basic_block

    x = x.astype(ecfg.cdtype)
    tape: Optional[Dict[str, Any]] = {} if capture else None
    stats: Dict[str, Any] = {}

    use_s2d = (
        ecfg.space_to_depth
        and layout == "NHWC"
        and mcfg.init_kernel == 7
        and mcfg.init_stride == 2
        and x.shape[1] % 2 == 0
        and x.shape[2] % 2 == 0
    )
    if use_s2d:
        from ..ops.conv import _PRECISION
        from ..ops.space_to_depth import s2d_stem_conv

        out = s2d_stem_conv(
            x, params["init_conv"]["w"], precision=_PRECISION[prec]
        )
    else:
        out = _conv(x, params["init_conv"]["w"], stride=mcfg.init_stride, ecfg=ecfg)
    if tape is not None:
        tape["init_conv_applied"] = out
    out, stats["init_bn"] = _bn_apply(
        out, params["init_bn"], eps=eps, layout=layout,
        state=None if bn_state is None else bn_state["init_bn"], train=train,
        relu_fused=True, relu_cap=ecfg.relu_cap, mode=ecfg.bn_mode,
        stats_batch=ecfg.bn_stats_batch,
    )
    if tape is not None:
        tape["init_conv_activated"] = out
    out = max_pool(out, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride,
                   layout=layout, vjp=ecfg.maxpool_vjp)
    if tape is not None:
        tape["init_convblock_input"] = out

    remat_on = train and not capture
    block_tapes: list = [({} if capture else None) for _ in range(mcfg.num_blocks)]

    def run_block_range(h, start, count):
        """Run blocks [start, start+count); returns (h, their stats).

        Stats are RETURNED (not accumulated by side effect) so the range
        can be wrapped in jax.checkpoint without leaking tracers."""
        stats_acc = []
        for i in range(start, start + count):
            stride = 2 if mcfg.is_reduction_block(i) else 1

            def run_block(bp, hh, _stride=stride, _tape=block_tapes[i], _state=(
                None if bn_state is None else bn_state["blocks"][i]
            )):
                return block_fn(
                    bp, hh, stride=_stride, mcfg=mcfg, ecfg=ecfg,
                    state=_state, train=train, tape=_tape,
                )

            if ecfg.remat == "block" and remat_on:
                run_block = jax.checkpoint(run_block)
            elif ecfg.remat == "elementwise" and remat_on:
                # save conv outputs, recompute elementwise (BN apply, ReLU,
                # joins) in backward — trades cheap elementwise recompute
                # for fewer saved activations (resnet_clean.cu's strategy)
                run_block = jax.checkpoint(run_block, policy=_SAVE_CONVS)
            h, bstats = run_block(params["blocks"][i], h)
            stats_acc.append(bstats)
        return h, stats_acc

    block_stats: list = []
    if ecfg.remat == "stage" and remat_on:
        # checkpoint whole stages (most aggressive recompute — beyond the
        # reference's lowmem rotating-scratch strategy)
        start = 0
        for n_in_stage in mcfg.block_sizes:
            def run_stage(h, _s=start, _n=n_in_stage):
                return run_block_range(h, _s, _n)

            out, stage_stats = jax.checkpoint(run_stage)(out)
            block_stats.extend(stage_stats)
            start += n_in_stage
    else:
        out, block_stats = run_block_range(out, 0, mcfg.num_blocks)

    if tape is not None:
        for i, bt in enumerate(block_tapes):
            tape[f"block_{i:02d}"] = bt
    stats["blocks"] = block_stats

    pooled = global_avg_pool(out, layout=layout)
    if tape is not None:
        tape["final_avg_pool"] = pooled
    logits = linear(
        pooled, params["fc"]["w"], params["fc"].get("b"), precision=prec,
    ).astype(jnp.float32)
    if tape is not None:
        tape["linear_output"] = logits
        tape["pred"] = softmax(logits, stable=ecfg.stable_softmax)

    aux: Dict[str, Any] = {"bn_stats": stats}
    if capture:
        aux["activations"] = tape
    return logits, aux


def predict(params, x, mcfg, ecfg=None, *, bn_state=None, stable_softmax=True):
    """Inference probabilities using running BN statistics."""
    logits, _ = forward(
        params, x, mcfg, ecfg, train=False, bn_state=bn_state
    )
    return softmax(logits, stable=stable_softmax)
