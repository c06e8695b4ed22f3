"""Post-training int8 quantization for the inference path (W8A8).

The reference has no inference path at all (its six binaries train only,
resnet.cu:3222-3429; prediction exists solely as the train-step softmax
copied to host, resnet.cu:1774), let alone a quantized one. int8 tensor
cores run at twice the bf16 rate on Hopper (NVIDIA's data sheet), and int8
activations halve the bytes moved. The recipe is the standard production
PTQ stack:

1. ``fold_bn_inference``: eval-mode BN is a per-channel affine with fixed
   running statistics, so it folds into the preceding conv exactly
   (w' = w * gamma/sqrt(var+eps), b' = beta - mean*gamma/sqrt(var+eps));
   the folded fp model is bit-for-bit the eval forward up to reassociation.
2. ``calibrate``: run representative batches through the folded model and
   record per-site absolute maxima -> per-tensor symmetric activation
   scales.
3. ``quantize_weights``: per-output-channel symmetric int8 weights.
4. ``quantized_forward``: int8 conv/matmul (int32 accumulation) at every
   conv site, dequant+bias+ReLU epilogues in bf16, residual joins in bf16.

Geometry is identical to the training path: reference-centered windows
(ops/padding.py), NHWC, grouped convs supported. Accuracy note: symmetric
per-channel W8 / per-tensor A8 with real calibration data is the
established ~<1% top-1 recipe for ResNet-50; calibrate on real training
batches before deploying.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import ModelConfig
from .ops import global_avg_pool, max_pool
from .ops.padding import reference_padding

_DN = ("NHWC", "HWIO", "NHWC")


# ---------------------------------------------------------------- folding

def _fold(conv_w, bn, state, eps):
    a = bn["gamma"].astype(jnp.float32) / jnp.sqrt(
        state["var"].astype(jnp.float32) + eps
    )
    b = bn["beta"].astype(jnp.float32) - state["mean"].astype(jnp.float32) * a
    return {"w": conv_w.astype(jnp.float32) * a, "b": b}


def fold_bn_inference(params, bn_state, mcfg: ModelConfig):
    """Fold eval-mode BN (running stats) into conv weights/biases.

    Returns the inference param tree: {'init': {w,b}, 'blocks': [...],
    'fc': {w[,b]}} — the fp model ``folded_forward`` runs, and the input
    to weight quantization.
    """
    eps = mcfg.bn_eps
    out: Dict[str, Any] = {
        "init": _fold(params["init_conv"]["w"], params["init_bn"],
                      bn_state["init_bn"], eps),
        "blocks": [],
    }
    names = (
        ("reduce", "spatial", "expand") if mcfg.bottleneck
        else ("conv1", "conv2")
    )
    for bp, bs in zip(params["blocks"], bn_state["blocks"]):
        fb = {
            n: _fold(bp[n]["w"], bp["bn_" + n if mcfg.bottleneck else
                     "bn" + n[-1]], bs["bn_" + n if mcfg.bottleneck else
                     "bn" + n[-1]], eps)
            for n in names
        }
        if "proj" in bp:
            fb["proj"] = _fold(bp["proj"]["w"], bp["bn_proj"],
                               bs["bn_proj"], eps)
        out["blocks"].append(fb)
    fc = {"w": params["fc"]["w"].astype(jnp.float32)}
    if "b" in params["fc"]:
        fc["b"] = params["fc"]["b"].astype(jnp.float32)
    out["fc"] = fc
    return out


# ------------------------------------------------------- fp folded forward

def _relu(x, cap):
    x = jnp.maximum(x, jnp.zeros((), x.dtype))
    if cap is not None:
        x = jnp.minimum(x, jnp.asarray(cap, x.dtype))
    return x


def _conv_fp(x, w, stride, groups=1):
    kh, kw = w.shape[0], w.shape[1]
    pad = (
        reference_padding(x.shape[1], kh, stride),
        reference_padding(x.shape[2], kw, stride),
    )
    return lax.conv_general_dilated(
        x, w.astype(x.dtype), (stride, stride), pad,
        dimension_numbers=lax.conv_dimension_numbers(x.shape, w.shape, _DN),
        feature_group_count=groups,
    )


def _observe(observe, site, x):
    if observe is not None:
        observe[site] = jnp.max(jnp.abs(x.astype(jnp.float32)))


def folded_forward(iparams, x, mcfg: ModelConfig, *, relu_cap=None,
                   observe: Optional[Dict[str, Any]] = None,
                   dtype=jnp.float32):
    """Eval forward over BN-folded params (NHWC). With ``observe`` (a dict),
    records each quantization site's input absmax — the calibration pass.
    Site names match ``quantized_forward``'s scale keys exactly."""
    x = x.astype(dtype)
    _observe(observe, "init", x)
    h = _relu(_conv_fp(x, iparams["init"]["w"], mcfg.init_stride)
              + iparams["init"]["b"].astype(dtype), relu_cap)
    h = max_pool(h, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride)
    for i, fb in enumerate(iparams["blocks"]):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        if mcfg.bottleneck:
            _observe(observe, f"b{i}.reduce", h)
            o = _relu(_conv_fp(h, fb["reduce"]["w"], 1)
                      + fb["reduce"]["b"].astype(dtype), relu_cap)
            _observe(observe, f"b{i}.spatial", o)
            o = _relu(_conv_fp(o, fb["spatial"]["w"], stride, mcfg.groups)
                      + fb["spatial"]["b"].astype(dtype), relu_cap)
            _observe(observe, f"b{i}.expand", o)
            o = _conv_fp(o, fb["expand"]["w"], 1) + fb["expand"]["b"].astype(dtype)
        else:
            _observe(observe, f"b{i}.conv1", h)
            o = _relu(_conv_fp(h, fb["conv1"]["w"], stride)
                      + fb["conv1"]["b"].astype(dtype), relu_cap)
            _observe(observe, f"b{i}.conv2", o)
            o = _conv_fp(o, fb["conv2"]["w"], 1) + fb["conv2"]["b"].astype(dtype)
        if "proj" in fb:
            _observe(observe, f"b{i}.proj", h)
            r = _conv_fp(h, fb["proj"]["w"], stride) + fb["proj"]["b"].astype(dtype)
        else:
            r = h
        h = _relu(o + r, relu_cap)
    pooled = global_avg_pool(h)
    _observe(observe, "fc", pooled)
    logits = jnp.dot(pooled, iparams["fc"]["w"].astype(dtype))
    if "b" in iparams["fc"]:
        logits = logits + iparams["fc"]["b"].astype(dtype)
    return logits.astype(jnp.float32)


# ------------------------------------------------------------ calibration

def calibrate(iparams, images, mcfg: ModelConfig, *, relu_cap=None,
              batch_size: int = 0) -> Dict[str, jax.Array]:
    """Per-tensor symmetric activation scales from representative data:
    scale[site] = absmax(input at site)/127, maximized over batches."""
    n = images.shape[0]
    bs = batch_size or n

    @jax.jit
    def one(ip, batch):  # params as an argument, not a baked-in constant
        obs: Dict[str, Any] = {}
        folded_forward(ip, batch, mcfg, relu_cap=relu_cap, observe=obs)
        return obs

    scales: Dict[str, jax.Array] = {}
    for i in range(0, n, bs):
        obs = one(iparams, images[i:i + bs])
        for k, v in obs.items():
            v = jnp.maximum(v, 1e-8) / 127.0
            scales[k] = v if k not in scales else jnp.maximum(scales[k], v)
    return jax.device_get(scales)


# ------------------------------------------------------- weight quantizing

def _quantize_w(leaf):
    w, b = leaf["w"], leaf["b"] if "b" in leaf else None
    s = jnp.maximum(
        jnp.max(jnp.abs(w.astype(jnp.float32)),
                axis=tuple(range(w.ndim - 1))),
        1e-8,
    ) / 127.0
    wq = jnp.clip(jnp.round(w.astype(jnp.float32) / s), -127, 127).astype(
        jnp.int8
    )
    out = {"wq": wq, "ws": s}
    if b is not None:
        out["b"] = b
    return out


def quantize_weights(iparams, mcfg: ModelConfig):
    """Per-output-channel symmetric int8 weights for every conv + the FC."""
    qp: Dict[str, Any] = {"init": _quantize_w(iparams["init"]), "blocks": []}
    for fb in iparams["blocks"]:
        qp["blocks"].append({k: _quantize_w(v) for k, v in fb.items()})
    qp["fc"] = _quantize_w(iparams["fc"])
    return qp


# ------------------------------------------------------ quantized forward

def _quant_act(x, scale):
    q = jnp.round(x.astype(jnp.float32) * (1.0 / scale))
    return jnp.clip(q, -127, 127).astype(jnp.int8)


def _qconv(xq, wq, stride, groups=1):
    """int8 x int8 conv with int32 accumulation. 1x1 is routed to an int8
    dot with an int32 result (the exact stride-subsample identity for k=1,
    as in ops/conv.py); k>1 comes back as float32.

    The k>1 convs ask for float32 output: XLA hands integer convolutions
    to cuDNN only in its s8-in / f32-out form (an int32 result does not
    lower on the GPU), and cuDNN accumulates that form in int32 before the
    conversion — the same numbers as an int32 conv converted to float32,
    which is what ``_qsite`` does next anyway."""
    kh, kw = wq.shape[0], wq.shape[1]
    if kh == 1 and kw == 1 and groups == 1:
        if stride > 1:
            xq = xq[:, ::stride, ::stride, :]
        n, h, w_, c = xq.shape
        y = lax.dot_general(
            xq.reshape(-1, c), wq.reshape(c, -1),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32,
        )
        return y.reshape(n, h, w_, -1)
    pad = (
        reference_padding(xq.shape[1], kh, stride),
        reference_padding(xq.shape[2], kw, stride),
    )
    return lax.conv_general_dilated(
        xq, wq, (stride, stride), pad,
        dimension_numbers=lax.conv_dimension_numbers(xq.shape, wq.shape, _DN),
        feature_group_count=groups,
        preferred_element_type=jnp.float32,
    )


def _qsite(x, q, scale, stride, groups=1, act_dtype=jnp.bfloat16):
    """quantize -> int8 conv -> dequant + bias, returned in act_dtype."""
    y = _qconv(_quant_act(x, scale), q["wq"], stride, groups)
    deq = y.astype(jnp.float32) * (q["ws"] * scale) + q["b"]
    return deq.astype(act_dtype)


def quantized_forward(qparams, scales, x, mcfg: ModelConfig, *,
                      relu_cap=None, act_dtype=jnp.bfloat16):
    """W8A8 inference: every conv and the FC run int8 with int32
    accumulation; epilogues/joins in act_dtype."""
    h = _relu(_qsite(x, qparams["init"], scales["init"], mcfg.init_stride,
                     act_dtype=act_dtype), relu_cap)
    h = max_pool(h, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride)
    for i, qb in enumerate(qparams["blocks"]):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        if mcfg.bottleneck:
            o = _relu(_qsite(h, qb["reduce"], scales[f"b{i}.reduce"], 1,
                             act_dtype=act_dtype), relu_cap)
            o = _relu(_qsite(o, qb["spatial"], scales[f"b{i}.spatial"],
                             stride, mcfg.groups, act_dtype), relu_cap)
            o = _qsite(o, qb["expand"], scales[f"b{i}.expand"], 1,
                       act_dtype=act_dtype)
        else:
            o = _relu(_qsite(h, qb["conv1"], scales[f"b{i}.conv1"], stride,
                             act_dtype=act_dtype), relu_cap)
            o = _qsite(o, qb["conv2"], scales[f"b{i}.conv2"], 1,
                       act_dtype=act_dtype)
        if "proj" in qb:
            r = _qsite(h, qb["proj"], scales[f"b{i}.proj"], stride,
                       act_dtype=act_dtype)
        else:
            r = h
        h = _relu(o + r, relu_cap)
    pooled = global_avg_pool(h)
    q = qparams["fc"]
    y = lax.dot_general(
        _quant_act(pooled, scales["fc"]), q["wq"],
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32,
    )
    logits = y.astype(jnp.float32) * (q["ws"] * scales["fc"])
    if "b" in q:
        logits = logits + q["b"]
    return logits


# ------------------------------------------------------------- one-shot

def quantize_model(params, bn_state, mcfg: ModelConfig, calib_images, *,
                   relu_cap=None, calib_batch_size: int = 0):
    """fold -> calibrate -> quantize. Returns (qparams, scales); serve with
    ``quantized_forward(qparams, scales, images, mcfg)``."""
    iparams = fold_bn_inference(params, bn_state, mcfg)
    scales = calibrate(iparams, calib_images, mcfg, relu_cap=relu_cap,
                       batch_size=calib_batch_size)
    return quantize_weights(iparams, mcfg), scales
