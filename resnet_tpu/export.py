"""Serving export: freeze the eval forward into a portable StableHLO artifact.

The reference has no inference or serving path at all — its six binaries
train only (resnet.cu:3222-3429 is a training main; prediction exists only
as the train-step softmax copied to host, resnet.cu:1774). A production
framework needs a deployment artifact, so this module provides one:

- ``export_inference`` closes the eval forward (running-stats BN — batch
  statistics are a training-only semantic, resnet.cu:289) over the trained
  weights, so parameters are baked into the program as constants, and
  exports it via ``jax.export`` with a SYMBOLIC batch dimension: one
  artifact serves any batch size.
- ``save_inference`` / ``load_inference`` write the artifact to disk and
  restore a callable from it. Serving hosts need jax and this file's
  loader — no model code, config system, or checkpoint machinery.

The artifact is StableHLO, so it is compiled (and autotuned) by the
serving host's own XLA for its own backend; export with
``platforms=('cuda', 'cpu')`` for an artifact that runs on both.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import export as jax_export

from .config import ExecutionConfig, ModelConfig
from .models import forward


def export_inference(
    params,
    mcfg: ModelConfig,
    *,
    bn_state=None,
    ecfg: Optional[ExecutionConfig] = None,
    batch: Optional[int] = None,
    dtype=jnp.float32,
    weights_dtype=None,
    platforms: Optional[Sequence[str]] = None,
) -> jax_export.Exported:
    """Freeze (params, bn_state) into an images -> fp32 logits program.

    batch: None exports a symbolic batch dimension (any batch size at
    serving time); an int pins it. platforms: None = the current backend
    only; pass ('cuda', 'cpu') for a portable artifact. weights_dtype:
    cast the baked-in weights (e.g. 'bfloat16' halves the artifact;
    bf16 serving computes in bf16 anyway — logits stay fp32).
    """
    ecfg = ecfg or ExecutionConfig()
    if weights_dtype is not None:
        wd = jnp.dtype(weights_dtype)
        params = jax.tree.map(lambda a: a.astype(wd), params)
        if bn_state is not None:
            bn_state = jax.tree.map(lambda a: a.astype(wd), bn_state)

    def infer(images):
        logits, _ = forward(
            params, images, mcfg, ecfg, train=False, bn_state=bn_state
        )
        return logits

    d = mcfg.input_dim
    dims = (d, d, 3) if ecfg.layout == "NHWC" else (3, d, d)
    if batch is None:
        shape = jax_export.symbolic_shape("b, " + ", ".join(map(str, dims)))
    else:
        shape = (batch, *dims)
    spec = jax.ShapeDtypeStruct(shape, dtype)
    kwargs = {"platforms": list(platforms)} if platforms else {}
    return jax_export.export(jax.jit(infer), **kwargs)(spec)


def export_inference_from_state(state, cfg, **kwargs) -> jax_export.Exported:
    """Convenience: export a TrainState under its TrainConfig."""
    return export_inference(
        state.params,
        cfg.model,
        bn_state=state.bn_state,
        ecfg=cfg.execution,
        **kwargs,
    )


def export_quantized_inference(
    params,
    mcfg: ModelConfig,
    calib_images,
    *,
    bn_state,
    relu_cap=None,
    batch: Optional[int] = None,
    dtype=jnp.float32,
    platforms: Optional[Sequence[str]] = None,
) -> jax_export.Exported:
    """W8A8 serving artifact (quantize.py): BN folded, weights per-channel
    int8, activations per-tensor int8 calibrated on ``calib_images``. Same
    symbolic-batch / serialization contract as ``export_inference``."""
    from .quantize import quantize_model, quantized_forward

    qparams, scales = quantize_model(
        params, bn_state, mcfg, calib_images, relu_cap=relu_cap
    )

    def infer(images):
        return quantized_forward(
            qparams, scales, images, mcfg, relu_cap=relu_cap
        )

    d = mcfg.input_dim
    if batch is None:
        shape = jax_export.symbolic_shape(f"b, {d}, {d}, 3")
    else:
        shape = (batch, d, d, 3)
    spec = jax.ShapeDtypeStruct(shape, dtype)
    kwargs = {"platforms": list(platforms)} if platforms else {}
    return jax_export.export(jax.jit(infer), **kwargs)(spec)


# On-disk artifact: magic line, 8-byte little-endian header length, JSON
# header (signature and calling convention), then the serialized StableHLO
# module. jax.export's own serialize() needs the optional flatbuffers
# package; this format needs jax alone. It carries exactly what the two
# exporters above produce: one image array in, one logits array out, one
# device, no shardings or effects.
_MAGIC = b"resnet-export-v1\n"
_IN_TREE = jax.tree_util.tree_structure(((0,), {}))
_OUT_TREE = jax.tree_util.tree_structure(0)


def _aval_spec(aval):
    return [", ".join(map(str, aval.shape)), str(aval.dtype)]


def serialize_inference(exported: jax_export.Exported) -> bytes:
    """The artifact's bytes, as ``save_inference`` writes them."""
    if (
        exported.in_tree != _IN_TREE or exported.out_tree != _OUT_TREE
        or exported.nr_devices != 1
        or exported.ordered_effects or exported.unordered_effects
        or exported.disabled_safety_checks
        or any(s is not None for s in exported.in_shardings_hlo)
        or any(s is not None for s in exported.out_shardings_hlo)
    ):
        raise ValueError(
            "serialize_inference stores single-device images -> logits "
            "exports without shardings or effects"
        )
    header = json.dumps({
        "fun_name": exported.fun_name,
        "in_avals": [_aval_spec(a) for a in exported.in_avals],
        "out_avals": [_aval_spec(a) for a in exported.out_avals],
        "platforms": list(exported.platforms),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }).encode()
    return b"".join([
        _MAGIC, len(header).to_bytes(8, "little"), header,
        exported.mlir_module_serialized,
    ])


def save_inference(path: str, exported: jax_export.Exported) -> str:
    data = serialize_inference(exported)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_inference(path_or_bytes) -> jax_export.Exported:
    """Restore an exported model; run it with ``.call(images)``."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if not data.startswith(_MAGIC):
        raise ValueError("not a resnet export artifact")
    start = len(_MAGIC) + 8
    n = int.from_bytes(data[len(_MAGIC):start], "little")
    h = json.loads(data[start:start + n])
    scope = jax_export.SymbolicScope()  # 'b' is one symbol in and out

    def avals(specs):
        return tuple(
            jax.core.ShapedArray(
                jax_export.symbolic_shape(shape, scope=scope), jnp.dtype(dt)
            )
            for shape, dt in specs
        )

    return jax_export.Exported(
        fun_name=h["fun_name"],
        in_tree=_IN_TREE,
        in_avals=avals(h["in_avals"]),
        out_tree=_OUT_TREE,
        out_avals=avals(h["out_avals"]),
        _has_named_shardings=True,
        _in_named_shardings=(None,),
        _out_named_shardings=(None,),
        in_shardings_hlo=(None,),
        out_shardings_hlo=(None,),
        nr_devices=1,
        platforms=tuple(h["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=data[start + n:],
        calling_convention_version=h["calling_convention_version"],
        module_kept_var_idx=tuple(h["module_kept_var_idx"]),
        uses_global_constants=h["uses_global_constants"],
        _get_vjp=None,
    )
