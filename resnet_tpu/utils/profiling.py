"""Profiling: trace hooks + a per-op slope timer.

The reference's only profiling is the cudnnFind* autotuner and a
commented-out per-algo log (resnet_cudnn_fast.cu:1285-1299); its measured
allocation-cost model (1 MiB cudaMalloc ~ 1/34 ms,
resnet_cudnn_fast.cu:1290-1297) is the "measure, don't guess" ethos this
module keeps. ``trace_context`` records a ``jax.profiler`` trace;
``time_fn`` dispatches a jitted op N times, waits with
``block_until_ready``, and takes the SLOPE between two run lengths, so the
constant dispatch and sync overhead cancels.

CLI: ``python -m resnet_tpu.utils.profiling --out table.json`` emits a JSON
timing table for every ResNet-50 op class on the current device (fwd and
fwd+bwd), with effective TFLOP/s / GB/s where meaningful.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None, *, hlo_dump: Optional[str] = None):
    """Profile the enclosed steps. trace_dir enables jax.profiler; hlo_dump
    sets XLA_FLAGS dump (must be set before first compile to take effect)."""
    if hlo_dump:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={hlo_dump}"
        ).strip()
    if trace_dir:
        jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        if trace_dir:
            jax.profiler.stop_trace()


def time_fn(
    fn: Callable,
    args: Tuple,
    *,
    iters: int = 24,
    warmup: int = 2,
    feedback: Optional[Callable] = None,
    repeats: int = 3,
) -> float:
    """Slope-time a callable: seconds per call on the default device.

    Dispatches ``fn(*args)`` n times for two different n and returns the
    slope, cancelling constant dispatch/sync overhead. Iteration counts
    auto-scale so the slope window is >= ~80ms (sub-ms ops drown in host
    timer jitter otherwise); the median of ``repeats`` slopes is returned.
    ``feedback(out, args) -> args`` chains iterations through a data
    dependency when independent dispatches would pipeline."""
    jfn = jax.jit(fn)

    def run(n):
        a = args
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = jfn(*a)
            if feedback is not None:
                a = feedback(out, a)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    run(warmup)  # compile + warm caches
    rough = run(6) / 6
    # widen the slope window for fast ops: (n_big - n_small) * percall >= 80ms
    iters = max(iters, min(512, int(0.08 / max(rough, 1e-5))))
    n_small = max(2, iters // 4)
    slopes = []
    for _ in range(max(1, repeats)):
        t_small = run(n_small)
        t_big = run(iters)
        slopes.append((t_big - t_small) / (iters - n_small))
    slopes.sort()
    return slopes[len(slopes) // 2]


def time_grad_fn(fn: Callable, args: Tuple, **kw) -> float:
    """Slope-time forward+backward of fn w.r.t. args[0].

    The loss is sum(y * r) with a fixed random cotangent r — a plain
    sum(y) hands the backward an all-ones cotangent that XLA constant-
    folds (e.g. conv backward-data of ones collapses to a reduction),
    faking a backward far cheaper than training's."""
    import numpy as np

    out = jax.eval_shape(fn, *args)
    # r rides as an ARGUMENT: closing over it would bake a multi-MB
    # literal into the HLO
    r = jax.device_put(
        np.random.default_rng(7).normal(0, 1, out.shape).astype(np.float32)
    )

    def fwd_bwd(*a):
        rr = a[-1]

        def loss(x):
            return jnp.sum(fn(x, *a[1:-1]).astype(jnp.float32) * rr)

        return jax.value_and_grad(loss)(a[0])

    return time_fn(fwd_bwd, tuple(args) + (r,), **kw)


# --------------------------------------------------------------------------
# Per-op timing table for ResNet-50 (the six op classes of SURVEY.md 2.1)
# --------------------------------------------------------------------------


def _resnet50_op_specs(batch: int, dtype) -> Dict[str, Dict[str, Any]]:
    """Representative ResNet-50 shapes per op class (NHWC). flops counts
    fwd only (bwd ~ 2x conv/matmul); bytes counts fwd read+write."""
    import numpy as np

    r = np.random.default_rng(0)

    def t(*shape):
        return jnp.asarray(r.normal(0, 1, shape), dtype)

    b = batch
    el = jnp.dtype(dtype).itemsize

    def conv_spec(xs, ws, stride):
        h = xs[1] // stride
        flops = 2 * b * h * h * ws[0] * ws[1] * ws[2] * ws[3]
        return {
            "kind": "conv", "x": t(*xs), "w": t(*ws), "stride": stride,
            "flops": flops,
        }

    def bn_spec(xs):
        n = b * xs[1] * xs[2] * xs[3]
        return {"kind": "bn", "x": t(*xs),
                "gamma": t(xs[3]).astype(jnp.float32),
                "beta": t(xs[3]).astype(jnp.float32),
                "bytes": 2 * n * el}

    return {
        "conv_stem_7x7s2": conv_spec((b, 224, 224, 3), (7, 7, 3, 64), 2),
        "conv_s1_1x1_reduce": conv_spec((b, 56, 56, 256), (1, 1, 256, 64), 1),
        "conv_s1_3x3": conv_spec((b, 56, 56, 64), (3, 3, 64, 64), 1),
        "conv_s1_1x1_expand": conv_spec((b, 56, 56, 64), (1, 1, 64, 256), 1),
        "conv_s2_3x3s2": conv_spec((b, 56, 56, 128), (3, 3, 128, 128), 2),
        "conv_s3_3x3": conv_spec((b, 14, 14, 256), (3, 3, 256, 256), 1),
        "conv_s4_3x3": conv_spec((b, 7, 7, 512), (3, 3, 512, 512), 1),
        # both projection-shortcut forms: the reference's 3x3/s2 quirk
        # (resnet.cu:770-797) and the standard torchvision 1x1/s2
        "conv_proj_3x3s2": conv_spec((b, 56, 56, 256), (3, 3, 256, 512), 2),
        "conv_proj_1x1s2": conv_spec((b, 56, 56, 256), (1, 1, 256, 512), 2),
        "bn_relu_56x256": bn_spec((b, 56, 56, 256)),
        "bn_relu_14x1024": bn_spec((b, 14, 14, 1024)),
        "bn_relu_7x2048": bn_spec((b, 7, 7, 2048)),
        "join_56x256": {
            "kind": "join", "a": t(b, 56, 56, 256), "b": t(b, 56, 56, 256),
            "bytes": 3 * b * 56 * 56 * 256 * el,
        },
        "maxpool_112x64": {"kind": "maxpool", "x": t(b, 112, 112, 64),
                           "bytes": int(1.25 * b * 112 * 112 * 64 * el)},
        "avgpool_7x2048": {"kind": "avgpool", "x": t(b, 7, 7, 2048),
                           "bytes": b * 7 * 7 * 2048 * el},
        "fc_2048x1000": {"kind": "fc", "x": t(b, 2048), "w": t(2048, 1000),
                         "flops": 2 * b * 2048 * 1000},
        "softmax_ce": {"kind": "softmax_ce", "logits": t(b, 1000)},
        "adam_resnet50": {"kind": "adam"},
    }


def build_op_table(
    *,
    batch: int = 256,
    dtype: str = "bfloat16",
    ops_filter: str = "",
    iters: int = 24,
) -> Dict[str, Dict[str, float]]:
    """Time every op class fwd and (where differentiable) fwd+bwd; returns
    {op: {ms_fwd, ms_fwd_bwd, tflops_fwd?, gbps_fwd?}}."""
    import re

    from ..ops import bn_act, conv2d, cross_entropy, linear, residual_join

    dt = jnp.dtype(dtype)
    specs = _resnet50_op_specs(batch, dt)
    table: Dict[str, Dict[str, float]] = {}
    for name, spec in specs.items():
        if ops_filter and not re.search(ops_filter, name):
            continue
        kind = spec["kind"]
        if kind == "conv":
            fn = lambda x, w, s=spec["stride"]: conv2d(
                x, w, stride=s, precision="default"
            )
            args: Tuple = (spec["x"], spec["w"])
        elif kind == "bn":
            fn = lambda x, g, bb: bn_act(
                x, g, bb, eps=1e-5, layout="NHWC", relu=True
            )[0]
            args = (spec["x"], spec["gamma"], spec["beta"])
        elif kind == "join":
            fn = residual_join
            args = (spec["a"], spec["b"])
        elif kind == "maxpool":
            from ..ops.pooling import max_pool

            fn = lambda x: max_pool(x, kernel=3, stride=2, layout="NHWC")
            args = (spec["x"],)
        elif kind == "avgpool":
            from ..ops.pooling import global_avg_pool

            fn = lambda x: global_avg_pool(x, layout="NHWC")
            args = (spec["x"],)
        elif kind == "fc":
            fn = lambda x, w: linear(x, w, precision="default")
            args = (spec["x"], spec["w"])
        elif kind == "softmax_ce":
            labels = jnp.zeros((batch,), jnp.int32)
            fn = lambda lg: cross_entropy(lg, labels, reduction="sum")
            args = (spec["logits"],)
        elif kind == "adam":
            table[name] = {"ms_fwd_bwd": 1e3 * _time_adam(iters)}
            continue
        row: Dict[str, float] = {"ms_fwd": 1e3 * time_fn(fn, args, iters=iters)}
        row["ms_fwd_bwd"] = 1e3 * time_grad_fn(fn, args, iters=iters)
        if "flops" in spec:
            row["tflops_fwd"] = spec["flops"] / (row["ms_fwd"] * 1e9)
            row["tflops_fwd_bwd"] = 3 * spec["flops"] / (row["ms_fwd_bwd"] * 1e9)
        if "bytes" in spec:
            row["gbps_fwd"] = spec["bytes"] / (row["ms_fwd"] * 1e6)
        table[name] = row
    return table


def _time_adam(iters: int) -> float:
    from ..config import model_config
    from ..models import init_params
    from ..optim import adam_init, adam_update

    params = init_params(jax.random.PRNGKey(0), model_config("resnet50"))
    opt = adam_init(params)
    grads = jax.tree.map(lambda p: 0.001 * jnp.ones_like(p), params)

    def step(g, p, o):
        return adam_update(g, o, p, learning_rate=1e-4)

    return time_fn(step, (grads, params, opt), iters=iters)


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description="per-op slope-timing table")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ops", default="", help="regex filter over op names")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--out", default="", help="also write JSON here")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    table = build_op_table(
        batch=args.batch, dtype=args.dtype, ops_filter=args.ops,
        iters=args.iters,
    )
    meta = {
        "batch": args.batch, "dtype": args.dtype, "platform": dev.platform,
        "device_kind": dev.device_kind, "device_count": len(jax.devices()),
    }
    out = {"meta": meta, "ops": table}
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
