"""Benchmark: ResNet-50 training throughput (images/sec/device).

Runs the full jitted train step (fwd + CE + bwd + guarded Adam) on a
device-resident synthetic batch in the fast configuration (bf16 compute ~
the reference's TensorCore fast variant, resnet_cudnn_fast.cu +
Makefile:25-28), and prints one self-describing JSON line per topology.
Every line names the platform, device kind and device count it ran on.

Measures a GPU or nothing: with no GPU it exits non-zero. A CPU rehearsal
of the control flow passes ``--cpu-rehearsal`` with a small
``--batch-size`` and ``--image-dim``; it reports no times.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50",
                    help="any config.PRESETS name (resnet18/34/50/"
                         "101/152, wide/resnext variants); headline metric"
                         " is resnet50 — other models print their own"
                         " labeled line")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--image-dim", type=int, default=224)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a non-GPU device to rehearse the control"
                         " flow at small sizes; no times are reported")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=2,
                    help="microbatch count scanned inside the step (the"
                         " lowmem axis: peak activation memory of one"
                         " microbatch)")
    ap.add_argument("--grad-accum-unroll", type=int, default=1,
                    help="unroll factor for the accumulation scan"
                         " (numerics-identical; full unroll removes the"
                         " while-loop carry)")
    ap.add_argument("--projections", default="standard",
                    choices=["standard", "reference"],
                    help="'standard' = torchvision ResNet-50 (1x1/s2"
                         " projection shortcuts, what published img/s"
                         " numbers describe); 'reference' = the reference's"
                         " 3x3/s2 projection quirk (resnet.cu:770-797),"
                         " ~2.3x the projection FLOPs")
    ap.add_argument("--space-to-depth", dest="space_to_depth",
                    action="store_true", default=True,
                    help="MLPerf stem trick: 7x7/s2 on 224x224x3 becomes"
                         " 4x4/s1 on 112x112x12 — same math (exact conv"
                         " equivalence, parity-tested). Default ON.")
    ap.add_argument("--no-space-to-depth", dest="space_to_depth",
                    action="store_false")
    ap.add_argument("--bn-mode", default="batch",
                    choices=["batch", "frozen", "off"],
                    help="'frozen'/'off' are perf-attribution ablations")
    ap.add_argument("--bn-stats-batch", type=int, default=0,
                    help="ghost BN: statistics over the first N images of"
                         " the batch (0 = full batch, reference-exact)."
                         " 64 mirrors per-replica BN at global batch 256"
                         " on four cards (Hoffer et al. 2017)")
    ap.add_argument("--eval", action="store_true",
                    help="benchmark the inference path instead (eval_step:"
                         " forward with running-stats BN + metrics)")
    ap.add_argument("--int8", action="store_true",
                    help="with --eval: W8A8 post-training-quantized"
                         " inference (quantize.py — BN folded, per-channel"
                         " int8 weights, per-tensor int8 activations,"
                         " int32 accumulation)")
    ap.add_argument("--scan", type=int, default=0,
                    help="K>0: run K train steps inside ONE jitted lax.scan"
                         " (device-side loop) — isolates device throughput"
                         " from per-dispatch host latency")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "shards"],
                    help="'shards': feed the step from the on-disk shard"
                         " format through the native loader + prefetch"
                         " ring + H2D — measures the COMPOSED pipeline"
                         " (the overlap the reference conceded,"
                         " resnet.cu:1233) instead of a device-resident"
                         " batch. Reports prefetch-queue occupancy.")
    ap.add_argument("--shard-dir", default="",
                    help="with --data shards: dir of %%03d.images/.labels")
    ap.add_argument("--transfer-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="with --data shards: H2D image dtype (bfloat16"
                         " halves transfer bytes; model casts anyway)")
    ap.add_argument("--no-dual", action="store_true",
                    help="skip the secondary reference-topology line (the"
                         " default run prints BOTH topologies, each line"
                         " self-describing; headline = last line)")
    args = ap.parse_args()
    if args.eval:
        # gradient accumulation is a training axis; normalize so the
        # eval artifact doesn't carry a config field the run ignores
        args.grad_accum = 1
    if args.eval and args.scan:
        ap.error("--eval and --scan are mutually exclusive (the scan loop "
                 "drives the training step)")
    if args.int8 and not args.eval:
        ap.error("--int8 is an inference mode; combine it with --eval "
                 "(int8 training is not a supported axis)")
    if args.data == "shards" and not args.shard_dir:
        ap.error("--data shards needs --shard-dir")

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        raise SystemExit(
            f"bench.py measures a GPU; the first JAX device is "
            f"{dev.platform!r} ({dev.device_kind}). Pass --cpu-rehearsal "
            "with a small --batch-size and --image-dim to rehearse."
        )

    # Dual-topology default: one labeled line for the reference topology
    # (3x3/s2 projections, resnet.cu:770-797, ~2.3x projection FLOPs),
    # then the standard-topology headline LAST. Every line carries
    # topology/batch/dtype/device, so no number changes meaning silently.
    if (
        not args.no_dual
        and not args.eval
        and not args.scan
        and args.data == "synthetic"
        and args.model == "resnet50"
        and args.projections == "standard"
    ):
        # the secondary line runs the plain single-pass step (accum=1)
        import copy

        ref_args = copy.copy(args)
        ref_args.grad_accum = 1
        result = run_bench(ref_args, projections="reference")
        print(json.dumps(result))
    print(json.dumps(run_bench(args, projections=args.projections)))


def run_bench(args, projections: str) -> dict:
    from resnet_tpu.config import (
        DataConfig,
        ExecutionConfig,
        OptimizerConfig,
        TrainConfig,
        model_config,
    )
    from resnet_tpu.train import init_train_state, make_train_step

    devices = jax.devices()
    batch = args.batch_size
    image_dim = args.image_dim

    cfg = TrainConfig(
        model=model_config(
            args.model,
            input_dim=image_dim,
            stride_projection_kernel=3 if projections == "reference" else 1,
        ),
        execution=ExecutionConfig(
            compute_dtype=args.dtype,
            matmul_precision="default",
            remat=args.remat,
            grad_accum=args.grad_accum,
            grad_accum_unroll=args.grad_accum_unroll,
            bn_mode=args.bn_mode,
            bn_stats_batch=args.bn_stats_batch,
            space_to_depth=args.space_to_depth,
        ),
        optimizer=OptimizerConfig(),
        data=DataConfig(batch_size=batch, synthetic=True),
    )

    state = init_train_state(cfg)
    if args.eval and args.int8:
        from resnet_tpu.quantize import quantize_model, quantized_forward

        calib = np.random.default_rng(1).normal(
            0, 50, (min(32, batch), image_dim, image_dim, 3)
        ).astype(np.float32)
        qparams, scales = quantize_model(
            state.params, state.bn_state, cfg.model, jax.device_put(calib)
        )
        qparams = jax.device_put(qparams)
        qfn = jax.jit(
            lambda qp, x: quantized_forward(qp, scales, x, cfg.model)
        )

        def step(s, b):  # same call contract; state passes through
            return s, {"logits": qfn(qparams, b["images"])}

    elif args.eval:
        from resnet_tpu.train import make_eval_step

        eval_step = make_eval_step(cfg)

        def step(s, b):  # same call contract; state passes through
            return s, eval_step(s, b)

    else:
        step = make_train_step(cfg)
    if args.scan:
        import functools

        from jax import lax

        from resnet_tpu.train.step import train_step

        k = args.scan
        fn = functools.partial(train_step, cfg=cfg)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(state, b):  # noqa: F811  (same call contract)
            def body(s, _):
                s2, m = fn(s, b)
                return s2, None

            state2, _ = lax.scan(body, state, None, length=k)
            _, metrics = fn(state2, b)
            return state2, metrics

    occupancy = []
    if args.data == "shards":
        from resnet_tpu.data import ShardDataset
        from resnet_tpu.data.native import NativeShardIterator, native_available
        from resnet_tpu.data.prefetch import prefetch_to_device
        from resnet_tpu.data.shards import ShardIterator

        import os

        shard_files = sorted(
            f for f in os.listdir(args.shard_dir) if f.endswith(".images")
        )
        n_shards = len(shard_files)
        per_shard = os.path.getsize(
            os.path.join(args.shard_dir, shard_files[0])
        ) // (4 * image_dim * image_dim * 3)
        dataset = ShardDataset(
            args.shard_dir, num_shards=n_shards, shard_images=per_shard,
            image_dim=image_dim, channels=3, disk_layout="NCHW",
        )
        host_iter = (
            NativeShardIterator(dataset, batch, layout="NHWC",
                                prefetch_depth=4)
            if native_available()
            else ShardIterator(dataset, batch, layout="NHWC")
        )
        dev_iter = prefetch_to_device(
            host_iter, depth=4,
            transfer_dtype=(args.transfer_dtype
                            if args.transfer_dtype != "float32" else None),
        )

        def next_batch():
            b = next(dev_iter)
            b.pop("cursor", None)
            occupancy.append(dev_iter.qsize())
            return b

        def run_n(state, n):
            t0 = time.perf_counter()
            metrics = None
            for _ in range(n):
                state, metrics = step(state, next_batch())
            jax.block_until_ready((state, metrics))
            return time.perf_counter() - t0, state

    else:
        rng = np.random.default_rng(0)
        images = jax.device_put(
            rng.normal(0, 50, (batch, image_dim, image_dim, 3)).astype(
                np.float32
            )
        )
        labels = jax.device_put(
            rng.integers(0, 1000, (batch,)).astype(np.int32)
        )
        b = {"images": images, "labels": labels}

        def run_n(state, n):
            t0 = time.perf_counter()
            metrics = None
            for _ in range(n):
                state, metrics = step(state, b)
            jax.block_until_ready((state, metrics))
            return time.perf_counter() - t0, state

    _, state = run_n(state, args.warmup)  # compile + warm
    # drop queue-depth samples taken while the first step blocked on XLA
    # compile (the loader fills the ring to max then) — only steady-state
    # occupancy says whether the pipeline is input- or step-bound
    occupancy.clear()
    if args.steps < 2:
        raise SystemExit("--steps must be >= 2 (slope needs two run sizes)")
    n_small = min(max(2, args.steps // 4), args.steps - 1)
    t_small, state = run_n(state, n_small)
    t_big, state = run_n(state, args.steps)
    if args.data == "shards" and hasattr(dev_iter, "stop"):
        dev_iter.stop()
    # slope removes the constant dispatch/sync overhead
    dt_per_step = (t_big - t_small) / (args.steps - n_small)
    if args.scan:
        dt_per_step /= args.scan + 1  # K scanned steps + 1 metrics step
    n_dev = len(devices)
    mode = "eval_int8" if (args.eval and args.int8) else (
        "eval" if args.eval else "train"
    )
    timed = not args.cpu_rehearsal
    return {
        "metric": f"{args.model}_{mode}_images_per_sec_per_device",
        "value": round(batch / dt_per_step / n_dev, 2) if timed else None,
        "unit": "images/sec/device",
        "step_ms": round(dt_per_step * 1000, 2) if timed else None,
        "rehearsal": args.cpu_rehearsal,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": n_dev,
        # self-description: the number's meaning rides in the artifact
        "topology": projections,  # 'standard' 1x1/s2 | 'reference' 3x3/s2
        "batch": batch,
        "image_dim": image_dim,
        "dtype": args.dtype,
        "scan": args.scan,
        "grad_accum": args.grad_accum,
        "grad_accum_unroll": args.grad_accum_unroll,
        "space_to_depth": args.space_to_depth,
        "bn_mode": args.bn_mode,
        "data": args.data,
        # shards mode: composed-pipeline observability. Occupancy is the
        # device-ready queue depth sampled at each consume: pinned at max
        # = loader outruns the step (step-bound); 0 = input-bound.
        "prefetch_occupancy_mean": (
            round(float(np.mean(occupancy)), 2) if occupancy else None
        ),
        "transfer_dtype": args.transfer_dtype if args.data == "shards"
        else None,
    }


if __name__ == "__main__":
    main()
