"""Command-line trainer.

The reference has no CLI — all configuration is compile-time constants in
main() (resnet.cu:3245-3296) and the six binaries ARE the config system
(SURVEY.md section 5). Here every axis is a flag.

Usage:
  python -m resnet_tpu.train.cli --synthetic --steps 100
  python -m resnet_tpu.train.cli --shard-dir /data/shards --epochs 40 \
      --batch-size 256 --dtype bfloat16 --optimizer sgd --schedule step
"""

from __future__ import annotations

import argparse
import os

from ..config import (
    RESUME_LATEST,
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    ParallelConfig,
    TrainConfig,
    model_config,
    tiny_model_config,
    variant_config,
)


def build_config(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description="resnet_tpu trainer")
    ap.add_argument("--model", default="resnet50",
                    choices=["resnet18", "resnet34", "resnet50", "resnet101",
                             "resnet152", "wide_resnet50_2", "wide_resnet101_2",
                             "resnext50_32x4d", "resnext101_32x8d", "tiny"])
    ap.add_argument("--variant", default="",
                    choices=["", "resnet", "clean", "cudnn", "lowmem", "nchw", "fast"],
                    help="reproduce one of the reference's six trainer"
                         " variants (overrides layout/dtype/remat/batch/lr)")
    ap.add_argument("--batch-size", type=int, default=32)  # resnet.cu:3279
    ap.add_argument("--epochs", type=int, default=40)  # resnet.cu:3291
    ap.add_argument("--steps", type=int, default=0,
                    help="train this many steps instead of full epochs")
    ap.add_argument("--total-steps", type=int, default=0,
                    help="LR-schedule horizon in GLOBAL steps. Pin this to"
                         " the full planned run when resuming mid-training:"
                         " --steps counts this invocation only, and a"
                         " schedule rebuilt from it would decay on a"
                         " different clock than the run being resumed"
                         " (default: this invocation's --steps, or the"
                         " epoch-derived horizon with --shard-dir)")
    ap.add_argument("--shard-dir", default="")
    ap.add_argument("--num-shards", type=int, default=0,
                    help="0 = count %%03d.images files in --shard-dir"
                         " (reference default 40)")
    ap.add_argument("--shard-images", type=int, default=32768)  # resnet.cu:3277
    ap.add_argument("--jpeg-dir", default="",
                    help="raw ImageFolder tree; online decode/augment path")
    ap.add_argument("--random-flip", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device-batches", type=int, default=0,
                    help="with --synthetic: pre-stage N distinct batches"
                         " on device and cycle them (zero per-step H2D:"
                         " the input pipeline is out of the loop)")
    ap.add_argument("--shard-layout", default="NCHW", choices=["NHWC", "NCHW"])
    ap.add_argument("--layout", default="NHWC", choices=["NHWC", "NCHW"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--remat", default="none", choices=["none", "block", "stage", "elementwise"])
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="split each step's batch into N microbatches"
                         " scanned inside the jitted step (summed grads,"
                         " one optimizer update) — train at batch sizes"
                         " whose activations don't fit; composes with"
                         " --remat (the lowmem memory-strategy axis)")
    ap.add_argument("--transfer-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="host->device image transfer dtype (bfloat16"
                         " halves input traffic)")
    ap.add_argument("--space-to-depth", action="store_true",
                    help="MLPerf s2d stem (7x7s2 -> 4x4s1 on folded input)")
    ap.add_argument("--projections", default="reference",
                    choices=["reference", "standard"],
                    help="projection-shortcut kernel at stage transitions:"
                         " 'reference' = the reference's 3x3/s2 quirk"
                         " (resnet.cu:770-797, ~2.3x the FLOPs of standard"
                         " ResNet-50); 'standard' = torchvision 1x1/s2")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--lr", type=float, default=1e-4)  # resnet.cu:3286
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--wd-mask", default="all", choices=["all", "no_bn"])
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "step"])
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="training_dumps/run")
    ap.add_argument("--checkpoint-every", type=int, default=1000)  # resnet.cu:2947
    # LOAD_FROM_DUMP_ID (resnet.cu:3299); 'latest' = newest complete dump
    ap.add_argument("--resume-from", default="-1",
                    help="dump id to resume from, or 'latest' (-1 = fresh)")
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="write periodic dumps on a background thread"
                         " (snapshot synchronously, overlap the file I/O"
                         " with training)")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--check-errors", action="store_true")
    ap.add_argument("--no-record-metrics", action="store_true",
                    help="skip the per-step metric fetch (each is a host"
                         " sync)")
    ap.add_argument("--seed", type=int, default=1234)  # resnet.cu:3266
    ap.add_argument("--num-devices", type=int, default=0)
    ap.add_argument("--parallel-mode", default="auto", choices=["auto", "shard_map"])
    ap.add_argument("--spatial-devices", type=int, default=1,
                    help=">1 splits the image height over a second mesh"
                         " axis (large-image training; 'auto' mode only)")
    ap.add_argument("--zero-sharding", action="store_true",
                    help="shard params/optimizer state across the data"
                         " axis (ZeRO-style, ~1/N state memory per chip;"
                         " 'auto' mode only)")
    ap.add_argument("--no-mesh", action="store_true",
                    help="force single-device even with multiple chips")
    ap.add_argument("--evaluate", action="store_true",
                    help="run evaluation over the shard dir instead of training"
                         " (requires --resume-from for the checkpoint)")
    ap.add_argument("--export", default="",
                    help="write a serving artifact (StableHLO, weights baked"
                         " in, symbolic batch) of the eval forward to this"
                         " path and exit; combine with --resume-from to"
                         " export a trained checkpoint")
    ap.add_argument("--eval-batches", type=int, default=0,
                    help="0 = one full pass over the shards")
    ap.add_argument("--int8", action="store_true",
                    help="with --evaluate or --export: W8A8 post-training-"
                         "quantized inference (quantize.py; calibrates on"
                         " the first data batch)")
    ap.add_argument("--export-dtype", default="",
                    choices=["", "float32", "bfloat16"],
                    help="with --export: cast baked-in weights (bfloat16"
                         " halves the artifact; logits stay fp32)")
    args = ap.parse_args(argv)

    if args.int8 and args.export_dtype:
        ap.error("--export-dtype applies to the fp export only; the int8"
                 " artifact's weights are already int8 (drop one flag)")

    if args.resume_from == "latest":
        resume_from = RESUME_LATEST
    else:
        try:
            resume_from = int(args.resume_from)
        except ValueError:
            ap.error(f"--resume-from {args.resume_from!r}: expected a dump id or 'latest'")
    args.resume_from = resume_from

    if args.variant:
        cfg = variant_config(
            args.variant,
            model=args.model if args.model != "tiny" else "resnet50",
            seed=args.seed,
            epochs=args.epochs,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            log_every=args.log_every,
            resume_from=args.resume_from,
            check_errors=args.check_errors,
            async_checkpoint=args.async_checkpoint,
        )
        import dataclasses as _dc

        cfg = _dc.replace(
            cfg,
            data=_dc.replace(
                cfg.data,
                shard_dir=args.shard_dir,
                jpeg_dir=args.jpeg_dir,
                synthetic=args.synthetic or not (args.shard_dir or args.jpeg_dir),
            ),
        )
        return cfg, args

    if args.model == "tiny":
        mcfg = tiny_model_config()
    else:
        mcfg = model_config(
            args.model,
            stride_projection_kernel=1 if args.projections == "standard" else 3,
        )

    # LR-schedule horizon from the REAL dataset size: shard count comes
    # from the flag or the actual shard directory, never from defaults
    num_shards = args.num_shards
    if not num_shards and args.shard_dir:
        import glob as _glob

        num_shards = len(_glob.glob(os.path.join(args.shard_dir, "*.images")))
    num_shards = num_shards or DataConfig().num_shards
    total_steps = args.total_steps or args.steps
    if not total_steps and args.shard_dir:
        total_steps = args.epochs * (args.shard_images * num_shards // args.batch_size)

    cfg = TrainConfig(
        model=mcfg,
        execution=ExecutionConfig(
            layout=args.layout,
            compute_dtype=args.dtype,
            matmul_precision="default" if args.dtype == "bfloat16" else "highest",
            remat=args.remat,
            space_to_depth=args.space_to_depth,
            grad_accum=args.grad_accum,
        ),
        optimizer=OptimizerConfig(
            name=args.optimizer,
            learning_rate=args.lr,
            weight_decay=args.weight_decay,
            wd_mask=args.wd_mask,
            label_smoothing=args.label_smoothing,
            schedule=args.schedule,
            warmup_steps=args.warmup_steps,
            total_steps=total_steps,
        ),
        data=DataConfig(
            shard_dir=args.shard_dir,
            jpeg_dir=args.jpeg_dir,
            batch_size=args.batch_size,
            num_shards=num_shards,
            shard_images=args.shard_images,
            layout=args.shard_layout,
            transfer_dtype=args.transfer_dtype,
            device_batches=args.device_batches,
            random_flip=args.random_flip,
            synthetic=args.synthetic or not (args.shard_dir or args.jpeg_dir),
        ),
        parallel=ParallelConfig(
            num_devices=args.num_devices, mode=args.parallel_mode,
            spatial_devices=args.spatial_devices,
            zero_sharding=args.zero_sharding
        ),
        seed=args.seed,
        epochs=args.epochs,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        log_every=args.log_every,
        resume_from=args.resume_from,
        record_metrics=not args.no_record_metrics,
        check_errors=args.check_errors,
        async_checkpoint=args.async_checkpoint,
    )
    return cfg, args


def main(argv=None):
    cfg, args = build_config(argv)
    from .trainer import Trainer

    trainer = Trainer(cfg, use_mesh=False if args.no_mesh else None)
    if args.export:
        from ..export import (
            export_inference_from_state,
            export_quantized_inference,
            save_inference,
        )

        if args.int8:
            calib = next(iter(trainer._build_data()))["images"]
            exported = export_quantized_inference(
                trainer.state.params, cfg.model, calib,
                bn_state=trainer.state.bn_state,
                relu_cap=cfg.execution.relu_cap,
            )
        else:
            kw = (
                {"weights_dtype": args.export_dtype}
                if args.export_dtype else {}
            )
            exported = export_inference_from_state(trainer.state, cfg, **kw)
        path = save_inference(args.export, exported)
        tag = "int8 " if args.int8 else ""
        print(f"exported {tag}serving artifact: {path}"
              f" ({os.path.getsize(path)} bytes)")
    elif args.evaluate:
        data = trainer._build_data()
        n = args.eval_batches or getattr(
            data, "batches_per_epoch", 10
        )
        if args.int8:
            metrics = trainer.evaluate_quantized(data, n)
        else:
            metrics = trainer.evaluate(data, n)
        tag = "int8 eval" if args.int8 else "eval"
        print(
            f"{tag} over {n} batches: loss={metrics['loss']:.5f} "
            f"top1={metrics['accuracy']:.4f} top5={metrics.get('top5', 0):.4f}"
        )
    elif args.steps:
        trainer.run(args.steps)
        trainer.finalize()
    else:
        trainer.run_epochs(cfg.epochs)


if __name__ == "__main__":
    main()
