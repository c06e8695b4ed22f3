"""Input-path benchmark: disk -> host batches -> (optionally) device step.

The reference concedes its input path should have been overlapped
(resnet.cu:1233): at N img/s a device needs 224^2 float32 batches at
N x 602 KB/s from the host. This tool measures what the repo's loaders
actually deliver from disk:

  * native C++ loader (csrc/shard_loader.cc), 1..N workers, with and
    without the NCHW->NHWC repack
  * pure-Python mmap ShardIterator
  * [--jpeg] the multiprocess JPEG decode pipeline on synthesized images
  * [--device] disk -> DevicePrefetcher -> jitted train step end-to-end
    (the host-to-device copy is part of what it measures)

Prints one JSON line per measurement:
  {"metric": "...", "value": imgs_per_sec, "unit": "images/sec", ...}

Usage: python tools/bench_input.py [--dir /tmp/bench_shards] [--batches 64]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ensure_shards(directory: str, num_shards: int, shard_images: int, dim: int):
    from resnet_tpu.data import write_shard

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(0)
    for s in range(num_shards):
        ipath = os.path.join(directory, f"{s:03d}.images")
        if os.path.exists(ipath):
            continue
        imgs = rng.normal(0, 50, (shard_images, 3, dim, dim)).astype(np.float32)
        labels = rng.integers(0, 1000, (shard_images,)).astype(np.int32)
        write_shard(directory, s, imgs, labels)


def drain(it, n_batches: int, batch_size: int, dim: int):
    """Pull n batches, return (img/s, GB/s). First batch excluded (warm-up
    of read-ahead)."""
    next(it)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        next(it)
    dt = time.perf_counter() - t0
    imgs = n_batches * batch_size
    gbs = imgs * dim * dim * 3 * 4 / dt / 1e9
    return imgs / dt, gbs


def emit(metric, value, unit="images/sec", **extra):
    print(json.dumps({"metric": metric, "value": round(value, 1),
                      "unit": unit, **extra}))


def _native_jpeg():
    from resnet_tpu.data.native_jpeg import available

    return available()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/resnet_tpu_bench_shards")
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--shard-images", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=224)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--workers", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--jpeg", action="store_true")
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--clean", action="store_true", help="delete shard dir after")
    args = ap.parse_args()

    from resnet_tpu.data import ShardDataset, ShardIterator
    from resnet_tpu.data.native import NativeShardIterator, native_available

    ensure_shards(args.dir, args.num_shards, args.shard_images, args.dim)
    ds = ShardDataset(args.dir, num_shards=args.num_shards,
                      shard_images=args.shard_images, image_dim=args.dim,
                      disk_layout="NCHW")

    rate, gbs = drain(ShardIterator(ds, args.batch_size, layout="NHWC"),
                      args.batches, args.batch_size, args.dim)
    emit("python_mmap_loader_nhwc", rate, gbps=round(gbs, 2))

    if native_available():
        for w in args.workers:
            rate, gbs = drain(
                NativeShardIterator(ds, args.batch_size, layout="NHWC",
                                    prefetch_depth=8, num_workers=w),
                args.batches, args.batch_size, args.dim,
            )
            emit(f"native_loader_nhwc_repack_w{w}", rate, gbps=round(gbs, 2))
        rate, gbs = drain(
            NativeShardIterator(ds, args.batch_size, layout="NCHW",
                                prefetch_depth=8, num_workers=4),
            args.batches, args.batch_size, args.dim,
        )
        emit("native_loader_nchw_passthrough_w4", rate, gbps=round(gbs, 2))
    else:
        print(json.dumps({"metric": "native_loader", "error": "not built"}))

    if args.jpeg:
        from PIL import Image

        jroot = os.path.join(args.dir, "jpegs")
        if not os.path.isdir(jroot):
            rng = np.random.default_rng(1)
            for c in range(8):
                cdir = os.path.join(jroot, f"class{c:03d}")
                os.makedirs(cdir, exist_ok=True)
                for i in range(64):
                    arr = rng.integers(0, 255, (256, 256, 3), np.uint8)
                    Image.fromarray(arr).save(
                        os.path.join(cdir, f"{i:04d}.jpeg"), quality=90
                    )
        from resnet_tpu.data.jpeg import JpegDataset

        jb = min(args.batch_size, 128)
        dsj = JpegDataset(jroot, jb, out_dim=args.dim, train=True)
        rate, _ = drain(dsj, min(args.batches, 8), jb, args.dim)
        emit("jpeg_decode_pipeline_mp", rate,
             decoder="native" if _native_jpeg() else "pil")
        dsj.close()
        if _native_jpeg():
            # PIL-forced control: the native-vs-PIL A/B in one tool run.
            # finally-guarded so a failed control leg can't leave the
            # PIL flag set and silently relabel later "native" rows.
            os.environ["RESNET_TPU_JPEG_PIL"] = "1"
            try:
                dsp = JpegDataset(jroot, jb, out_dim=args.dim, train=True)
                rate, _ = drain(dsp, min(args.batches, 8), jb, args.dim)
                emit("jpeg_decode_pipeline_mp_pil_control", rate)
                dsp.close()
            finally:
                del os.environ["RESNET_TPU_JPEG_PIL"]
        dst = JpegDataset(jroot, jb, out_dim=args.dim, train=True,
                          use_processes=False)
        rate, _ = drain(dst, min(args.batches, 8), jb, args.dim)
        emit("jpeg_decode_pipeline_threads", rate)
        dst.close()

    if args.device:
        import jax

        from resnet_tpu.config import (
            DataConfig, ExecutionConfig, OptimizerConfig, TrainConfig,
            model_config,
        )
        from resnet_tpu.data import prefetch_to_device
        from resnet_tpu.train import init_train_state, make_train_step

        cfg = TrainConfig(
            model=model_config("resnet50", input_dim=args.dim),
            execution=ExecutionConfig(compute_dtype="bfloat16",
                                      matmul_precision="default"),
            optimizer=OptimizerConfig(),
            data=DataConfig(batch_size=args.batch_size, synthetic=True),
        )
        state = init_train_state(cfg)
        step = make_train_step(cfg)
        it = prefetch_to_device(
            NativeShardIterator(ds, args.batch_size, layout="NHWC",
                                prefetch_depth=8, num_workers=4),
            depth=2, transfer_dtype="bfloat16",
        )
        metrics = None
        for _ in range(3):  # compile + warm
            b = next(it); b.pop("cursor", None)
            state, metrics = step(state, b)
        float(jax.device_get(metrics["loss"]))
        t0 = time.perf_counter()
        n = args.batches
        for _ in range(n):
            b = next(it); b.pop("cursor", None)
            state, metrics = step(state, b)
        float(jax.device_get(metrics["loss"]))
        dt = time.perf_counter() - t0
        emit("disk_fed_train_step", n * args.batch_size / dt,
             device=str(jax.devices()[0]))
        it.stop()

    if args.clean:
        shutil.rmtree(args.dir, ignore_errors=True)


if __name__ == "__main__":
    main()
