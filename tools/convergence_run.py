"""Convergence-at-scale proxy: the FULL 76%-recipe machinery driven for
thousands of real steps on a structured procedural dataset with held-out
eval (round-4 verdict item #7).

The accuracy claims previously rested on composition (recipe doc + tiny
CPU rehearsal + toy convergence tests); this run exercises the recipe the
way step-5k bugs require: SGD+momentum, linear warmup + step decay,
label smoothing, weight-decay mask (no_bn), zero-gamma init, BN running
stats driving the eval path, mid-run checkpoint + resume, and a final
int8 W8A8 PTQ eval of the learned checkpoint calibrated on REAL data
batches (not noise — round-3 verdict weak #5).

Dataset: resnet_tpu/data/procedural.py — 100 parametric texture+shape
classes at 64x64 with instance noise at signal scale; train and eval are
disjoint deterministic instance streams. (SURVEY 7 gives the
composition-to-ImageNet mapping.)

Writes the loss/accuracy curves to --out.

Usage (on the GPU):
  python tools/convergence_run.py --steps 12000
CPU rehearsal:
  JAX_PLATFORMS=cpu python tools/convergence_run.py --steps 60 \
      --batch 16 --eval-every 30 --eval-batches 2 --warmup 10 \
      --resume-at 30 --out /tmp/conv_test.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--warmup", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--eval-batches", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatch accumulation depth — run with 2 to"
                         " validate training quality under the bench"
                         " headline's microbatch dataflow")
    ap.add_argument("--resume-at", type=int, default=0,
                    help="0 = halfway: stop, rebuild the Trainer from"
                         " --resume-from latest, continue")
    ap.add_argument("--dir", default="convergence_dumps")
    ap.add_argument("--out", default="convergence.json")
    args = ap.parse_args()

    import jax

    from resnet_tpu.config import (
        RESUME_LATEST,
        DataConfig,
        ExecutionConfig,
        OptimizerConfig,
        TrainConfig,
        model_config,
    )
    from resnet_tpu.data.procedural import ProceduralDataset, ProceduralIterator
    from resnet_tpu.train import Trainer

    resume_at = args.resume_at or args.steps // 2
    ds = ProceduralDataset(num_classes=args.classes, image_dim=args.dim)

    def make_cfg(resume_from=-1):
        return TrainConfig(
            model=model_config(
                args.model, input_dim=args.dim, num_classes=args.classes,
                stride_projection_kernel=1,
            ),
            execution=ExecutionConfig(
                compute_dtype="bfloat16", matmul_precision="default",
                grad_accum=args.grad_accum,
            ),
            optimizer=OptimizerConfig(
                name="sgd", momentum=0.9,
                learning_rate=args.lr, weight_decay=1e-4, wd_mask="no_bn",
                label_smoothing=0.1,
                schedule="step", warmup_steps=args.warmup,
                total_steps=args.steps,
            ),
            data=DataConfig(batch_size=args.batch, synthetic=True,
                            transfer_dtype="bfloat16"),
            checkpoint_dir=args.dir,
            checkpoint_every=1000,
            async_checkpoint=True,
            log_every=100,
            resume_from=resume_from,
        )

    def train_iter(start_batch=0):
        # start_batch: the stream is positional (index-keyed batches), so
        # a resumed leg continues on FRESH instances after the restored
        # step instead of replaying the stream from position 0
        return ProceduralIterator(ds, args.batch, seed=1,
                                  start_batch=start_batch)

    def eval_iter():
        return ProceduralIterator(ds, args.batch, seed=1, evaluation=True)

    curve = []

    def evaluate(trainer, tag):
        m = trainer.evaluate(eval_iter(), args.eval_batches)
        rec = {
            "step": int(jax.device_get(trainer.state.step)),
            "eval_loss": round(m["loss"], 4),
            "top1": round(m["accuracy"], 4),
            "top5": round(m.get("top5", 0.0), 4),
            "phase": tag,
        }
        curve.append(rec)
        print("eval:", json.dumps(rec), flush=True)
        return rec

    t0 = time.time()
    trainer = Trainer(cfg=make_cfg(), data_source=train_iter(),
                      use_mesh=False)
    done = 0
    while done < resume_at:
        n = min(args.eval_every, resume_at - done)
        trainer.run(n)
        done += n
        evaluate(trainer, "pre-resume")
    trainer.finalize()
    del trainer

    # mid-run resume: a FRESH Trainer restores params/opt-state/step/
    # schedule position from the latest dump and continues — with the
    # data stream fast-forwarded to the restored step (one batch/step)
    resume_stream = train_iter()
    trainer = Trainer(cfg=make_cfg(resume_from=RESUME_LATEST),
                      data_source=resume_stream, use_mesh=False)
    resumed_step = int(jax.device_get(trainer.state.step))
    resume_stream.skip(resumed_step)
    while done < args.steps:
        n = min(args.eval_every, args.steps - done)
        trainer.run(n)
        done += n
        evaluate(trainer, "post-resume")
    final_fp = evaluate(trainer, "final")

    # int8 PTQ of the LEARNED checkpoint, calibrated on REAL train batches
    calib = next(train_iter())["images"][: min(64, args.batch)]
    qm = trainer.evaluate_quantized(
        eval_iter(), args.eval_batches, calib_images=calib
    )
    trainer.finalize()
    wall = time.time() - t0

    out = {
        "config": {
            "model": args.model, "dim": args.dim, "classes": args.classes,
            "batch": args.batch, "dtype": "bfloat16",
            "grad_accum": args.grad_accum,
            "recipe": "sgd momentum=0.9, lr={} linear-warmup {} steps, "
                      "step decay, wd 1e-4 no_bn mask, smoothing 0.1, "
                      "zero-gamma init, flip+translate augmentation, BN "
                      "running stats for eval".format(args.lr, args.warmup),
            "dataset": "procedural 100-class texture+shape, held-out "
                       "instance stream for eval",
            "steps": args.steps,
            "platform": jax.devices()[0].platform,
        },
        "resume": {"at_step": resume_at, "restored_step": resumed_step,
                   "exact": resumed_step == resume_at},
        "curve": curve,
        "final": {
            "fp_top1": final_fp["top1"],
            "fp_top5": final_fp["top5"],
            "int8_top1": round(qm["accuracy"], 4),
            "int8_top5": round(qm.get("top5", 0.0), 4),
            "int8_minus_fp_top1": round(qm["accuracy"] - final_fp["top1"], 4),
        },
        "wall_seconds": round(wall, 1),
    }
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({
        "convergence": "done", "final_top1": out["final"]["fp_top1"],
        "int8_top1": out["final"]["int8_top1"],
        "resume_exact": out["resume"]["exact"], "wall_s": out["wall_seconds"],
    }))


if __name__ == "__main__":
    main()
