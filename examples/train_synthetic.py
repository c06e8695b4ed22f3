"""Minimal end-to-end example: train ResNet-50 on synthetic data.

Runs on whatever JAX sees (a GPU, or the CPU); on CPU use --model tiny.

  python examples/train_synthetic.py --steps 20
  python examples/train_synthetic.py --model tiny --steps 50   # CPU-friendly
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from resnet_tpu.config import (
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    TrainConfig,
    model_config,
    tiny_model_config,
)
from resnet_tpu.train import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=0)
    args = ap.parse_args()

    tiny = args.model == "tiny"
    cfg = TrainConfig(
        model=tiny_model_config() if tiny else model_config(args.model),
        execution=ExecutionConfig(
            compute_dtype="float32" if tiny else "bfloat16",
            matmul_precision="highest" if tiny else "default",
        ),
        optimizer=OptimizerConfig(learning_rate=1e-3),
        data=DataConfig(
            batch_size=args.batch_size or (8 if tiny else 256), synthetic=True
        ),
        checkpoint_dir="",
        log_every=1,
    )
    trainer = Trainer(cfg, use_mesh=False)
    trainer.run(args.steps)
    trainer.finalize()


if __name__ == "__main__":
    main()
