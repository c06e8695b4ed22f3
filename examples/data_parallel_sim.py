"""Data-parallel training on a simulated 8-device mesh (no GPU needed).

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/data_parallel_sim.py

On a host with several GPUs the same code runs unchanged — the mesh picks
up the physical cards and the gradient all-reduce rides NCCL.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from resnet_tpu.config import (
    DataConfig,
    OptimizerConfig,
    ParallelConfig,
    TrainConfig,
    tiny_model_config,
)
from resnet_tpu.train import Trainer


def main():
    print(f"devices: {jax.devices()}")
    cfg = TrainConfig(
        model=tiny_model_config(),
        optimizer=OptimizerConfig(learning_rate=1e-3),
        data=DataConfig(batch_size=16, synthetic=True),  # 2 per device
        parallel=ParallelConfig(num_devices=8, mode="auto"),
        checkpoint_dir="",
        log_every=1,
    )
    trainer = Trainer(cfg, use_mesh=True)
    trainer.run(10)
    trainer.finalize()


if __name__ == "__main__":
    main()
