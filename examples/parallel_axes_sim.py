"""Every parallelism axis on one simulated 8-device mesh (no GPU needed).

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/parallel_axes_sim.py

Runs the SAME tiny train step under four shardings and shows they all
produce identical numerics — the point of the pjit/GSPMD design: the
model code never changes, only the placement annotations do.

  1. data parallel         batch P('data'); gradient all-reduce
  2. data x model (tp)     FC head sharded over 'model' (logit collectives)
  3. data x spatial (sp)   image HEIGHT sharded (conv halo exchanges)
  4. ZeRO state sharding   params/moments sharded across 'data'
                           (all-gathered for compute, stored at 1/N)

On a host with several GPUs the same code runs unchanged over NCCL.
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
import numpy as np

from resnet_tpu.config import (
    DataConfig,
    OptimizerConfig,
    ParallelConfig,
    TrainConfig,
    tiny_model_config,
)
from resnet_tpu.parallel import (
    composite_shardings,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    spatial_shard_batch,
    zero_shardings,
)
from resnet_tpu.train import init_train_state, make_train_step


def main():
    cfg = TrainConfig(
        model=tiny_model_config(),
        optimizer=OptimizerConfig(name="sgd", learning_rate=1e-3),
        data=DataConfig(batch_size=8, synthetic=True),
        parallel=ParallelConfig(),
        checkpoint_dir="",
    )
    rng = np.random.default_rng(0)
    d = cfg.model.input_dim
    batch = {
        "images": rng.normal(0, 50, (8, d, d, 3)).astype(np.float32),
        "labels": rng.integers(0, cfg.model.num_classes, (8,)).astype(np.int32),
    }

    def run(name, mesh, state_sh=None, batch_fn=shard_batch):
        state = init_train_state(cfg)
        placed = (
            jax.device_put(state, state_sh)
            if state_sh is not None
            else replicate(state, mesh)
        )
        b = batch_fn(batch, mesh)
        step = make_train_step(
            cfg, mesh, donate=False, state_shardings=state_sh,
            batch_shardings={k: v.sharding for k, v in b.items()},
        )
        _, m = step(placed, b)
        loss = float(jax.device_get(m["loss"]))
        print(f"{name:<26} loss={loss:.6f}")
        return loss

    losses = [
        run("data parallel (8)", make_mesh(8)),
        run("data(4) x model(2) tp", make_mesh_2d(4, 2),
            state_sh=composite_shardings(
                init_train_state(cfg), make_mesh_2d(4, 2))),
        run("data(4) x spatial(2) sp", make_mesh_2d(4, 2, axes=("data", "spatial")),
            batch_fn=spatial_shard_batch),
        run("ZeRO state sharding", make_mesh(8),
            state_sh=zero_shardings(
                init_train_state(cfg), make_mesh(8), min_bytes=1024)),
    ]
    assert max(losses) - min(losses) < 1e-5, losses
    print("all axes agree: the partitioner's collectives are invisible")


if __name__ == "__main__":
    main()
