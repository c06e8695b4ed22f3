"""Training loop — the counterpart of main()'s epoch/iter loop
(resnet.cu:3222-3429).

Per iteration the reference does: load_new_batch -> sync -> forward_pass ->
host loss/accuracy -> backwards_pass -> update_parameters(+dump). Here the
whole compute is one jitted step; the input pipeline prefetches batches onto
the device(s) ahead of the step (load_new_batch's sync H2D copy replaced by
DevicePrefetcher); metrics come back asynchronously and are logged one step
behind so the device never waits for the host.

Failure handling mirrors the reference: optional per-step finite scan of all
trainer state (check_errors, resnet.cu:2879-2907); on a non-finite hit, full
state dumps to sentinel id 99999999 and training aborts with a forensic
report. Periodic checkpoints every cfg.checkpoint_every steps
(resnet.cu:2947), final dump at sentinel 77777777 (resnet.cu:3424-3425),
resume from cfg.resume_from (LOAD_FROM_DUMP_ID, resnet.cu:3299-3304).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Iterator, Optional

import jax

from ..config import RESUME_LATEST, TrainConfig
from ..data import (
    ShardCursor,
    ShardDataset,
    ShardIterator,
    SyntheticDataset,
    prefetch_to_device,
)
from ..parallel import make_mesh, make_shard_map_train_step, replicate
from ..utils import MetricsLogger, check_state_finite, nonfinite_report
from .checkpoint import (
    FINAL_DUMP_ID,
    NAN_DUMP_ID,
    AsyncCheckpointer,
    discover_latest_dump,
    restore_checkpoint,
    save_checkpoint,
)
from .state import init_train_state
from .step import make_eval_step, make_train_step


class NonFiniteError(RuntimeError):
    pass


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        *,
        data_source: Optional[Iterator] = None,
        use_mesh: Optional[bool] = None,
    ):
        self.cfg = cfg
        if use_mesh is None:
            use_mesh = len(jax.devices()) > 1 or cfg.parallel.num_devices > 1
        pcfg = cfg.parallel
        self._batch_shardings = None
        if not use_mesh and (pcfg.spatial_devices > 1 or pcfg.zero_sharding):
            # fail loudly: a user validating spatial/ZeRO configs must not
            # get a silently-unsharded run
            raise ValueError(
                "spatial_devices/zero_sharding need a device mesh, but "
                "use_mesh is off (single device or --no-mesh)"
            )
        if pcfg.spatial_devices > 1 and cfg.execution.grad_accum > 1:
            # jax 0.9.0's SPMD partitioner miscompiles the microbatched
            # gradient collectives for spatially-sharded inputs (loss
            # exact, gradients corrupt) — rejected here with the config
            # knobs named; the deep guard lives in make_train_step.
            raise ValueError(
                "spatial_devices > 1 is incompatible with grad_accum > 1 "
                "(XLA SPMD miscompiles the microbatched gradient "
                "collectives under spatial sharding; see "
                "train/step.py:make_train_step). Use grad_accum=1 with "
                "spatial partitioning."
            )
        if use_mesh and pcfg.spatial_devices > 1:
            # (data x spatial) mesh: image H split over the spatial axis
            if pcfg.mode == "shard_map":
                raise ValueError(
                    "spatial_devices > 1 requires parallel.mode='auto' "
                    "(the SPMD partitioner derives the halo exchanges)"
                )
            nd = pcfg.num_devices or len(jax.devices())
            n_data = nd // pcfg.spatial_devices
            if nd % pcfg.spatial_devices:
                raise ValueError(
                    f"{nd} devices not divisible by "
                    f"spatial_devices={pcfg.spatial_devices}"
                )
            # pre-check the shard math here, where the message can name
            # the config knob — a bad device_put inside the prefetcher's
            # worker thread says only 'not divisible'
            if cfg.model.input_dim % pcfg.spatial_devices:
                raise ValueError(
                    f"input_dim {cfg.model.input_dim} not divisible by "
                    f"spatial_devices={pcfg.spatial_devices}"
                )
            global_batch = cfg.data.batch_size * jax.process_count()
            if global_batch % n_data:
                raise ValueError(
                    f"global batch {global_batch} (batch_size "
                    f"{cfg.data.batch_size} x {jax.process_count()} hosts) "
                    f"not divisible by the data-axis size {n_data} "
                    f"({nd} devices / spatial_devices={pcfg.spatial_devices})"
                )
            if jax.process_count() > 1:
                # multi-process: the prefetcher assembles the global batch
                # from per-host slices (make_array_from_process_local_data)
                # — that contract needs every (data-row x spatial) group to
                # live on ONE host, i.e. the inner spatial axis must divide
                # the per-host device count so H-shard halo exchanges ride
                # intra-host links, never the network between hosts
                if jax.local_device_count() % pcfg.spatial_devices:
                    raise ValueError(
                        f"spatial_devices={pcfg.spatial_devices} must divide "
                        f"the per-host device count "
                        f"({jax.local_device_count()}): an H-shard group "
                        "straddling hosts would put conv halos on DCN"
                    )
            from jax.sharding import NamedSharding

            from ..parallel import make_mesh_2d, spatial_batch_specs

            self.mesh = make_mesh_2d(
                n_data, pcfg.spatial_devices,
                axes=(pcfg.data_axis, pcfg.spatial_axis),
            )
            img_spec, lbl_spec = spatial_batch_specs(
                pcfg.data_axis, pcfg.spatial_axis,
                layout=cfg.execution.layout,
            )
            self._batch_shardings = {
                "images": NamedSharding(self.mesh, img_spec),
                "labels": NamedSharding(self.mesh, lbl_spec),
            }
        else:
            self.mesh = (
                make_mesh(pcfg.num_devices, pcfg.data_axis)
                if use_mesh
                else None
            )

        self.state = init_train_state(cfg)
        self.cursor = ShardCursor()
        self.checkpointer = AsyncCheckpointer() if cfg.async_checkpoint else None
        resume_from = cfg.resume_from
        if resume_from == RESUME_LATEST:
            resume_from = discover_latest_dump(cfg.checkpoint_dir)
            if resume_from is None:
                raise FileNotFoundError(
                    f"resume_from=RESUME_LATEST but no complete dump exists "
                    f"under {cfg.checkpoint_dir!r}"
                )
        if resume_from is not None and resume_from >= 0:
            self.state, self.cursor = restore_checkpoint(
                cfg.checkpoint_dir, resume_from, self.state
            )
            print(f"resumed from dump {resume_from} at step {int(self.state.step)}")
        self._state_shardings = None
        if self.mesh is not None and pcfg.zero_sharding:
            if pcfg.mode == "shard_map":
                raise ValueError(
                    "zero_sharding requires parallel.mode='auto' (the SPMD"
                    " partitioner derives the state all-gathers)"
                )
            # multi-process is fully supported: placement goes through
            # put_global (make_array_from_callback for cross-host shards)
            # and checkpoint dumps gather sharded leaves with a real
            # process_allgather (parallel.multihost.fetch_global)
            from ..parallel import zero_shardings
            from ..parallel.multihost import put_global

            self._state_shardings = zero_shardings(
                self.state, self.mesh, axis=pcfg.data_axis,
                min_bytes=pcfg.zero_min_bytes,
            )
            self.state = put_global(self.state, self._state_shardings)
        elif self.mesh is not None:
            self.state = replicate(self.state, self.mesh)

        if self.mesh is not None and cfg.parallel.mode == "shard_map":
            if cfg.execution.grad_accum > 1:
                # the explicit shard_map step is single-pass: it would
                # silently IGNORE the accumulation request (one
                # full-microbatch grad per step), so reject the combo
                # loudly like the other unsupported pairings
                raise ValueError(
                    "parallel.mode='shard_map' does not implement "
                    "grad_accum > 1 (its step computes single-pass "
                    "gradients); use parallel.mode='auto' for the "
                    "microbatch-accumulated step"
                )
            self.train_step = make_shard_map_train_step(cfg, self.mesh)
        else:
            self.train_step = make_train_step(
                cfg, self.mesh, batch_shardings=self._batch_shardings,
                state_shardings=self._state_shardings,
            )
        self.eval_step = make_eval_step(
            cfg, self.mesh, batch_shardings=self._batch_shardings,
            state_shardings=self._state_shardings,
        )

        self._host_iter = data_source or self._build_data()
        self._dev_iter = None  # built lazily, shared across run() calls
        self.logger = MetricsLogger(
            # metrics are global (psum'd in the step): one writer is the
            # whole record — other hosts appending the same lines to a
            # shared checkpoint_dir would interleave/duplicate them
            cfg.checkpoint_dir if jax.process_index() == 0 else None,
            print_every=cfg.log_every,
            batch_size=cfg.data.batch_size,
        )

    def _build_data(self):
        dcfg = self.cfg.data
        if dcfg.jpeg_dir:
            from ..data import JpegDataset

            return JpegDataset(
                dcfg.jpeg_dir,
                dcfg.batch_size,
                out_dim=self.cfg.model.input_dim,
                train=True,
                layout=self.cfg.execution.layout,
                seed=self.cfg.seed,
            )
        if dcfg.synthetic or not dcfg.shard_dir:
            return SyntheticDataset(
                dcfg.batch_size,
                image_dim=self.cfg.model.input_dim,
                channels=self.cfg.model.in_channels,
                num_classes=self.cfg.model.num_classes,
                layout=self.cfg.execution.layout,
            )
        dataset = ShardDataset(
            dcfg.shard_dir,
            num_shards=dcfg.num_shards,
            shard_images=dcfg.shard_images,
            image_dim=self.cfg.model.input_dim,
            channels=self.cfg.model.in_channels,
            disk_layout=dcfg.layout,
        )
        # multi-host: each host feeds its local chips a distinct shard
        # stream (host i starts num_shards/n_hosts shards in); batch_size
        # is per-host (the mesh assembles the global batch across hosts)
        n_hosts = jax.process_count()
        if n_hosts > 1 and self.cursor.shard == 0 and self.cursor.batch_in_shard == 0:
            self.cursor.shard = (dcfg.num_shards // n_hosts) * jax.process_index()
        # prefer the native C++ read-ahead loader (csrc/shard_loader.cc);
        # fall back to the Python mmap iterator (also used when train-time
        # flip augmentation is on — the flip runs host-side in numpy)
        from ..data.native import NativeShardIterator, native_available

        # the iterator gets a *copy* of the cursor: its worker thread runs
        # ahead of training by the prefetch depth, so the live cursor must
        # never be the one checkpoints record. self.cursor tracks the last
        # trained batch via the per-batch snapshots (run() below); dumping
        # it matches the reference's synchronous cursor-at-update semantics
        # (dump_trainer inside update_parameters, resnet.cu:2947-2950).
        if native_available() and not dcfg.random_flip:
            return NativeShardIterator(
                dataset,
                dcfg.batch_size,
                layout=self.cfg.execution.layout,
                cursor=replace(self.cursor),
                prefetch_depth=max(2, dcfg.prefetch),
            )
        return ShardIterator(
            dataset,
            dcfg.batch_size,
            layout=self.cfg.execution.layout,
            cursor=replace(self.cursor),
            random_flip=dcfg.random_flip,
            seed=self.cfg.seed,
        )

    def _device_iter(self):
        # one persistent prefetcher: building a new one per run() would
        # leak worker threads that keep consuming the host iterator
        if self._dev_iter is not None:
            return self._dev_iter
        dcfg = self.cfg.data
        if dcfg.synthetic and dcfg.device_batches > 0:
            # device-resident rotation: K distinct synthetic batches staged
            # once, zero per-step H2D — the step runs at full device cadence
            # with the input pipeline out of the loop
            import itertools

            sharding = self._batch_shardings
            if sharding is None and self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                sharding = NamedSharding(
                    self.mesh, P(self.cfg.parallel.data_axis)
                )
            staged = []
            it = iter(self._host_iter)
            for _ in range(dcfg.device_batches):
                b = dict(next(it))
                # same contract as DevicePrefetcher._put: cursor is host
                # bookkeeping (meaningless for a cycled staging set),
                # unknown keys take the default placement
                b.pop("cursor", None)
                if sharding is not None:
                    staged.append({
                        k: jax.device_put(
                            v,
                            sharding.get(k)
                            if isinstance(sharding, dict)
                            else sharding,
                        )
                        for k, v in b.items()
                    })
                else:
                    staged.append(jax.tree.map(jax.device_put, b))
            self._dev_iter = itertools.cycle(staged)
            return self._dev_iter
        transfer = (
            dcfg.transfer_dtype if dcfg.transfer_dtype != "float32" else None
        )
        self._dev_iter = prefetch_to_device(
            self._host_iter,
            depth=dcfg.prefetch,
            mesh=self.mesh,
            data_axis=self.cfg.parallel.data_axis,
            transfer_dtype=transfer,
            batch_shardings=self._batch_shardings,
        )
        return self._dev_iter

    def _maybe_check_errors(self):
        if not self.cfg.check_errors:
            return
        ok = bool(jax.device_get(check_state_finite(self.state.params)))
        if not ok:
            # order after any in-flight periodic write, then dump
            # synchronously — the forensic dump must be on disk before the
            # process dies (check_errors, resnet.cu:2879-2907)
            if self.checkpointer is not None:
                self.checkpointer.wait()
            save_checkpoint(
                self.cfg.checkpoint_dir, NAN_DUMP_ID, self.state, self.cursor
            )
            report = nonfinite_report(self.state.params)
            raise NonFiniteError(
                "non-finite trainer state; dumped to sentinel "
                f"{NAN_DUMP_ID}:\n" + "\n".join(report)
            )

    def run(self, num_steps: int) -> Dict[str, Any]:
        """Train for num_steps. Returns the last metrics."""
        cfg = self.cfg
        it = self._device_iter()
        pending = None  # (step, metrics) logged one step behind
        last: Dict[str, Any] = {}
        # host-side step mirror: fetching state.step from the device every
        # iteration would force a sync and defeat the async dispatch
        # pipeline (one fetch here, then counted locally)
        step_before = int(jax.device_get(self.state.step))
        for _ in range(num_steps):
            batch = next(it)
            # post-batch stream position of THIS batch; applied to
            # self.cursor only after the step trains on it
            batch_cursor = batch.pop("cursor", None)
            if (
                cfg.checkpoint_every
                and step_before % cfg.checkpoint_every == 0
                and cfg.checkpoint_dir
            ):
                # dump before the update, like update_parameters
                # (resnet.cu:2947-2950); async mode snapshots here and
                # overlaps the file write with the coming steps
                save = (
                    self.checkpointer.save
                    if self.checkpointer is not None
                    else save_checkpoint
                )
                save(
                    cfg.checkpoint_dir, step_before, self.state, self.cursor,
                    metadata={"loss_history": self.logger.loss_history[-100:]},
                )
            self.state, metrics = self.train_step(self.state, batch)
            if batch_cursor is not None:
                self.cursor = batch_cursor
            if pending is not None and cfg.record_metrics:
                # only fetch metrics when logging is on — each device_get is
                # a host sync
                s, m = pending
                self.logger.log_step(s, jax.device_get(m), epoch=self.cursor.epoch)
            pending = (step_before, metrics)
            step_before += 1
            self._maybe_check_errors()
        if pending is not None:
            s, m = pending
            last = {k: float(v) for k, v in jax.device_get(m).items()}
            self.logger.log_step(s, last, epoch=self.cursor.epoch)
        return last

    def run_epochs(self, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.epochs
        if hasattr(self._host_iter, "batches_per_epoch"):
            # ShardIterator and NativeShardIterator both expose this
            steps_per_epoch = self._host_iter.batches_per_epoch
        else:
            steps_per_epoch = max(
                1,
                (self.cfg.data.shard_images * self.cfg.data.num_shards)
                // self.cfg.data.batch_size,
            )
        for e in range(epochs):
            self.run(steps_per_epoch)
            self.logger.epoch_summary(e, steps_per_epoch)
        self.finalize()

    def evaluate(self, data: Iterator, num_batches: int) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        it = prefetch_to_device(
            data, depth=self.cfg.data.prefetch, mesh=self.mesh,
            data_axis=self.cfg.parallel.data_axis,
            batch_shardings=self._batch_shardings,
        )
        try:
            for _ in range(num_batches):
                batch = next(it)
                batch.pop("cursor", None)
                m = jax.device_get(self.eval_step(self.state, batch))
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        finally:
            # without this the prefetcher's daemon thread keeps draining
            # the eval iterator and holding device batches after return
            it.stop()
        return {k: v / num_batches for k, v in sums.items()}

    def evaluate_quantized(
        self, data: Iterator, num_batches: int, calib_images=None
    ) -> Dict[str, float]:
        """Evaluate the W8A8 post-training-quantized model (quantize.py):
        fold BN from the current state, calibrate (on ``calib_images`` if
        given — ideally training batches — else on the first eval batch),
        then run int8 inference over ``num_batches``. Returns the same
        loss/accuracy/top5 means as ``evaluate`` for direct comparison."""
        import itertools

        import jax.numpy as jnp

        from ..ops import cross_entropy, top1_accuracy, topk_accuracy
        from ..quantize import quantize_model, quantized_forward

        it = iter(data)
        first = dict(next(it))
        first.pop("cursor", None)
        calib = calib_images if calib_images is not None else first["images"]
        mcfg, relu_cap = self.cfg.model, self.cfg.execution.relu_cap
        qparams, scales = quantize_model(
            self.state.params, self.state.bn_state, mcfg,
            jnp.asarray(calib), relu_cap=relu_cap,
        )

        @jax.jit
        def qstep(qp, batch):
            logits = quantized_forward(
                qp, scales, batch["images"], mcfg, relu_cap=relu_cap
            )
            labels = batch["labels"]
            return {
                "loss": cross_entropy(logits, labels, reduction="mean"),
                "accuracy": top1_accuracy(logits, labels),
                "top5": topk_accuracy(logits, labels, 5),
            }

        sums: Dict[str, float] = {}
        batches = itertools.chain([first], it)
        for _ in range(num_batches):
            batch = dict(next(batches))
            batch.pop("cursor", None)
            m = jax.device_get(qstep(qparams, batch))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return {k: v / num_batches for k, v in sums.items()}

    def finalize(self):
        if self._dev_iter is not None:
            if hasattr(self._dev_iter, "stop"):  # cycle() has no worker
                self._dev_iter.stop()
            self._dev_iter = None
        if self.checkpointer is not None:
            self.checkpointer.close()  # drain pending writes (re-raises errors)
        if self.cfg.checkpoint_dir:
            save_checkpoint(
                self.cfg.checkpoint_dir, FINAL_DUMP_ID, self.state, self.cursor
            )
        self.logger.close()

    def __del__(self):
        try:
            if getattr(self, "_dev_iter", None) is not None:
                self._dev_iter.stop()
        except Exception:
            pass
        try:
            # best-effort drain; ThreadPoolExecutor threads are also joined
            # at interpreter exit, so in-flight dumps land either way
            if getattr(self, "checkpointer", None) is not None:
                self.checkpointer.close()
        except Exception:
            pass
