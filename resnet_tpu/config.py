"""Configuration layer for the resnet_tpu framework.

The reference (als244/ResNet) has no config system: each of its six CUDA
variants hard-codes a point in the (kernel engine x layout x memory x
precision) space as compile-time constants in ``main`` (resnet.cu:3245-3296).
Here those axes become explicit, runtime-selected configuration. Every
variant runs on XLA (convolutions and the FC layer go to the autotuned
cuDNN / cuBLAS libraries, as in the reference's cuDNN variants):

  * ``layout``    : 'NHWC' | 'NCHW' (~ resnet_cudnn.cu vs resnet_cudnn_nchw.cu).
  * ``precision`` : 'fp32' | 'bf16' mixed (~ resnet_cudnn_fast.cu TensorCore
                    math, Makefile:25-28 --use_fast_math).
  * ``remat``     : recompute activations in backward instead of caching
                    (~ resnet_clean.cu / resnet_cudnn_lowmem.cu memory
                    strategies) via jax.checkpoint.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp

_DTYPES = {
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
    "float16": jnp.float16,
}


def resolve_dtype(name):
    """Map a dtype name (or dtype) to a jnp dtype."""
    if isinstance(name, str):
        return _DTYPES[name]
    return name


@dataclass(frozen=True)
class ModelConfig:
    """ResNet model hyper-shape.

    Defaults reproduce the reference ResNet-50 exactly
    (resnet.cu:3245-3258: input 224, 7x7/64/s2 stem, 3x3/s2 maxpool,
    16 bottleneck blocks with spatial reductions at blocks {3,7,13},
    final depth 2048, 1000 classes).
    """

    name: str = "resnet50"
    input_dim: int = 224
    in_channels: int = 3
    num_classes: int = 1000

    # Stem (resnet.cu:3246-3250).
    init_kernel: int = 7
    init_filters: int = 64
    init_stride: int = 2
    maxpool_kernel: int = 3
    maxpool_stride: int = 2

    # Stages: number of residual blocks per stage. (3,4,6,3) -> 16 blocks,
    # the reference's N_CONV_BLOCKS=16 with IS_BLOCK_SPATIAL_REDUCTION at
    # 3/7/13 == first block of stages 2..4 (resnet.cu:3252-3258).
    block_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    expansion: int = 4
    # interior-width multiplier for bottleneck blocks (wide-ResNet family;
    # 2.0 = wide_resnet50_2). Output depths are unchanged.
    width_multiplier: float = 1.0
    # cardinality of the 3x3 conv (ResNeXt); 1 = plain ResNet.
    groups: int = 1

    # Reference quirk: projection convs at stage transitions are 3x3/s2
    # (resnet.cu:770-797), not the standard 1x1/s2. Set to 1 for standard
    # torchvision-style ResNet.
    stride_projection_kernel: int = 3

    # Reference initializes every BN gamma to 1.0 (resnet.cu:684-708 with
    # is_zero=false at resnet.cu:955). zero_init_residual=True gives the
    # Goyal et al. 2017 zero-gamma-on-last-BN init the reference's comment
    # mentions but does not actually apply.
    zero_init_residual: bool = False

    # Reference FC layer has no bias (bare matmul, resnet.cu:1759).
    fc_bias: bool = False

    bn_eps: float = 1e-7  # trainer->eps, shared with Adam (resnet.cu:3290)
    # Track running BN statistics for inference. The reference keeps none
    # (cuDNN call passes NULL running stats, resnet_cudnn.cu:1679); enabling
    # this adds standard EMA stats for an eval path.
    bn_momentum: float = 0.9
    track_running_stats: bool = True

    @property
    def num_blocks(self) -> int:
        return sum(self.block_sizes)

    @property
    def final_depth(self) -> int:
        base = self.init_filters * (2 ** (len(self.block_sizes) - 1))
        return base * self.expansion if self.bottleneck else base

    def stage_of_block(self, block_idx: int) -> int:
        acc = 0
        for stage, n in enumerate(self.block_sizes):
            acc += n
            if block_idx < acc:
                return stage
        raise ValueError(f"block {block_idx} out of range")

    def is_reduction_block(self, block_idx: int) -> bool:
        """True when this block halves spatial dims (stride-2 3x3)."""
        starts = [sum(self.block_sizes[:i]) for i in range(len(self.block_sizes))]
        return block_idx in starts[1:]

    def is_projection_block(self, block_idx: int) -> bool:
        """True when this block carries a projection shortcut."""
        starts = [sum(self.block_sizes[:i]) for i in range(len(self.block_sizes))]
        return block_idx in starts


@dataclass(frozen=True)
class ExecutionConfig:
    """How the model executes on the device — the reference's 'variant'
    axis."""

    layout: str = "NHWC"  # 'NHWC' | 'NCHW'
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    param_dtype: str = "float32"
    # Recompute policy — the reference's per-variant memory-strategy axis
    # (SURVEY.md appendix):
    #   'none'  cache everything                 (~ resnet.cu, batch 32)
    #   'block' recompute within residual blocks (~ resnet_clean.cu /
    #           lowmem's rotating scratch, batch 224/192)
    #   'stage' recompute whole stages — the most aggressive
    #   'elementwise' save conv/matmul outputs, recompute only BN/ReLU/
    #        joins in backward — exactly resnet_clean.cu's strategy (cache
    #        conv results + stats, recompute activations, :2712-2753)
    remat: str = "none"  # 'none' | 'block' | 'stage' | 'elementwise'
    # Use the reference's numerically-naive softmax (resnet.cu:569-580, no
    # max subtraction) for forward-dump fidelity; training always uses a
    # stable log-softmax for the loss.
    stable_softmax: bool = True
    # Precision of fp32 convs/matmuls ('default'|'high'|'highest'); on a
    # GPU anything below 'highest' lets float32 products run in TF32.
    matmul_precision: str = "highest"
    # Space-to-depth stem (MLPerf trick): fold 2x2 spatial into channels so
    # the 7x7/s2/3ch stem becomes 4x4/s1/12ch — the same math with a wider
    # contraction. NHWC + 7x7 stem only.
    space_to_depth: bool = False
    # Clipped ReLU ceiling (the cuDNN-fast variant caps activations at 10,
    # resnet_cudnn_fast.cu:1143-1145). None = unbounded ReLU.
    relu_cap: Optional[float] = None
    # BatchNorm mode during training:
    #   'batch'  batch statistics (the reference's training semantics,
    #            resnet.cu:289 — no running stats feed the forward)
    #   'frozen' normalize with the running statistics even in train mode
    #            (standard frozen-BN fine-tuning; also isolates the cost of
    #            batch-stats computation in benchmarks)
    #   'off'    skip normalization entirely (ReLU only) — diagnostic
    #            ablation for perf attribution, not a training config
    bn_mode: str = "batch"
    # Ghost batch norm: compute BN statistics over the first
    # ``bn_stats_batch`` images of the per-device batch (0 = full batch,
    # the reference's exact semantics). The normalization/affine still
    # covers every image; only the statistics sample shrinks — the same
    # situation as per-replica BN in any data-parallel run (per-device
    # batch 64 on four cards at global 256), and the 'ghost BN' of Hoffer et
    # al. 2017, which at these sizes is accuracy-neutral-or-better. This is
    # a SEMANTIC axis, not a perf axis: the backward correction only touches
    # the stats sample (closed-form VJP, ops/batchnorm.py::batch_norm_ghost).
    bn_stats_batch: int = 0
    # Maxpool backward realization (ops/pooling.py):
    #   'select_scatter' autodiff of reduce_window (XLA SelectAndScatter)
    #   'mask'           custom VJP reconstructing the reference's argmax
    #                    scatter (first tie wins) as out-grid
    #                    compare/accumulate passes (a semantics cross-check)
    maxpool_vjp: str = "select_scatter"
    # Gradient accumulation: split each step's batch into this many
    # microbatches and lax.scan them inside the ONE jitted step — summed
    # gradients (the reference's summed-CE convention makes the sum exact),
    # one optimizer update. The memory-strategy axis the reference's lowmem
    # variants chase by hand (rotating scratch buffers, SURVEY.md appendix):
    # peak activation memory drops to one microbatch's worth, so effective
    # batch no longer caps at what activations fit. With bn_mode='batch',
    # BN statistics are per-microbatch (ghost BN at microbatch granularity,
    # Hoffer et al. 2017 — the same semantics as per-replica BN in any
    # data-parallel run); running stats EMA-merge sequentially, exactly as
    # sequential smaller steps would. frozen/off BN are microbatch-exact.
    grad_accum: int = 1
    # Unroll factor for the accumulation lax.scan (numerics-identical;
    # changes only the lowered control flow). 1 = a real while loop
    # (cheapest compile, aliased carry); grad_accum = fully unrolled
    # straight-line HLO without the while-loop carry.
    grad_accum_unroll: int = 1

    def __post_init__(self):
        # a typo must fail loudly, not fall through to a default path
        _check = {
            "layout": (self.layout, ("NHWC", "NCHW")),
            "compute_dtype": (self.compute_dtype, ("float32", "bfloat16")),
            "remat": (self.remat, ("none", "block", "stage", "elementwise")),
            "bn_mode": (self.bn_mode, ("batch", "frozen", "off")),
            "matmul_precision": (self.matmul_precision,
                                 ("default", "high", "highest")),
            "maxpool_vjp": (self.maxpool_vjp, ("select_scatter", "mask")),
        }
        for field, (value, allowed) in _check.items():
            if value not in allowed:
                raise ValueError(
                    f"ExecutionConfig.{field}={value!r}; expected one of "
                    f"{allowed}"
                )
        if self.bn_stats_batch < 0:
            raise ValueError(
                f"ExecutionConfig.bn_stats_batch={self.bn_stats_batch}; "
                "expected 0 (full batch) or a positive stats-sample size"
            )
        if self.grad_accum < 1:
            raise ValueError(
                f"ExecutionConfig.grad_accum={self.grad_accum}; expected"
                " a positive microbatch count"
            )
        if self.grad_accum_unroll < 1:
            raise ValueError(
                f"ExecutionConfig.grad_accum_unroll="
                f"{self.grad_accum_unroll}; expected a positive unroll"
                " factor"
            )

    @property
    def cdtype(self):
        return resolve_dtype(self.compute_dtype)

    @property
    def pdtype(self):
        return resolve_dtype(self.param_dtype)


@dataclass(frozen=True)
class OptimizerConfig:
    """Reference trainer hyperparameters (resnet.cu:3286-3291)."""

    name: str = "adam"  # 'adam' | 'sgd'
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.9  # MEAN_DECAY
    beta2: float = 0.999  # VAR_DECAY
    eps: float = 1e-7  # EPS
    momentum: float = 0.9  # for sgd
    # Skip weight decay on BN gamma/beta and biases ('no_bn') — standard
    # for the 76% recipe (Goyal et al. 2017); 'all' decays everything like
    # the reference kernels do.
    wd_mask: str = "all"  # 'all' | 'no_bn'
    # Per-element non-finite guards matching the reference optimizer kernels
    # (resnet.cu:605-662): skip m/v update on non-finite grad, roll back any
    # param that would become non-finite.
    nonfinite_guard: bool = True
    # Optional schedule: 'constant' | 'cosine' | 'step'
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0  # required for cosine
    # Label smoothing for the training CE (0 = reference behavior).
    label_smoothing: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration (reference L0: build_training_shards.c)."""

    shard_dir: str = ""
    shard_images: int = 32768  # SHARD_N_IMAGES, resnet.cu:3277
    batch_size: int = 32  # resnet.cu:3279
    layout: str = "NHWC"  # on-disk shard layout; 'NCHW' ~ fast variant shards
    num_shards: int = 40
    prefetch: int = 2  # device-side double buffering depth
    # dtype for the host->device image transfer. 'bfloat16' halves the
    # PCIe/interconnect traffic; the model casts to compute_dtype anyway.
    transfer_dtype: str = "float32"  # 'float32' | 'bfloat16'
    synthetic: bool = False  # generate random batches (bench/test mode)
    # With synthetic: pre-stage this many distinct batches on device and
    # cycle them with NO per-step host->device transfer. The soak/bench
    # mode that takes the input pipeline out of the loop: the step runs at
    # full device cadence while checkpoints, logging, and the scheduler
    # exercise the real production loop (0 = off: every synthetic batch
    # transfers).
    device_batches: int = 0
    # ImageFolder tree of raw JPEGs (online decode/augment pipeline);
    # overrides shard_dir when set.
    jpeg_dir: str = ""
    # Train-time horizontal flip (new vs the reference's offline-only
    # random crop; part of the standard 76%-top-1 recipe).
    random_flip: bool = False
    # ImageNet per-channel means baked into the shard builder
    # (build_training_shards.c:115-131), RGB order after its BGR swap.
    channel_means: Tuple[float, float, float] = (123.68, 116.78, 103.94)


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh / data-parallel configuration (new capability; the
    reference is single-GPU, SURVEY.md section 2.7)."""

    data_axis: str = "data"
    num_devices: int = 0  # 0 = all available
    mode: str = "auto"  # 'auto' (pjit/NamedSharding) | 'shard_map'
    # >1 splits the image HEIGHT over a second mesh axis (XLA SPMD derives
    # the conv/pool halo exchanges + BN spatial psums) — the large-image
    # lever for inputs where even batch 1 exceeds per-chip memory. 'auto'
    # mode only.
    spatial_devices: int = 1
    spatial_axis: str = "spatial"
    # ZeRO-style: shard params + optimizer moments + BN state across the
    # data axis (persistent copy sharded, SPMD all-gathers for compute) —
    # per-chip state memory ~1/N. 'auto' mode only. Leaves smaller than
    # zero_min_bytes stay replicated (a gather per tiny BN vector costs
    # more latency than the bytes save).
    zero_sharding: bool = False
    zero_min_bytes: int = 2 ** 16


# TrainConfig.resume_from sentinel: resume from the newest complete dump
RESUME_LATEST = -2


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    seed: int = 1234  # reference curand seed (resnet.cu:3266-3267)
    epochs: int = 40  # N_EPOCHS (resnet.cu:3291)
    checkpoint_every: int = 1000  # dump cadence (resnet.cu:2947)
    checkpoint_dir: str = "training_dumps/my_custom"
    log_every: int = 1  # PRINT_FREQ (resnet.cu:3318)
    # LOAD_FROM_DUMP_ID (resnet.cu:3299); -1 = fresh start, RESUME_LATEST
    # (-2) = resume from the newest complete dump in checkpoint_dir
    # (train.checkpoint.discover_latest_dump)
    resume_from: int = -1
    # Write periodic dumps on a background thread: device state is
    # snapshotted to host synchronously (before the next step donates the
    # buffers), the file I/O overlaps training. The final and non-finite
    # sentinel dumps are always synchronous. The reference stalls in
    # dump_trainer every 1000 steps (resnet.cu:2947-2950).
    async_checkpoint: bool = False
    # Fetch + record metrics every step (avg_loss_log.txt semantics,
    # resnet.cu:3386-3389). Each fetch is a host sync, one step behind the
    # device.
    record_metrics: bool = True
    # Per-step NaN/Inf scan of all trainer state (~ check_errors,
    # resnet.cu:2879-2907). Expensive; off by default outside debugging.
    check_errors: bool = False


def tiny_model_config(**overrides) -> ModelConfig:
    """A small ResNet for CPU tests: 16x16 input, 4 blocks, 8 classes."""
    base = dict(
        name="resnet-tiny",
        input_dim=16,
        num_classes=8,
        init_kernel=3,
        init_filters=8,
        init_stride=2,
        maxpool_kernel=3,
        maxpool_stride=2,
        block_sizes=(1, 1),
        expansion=4,
    )
    base.update(overrides)
    return ModelConfig(**base)


PRESETS = {
    "resnet18": dict(block_sizes=(2, 2, 2, 2), bottleneck=False, expansion=1),
    "resnet34": dict(block_sizes=(3, 4, 6, 3), bottleneck=False, expansion=1),
    "resnet50": dict(block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4),
    "resnet101": dict(block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4),
    "resnet152": dict(block_sizes=(3, 8, 36, 3), bottleneck=True, expansion=4),
    "wide_resnet50_2": dict(
        block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0,
    ),
    "wide_resnet101_2": dict(
        block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0,
    ),
    # resnext50_32x4d: cardinality 32, width/group 4 -> interior width
    # 128 at stage 0 = base 64 * 2.0
    "resnext50_32x4d": dict(
        block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0, groups=32,
    ),
    "resnext101_32x8d": dict(
        block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4,
        width_multiplier=4.0, groups=32,
    ),
}


# The reference's six binaries as config presets (SURVEY.md section 0 table):
# each maps a .cu variant's engineering point onto our config axes.
VARIANT_PRESETS = {
    # resnet.cu: cache-everything, batch 32, lr 1e-4 (its hand-rolled
    # kernels map onto the same XLA ops as the library variants)
    "resnet": dict(
        execution=dict(remat="none"),
        optimizer=dict(learning_rate=1e-4),
        data=dict(batch_size=32),
    ),
    # resnet_clean.cu: cache conv outputs + BN stats, recompute the
    # elementwise activations in backward (:2712-2753), batch 224
    "clean": dict(
        execution=dict(remat="elementwise"),
        optimizer=dict(learning_rate=1e-4),
        data=dict(batch_size=224),
    ),
    # resnet_cudnn.cu: library kernels, NHWC, batch 64, lr 1e-3
    "cudnn": dict(
        execution=dict(layout="NHWC"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=64),
    ),
    # resnet_cudnn_lowmem.cu: library kernels + lean backward, batch 192
    "lowmem": dict(
        execution=dict(remat="block"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192),
    ),
    # resnet_cudnn_nchw.cu: NCHW layout + autotune, batch 192
    "nchw": dict(
        execution=dict(layout="NCHW"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192, layout="NCHW"),
    ),
    # resnet_cudnn_fast.cu: TensorCore math + fused lib ops + relu cap 10
    "fast": dict(
        execution=dict(
            compute_dtype="bfloat16",
            matmul_precision="default", relu_cap=10.0,
        ),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192),
    ),
}


def variant_config(variant: str, model: str = "resnet50", **overrides) -> "TrainConfig":
    """Build a TrainConfig reproducing one of the reference's six trainer
    variants (SURVEY.md section 0). overrides update top-level TrainConfig
    fields."""
    if variant not in VARIANT_PRESETS:
        raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANT_PRESETS)}")
    p = VARIANT_PRESETS[variant]
    cfg = TrainConfig(
        model=model_config(model),
        execution=ExecutionConfig(**p.get("execution", {})),
        optimizer=OptimizerConfig(**p.get("optimizer", {})),
        data=DataConfig(**p.get("data", {})),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def model_config(name: str = "resnet50", **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown model {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return ModelConfig(name=name, **kw)
