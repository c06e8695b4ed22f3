"""Device mesh construction and placement helpers.

New capability: the reference is strictly single-GPU/single-process
(SURVEY.md section 2.7 — no NCCL/MPI anywhere). Here the distributed layer
is jax.sharding over a device mesh, with XLA's collectives (NCCL between
GPUs); these helpers build the 1-D data-parallel mesh used across the four
GPUs of one host and keep axis names open for wider meshes (tp/pp axes can
be added without touching callers).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    num_devices: int = 0,
    axis: str = "data",
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if num_devices and num_devices > 0:
        if num_devices > len(devices):
            raise ValueError(
                f"mesh wants {num_devices} devices, only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_2d(
    data: int,
    model: int,
    devices: Optional[Sequence[jax.Device]] = None,
    axes: Sequence[str] = ("data", "model"),
) -> Mesh:
    """(data x model) mesh for composite data+tensor parallelism. NVLink
    joins the GPUs of a host all to all, so the order of devices in the
    grid carries no meaning; the axes follow the algorithm alone."""
    if devices is None:
        devices = jax.devices()
    n = data * model
    if n > len(devices):
        raise ValueError(
            f"mesh wants {data}x{model}={n} devices, only "
            f"{len(devices)} available"
        )
    grid = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(grid, tuple(axes))


def composite_shardings(state, mesh: Mesh, model_axis: str = "model"):
    """Sharding tree for a TrainState on a (data, model) mesh: the FC head
    (weights, bias, and their optimizer moments — every leaf whose path
    passes through 'fc') is sharded over the model axis on its class dim;
    everything else is replicated, with the batch sharded over 'data' by
    the caller. Tensor parallelism where a ResNet has a dense matmul to
    split; conv stages scale by data parallelism. The partitioner inserts
    the logit all-gather / sharded-softmax collectives automatically."""
    size = mesh.shape[model_axis]
    repl = NamedSharding(mesh, P())

    def assign(path, leaf):
        in_fc = any(getattr(p, "key", None) == "fc" for p in path)
        shape = getattr(leaf, "shape", ())
        if in_fc and shape and shape[-1] % size == 0:
            spec = [None] * (len(shape) - 1) + [model_axis]
            return NamedSharding(mesh, P(*spec))
        return repl

    return jax.tree_util.tree_map_with_path(assign, state)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """Place a host batch dict onto the mesh, sharded along the batch dim."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)


def replicate(tree, mesh: Mesh):
    from .multihost import put_global

    return put_global(tree, NamedSharding(mesh, P()))


def zero_shardings(state, mesh: Mesh, axis: str = "data",
                   min_bytes: int = 2 ** 16):
    """ZeRO-style sharding tree for a TrainState: every parameter,
    optimizer-moment, and BN-state leaf is sharded across the data axis
    on its largest evenly-divisible dimension; XLA derives the
    all-gathers that materialize full tensors for compute and keeps the
    persistent copy sharded. Cuts per-chip state memory ~1/N — the lever
    that matters when the OPTIMIZER STATE (not activations) is the
    ceiling. Leaves smaller than min_bytes stay replicated: a gather per
    tiny BN vector costs more latency than the bytes save.

    Numerics are identical to replicated DP (the partitioner's gathers
    are semantically invisible) — tested in tests/test_parallel.py.
    """
    size = mesh.shape[axis]
    repl = NamedSharding(mesh, P())

    def assign(leaf):
        shape = getattr(leaf, "shape", ())
        nbytes = getattr(leaf, "nbytes", 0)
        if not shape or nbytes < min_bytes:
            return repl
        # largest divisible dim; ties -> the last one (HWIO kernels and
        # FC weights then shard on output channels, the contiguous dim)
        best = -1
        for i, d in enumerate(shape):
            if d % size == 0 and (best < 0 or d >= shape[best]):
                best = i
        if best < 0:
            return repl
        spec = [None] * len(shape)
        spec[best] = axis
        return NamedSharding(mesh, P(*spec))

    return jax.tree.map(assign, state)


def spatial_batch_specs(
    data_axis: str = "data",
    spatial_axis: str = "spatial",
    layout: str = "NHWC",
):
    """(images, labels) PartitionSpecs that split the image HEIGHT dim
    over the spatial axis — H is dim 1 in NHWC, dim 2 in NCHW."""
    if layout == "NHWC":
        img = P(data_axis, spatial_axis)
    elif layout == "NCHW":
        img = P(data_axis, None, spatial_axis)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return img, P(data_axis)


def spatial_shard_batch(
    batch,
    mesh: Mesh,
    data_axis: str = "data",
    spatial_axis: str = "spatial",
    layout: str = "NHWC",
):
    """Place a batch with the image HEIGHT dim split over the spatial
    mesh axis (and the batch dim over the data axis).

    Spatial partitioning is how conv nets scale past per-chip memory when
    the IMAGE (not the batch) is the big dimension — e.g. high-resolution
    inputs where even batch 1 doesn't fit. The XLA SPMD partitioner
    derives the halo exchanges every windowed op (conv, pooling) needs at
    the shard seams and the cross-shard psums for BN's spatial moments;
    nothing in the model changes. New capability vs the reference
    (single-GPU, SURVEY 2.7); params stay replicated — shard them over
    `data` separately if both levers are needed.
    """
    img_spec, lbl_spec = spatial_batch_specs(data_axis, spatial_axis, layout)
    img = NamedSharding(mesh, img_spec)
    lbl = NamedSharding(mesh, lbl_spec)

    def place(k, x):
        return jax.device_put(x, img if getattr(x, "ndim", 0) >= 3 else lbl)

    return {k: place(k, v) for k, v in batch.items()}
