"""resnet_tpu — a JAX training framework with the capabilities of the
hand-rolled CUDA/cuDNN ResNet-50 trainer at als244/ResNet.

Compute path: JAX/XLA (convolutions and the FC layer go to cuDNN / cuBLAS
on an NVIDIA GPU). Parallelism: jax.sharding over a device mesh, with
XLA-inserted collectives (new capability; the reference is single-GPU).
See SURVEY.md for the full mapping.
"""

import os as _os

import jax as _jax

__version__ = "0.1.0"

# <checkout>/.jax_cache: a fixed path, so every process of this checkout
# finds what an earlier one compiled (the path is part of the cache key)
CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def compile_cache_dir(environ=None, configured_platforms=None):
    """Where this package puts JAX's persistent compilation cache, or None
    when it should set nothing.

    - ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing here.
    - platforms pinned to CPU only (``JAX_PLATFORMS=cpu``): no cache, as
      CPU executables bake in the compiling host's instruction set.
    - otherwise: ``CHECKOUT_CACHE_DIR``.

    The reference amortises tuning cost with in-process per-layer algorithm
    caches (resnet_cudnn_fast.cu:1275-1303); the persistent cache keeps
    XLA's compiled and autotuned executables across processes."""
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    platforms = environ.get("JAX_PLATFORMS") or configured_platforms or ""
    named = [p for p in platforms.lower().split(",") if p]
    if named and all(p == "cpu" for p in named):
        return None
    return CHECKOUT_CACHE_DIR


def _enable_compile_cache() -> None:
    path = compile_cache_dir(configured_platforms=_jax.config.jax_platforms)
    if path is None:
        return
    _os.makedirs(path, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", path)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

from . import analysis, config, data, export, models, ops, optim, parallel, train, utils  # noqa: E402
