"""Tests that need an NVIDIA GPU (marker ``gpu``; they take the ``gpu``
fixture, which skips them on any other device).

Run them on a GPU host with:

    RESNET_TPU_TEST_PLATFORM=cuda python -m pytest tests -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_int8_quantized_forward_on_gpu(gpu, rng):
    """The W8A8 path's int8 convs lower through cuDNN (s8 operands, int32
    accumulation) and track the fp folded model with the CPU test's
    thresholds (tests/test_quantize.py)."""
    from resnet_tpu.config import tiny_model_config
    from resnet_tpu.models import init_bn_state, init_params
    from resnet_tpu.quantize import (
        fold_bn_inference,
        folded_forward,
        quantize_model,
        quantized_forward,
    )

    mcfg = tiny_model_config(init_filters=32, input_dim=32)
    params = init_params(jax.random.PRNGKey(1234), mcfg)
    bn_state = jax.tree.map(lambda a: a + 0.1, init_bn_state(mcfg))

    def images(n):
        return jnp.asarray(rng.normal(0, 50, (n, 32, 32, 3)).astype(np.float32))

    qparams, scales = quantize_model(params, bn_state, mcfg, images(8))
    x = images(16)
    q = np.asarray(
        jax.jit(lambda qp, xx: quantized_forward(qp, scales, xx, mcfg))(
            qparams, x
        )
    )
    fp = np.asarray(
        folded_forward(fold_bn_inference(params, bn_state, mcfg), x, mcfg)
    )
    assert np.all(np.isfinite(q))
    corr = np.corrcoef(fp.ravel(), q.ravel())[0, 1]
    assert corr > 0.98, corr
