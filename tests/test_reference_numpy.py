"""Adversarial fidelity gate: the framework's forward must match an
independent numpy transliteration of the reference CUDA kernels
(analysis/reference_numpy.py, written from resnet.cu's math alone).

Unlike test_golden.py (which freezes our own numerics and catches
regressions), this suite catches *errors*: a silently wrong BN formula,
conv/pool window geometry, or head numerics diverges from the oracle even
if our golden files were regenerated around it. This is the executable
form of the "fp32 forward at batch 1 comparable to reference dumps"
gate — real dumps can't be produced here (no CUDA), so the oracle
recomputes them the way analyze_trainer_dump.ipynb recomputes the head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from resnet_tpu.analysis.reference_numpy import (
    avgpool_ref,
    bn_ref,
    conv_ref,
    forward_reference_numpy,
    maxpool_ref,
    softmax_unstable,
)
from resnet_tpu.config import ExecutionConfig, model_config, tiny_model_config
from resnet_tpu.models import forward, init_params
from resnet_tpu.ops import batch_norm, conv2d, global_avg_pool, max_pool, softmax


FP32 = ExecutionConfig(compute_dtype="float32", matmul_precision="highest",
                       stable_softmax=False)


@pytest.mark.parametrize(
    "shape,kern,cout,stride",
    [
        ((2, 16, 16, 8), 3, 16, 1),
        ((2, 16, 16, 8), 3, 16, 2),
        ((2, 16, 16, 3), 7, 8, 2),   # stem geometry
        ((2, 8, 8, 16), 1, 32, 1),   # pointwise
        ((2, 8, 8, 16), 3, 32, 2),   # projection geometry
    ],
)
def test_conv_matches_reference_oracle(rng, shape, kern, cout, stride):
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.1, (kern, kern, shape[-1], cout)).astype(np.float32)
    ours = conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                  layout="NHWC", precision="highest")
    oracle = conv_ref(x, w, stride)
    np.testing.assert_allclose(np.asarray(ours), oracle, rtol=1e-5, atol=1e-5)


def test_bn_matches_reference_oracle(rng):
    x = rng.normal(3, 5, (4, 8, 8, 16)).astype(np.float32)
    gamma = rng.normal(1, 0.1, (16,)).astype(np.float32)
    beta = rng.normal(0, 0.1, (16,)).astype(np.float32)
    y, (m, v) = batch_norm(jnp.asarray(x), jnp.asarray(gamma),
                           jnp.asarray(beta), eps=1e-7, layout="NHWC")
    yo, mo, vo = bn_ref(x, gamma, beta, 1e-7)
    np.testing.assert_allclose(np.asarray(m), mo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v), vo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y), yo, rtol=1e-4, atol=1e-4)


def test_maxpool_matches_reference_oracle(rng):
    # even dim + stride 2 exercises the centered-window OOB edges
    x = rng.normal(0, 10, (3, 16, 16, 8)).astype(np.float32)
    ours = max_pool(jnp.asarray(x), kernel=3, stride=2, layout="NHWC")
    oracle = maxpool_ref(x, 3, 2)
    np.testing.assert_array_equal(np.asarray(ours), oracle)


def test_head_matches_reference_oracle(rng):
    x = rng.normal(0, 1, (4, 7, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(global_avg_pool(jnp.asarray(x), layout="NHWC")),
        avgpool_ref(x), rtol=1e-6, atol=1e-6,
    )
    z = rng.normal(0, 2, (4, 10)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(softmax(jnp.asarray(z), stable=False)),
        softmax_unstable(z), rtol=1e-5, atol=1e-6,
    )


def test_tiny_forward_matches_reference_oracle(rng):
    mcfg = tiny_model_config()
    params = init_params(jax.random.PRNGKey(1234), mcfg)
    x = rng.normal(0, 50, (4, mcfg.input_dim, mcfg.input_dim, 3)).astype(np.float32)
    logits, aux = forward(params, jnp.asarray(x), mcfg, FP32, train=True,
                          capture=True)
    params_np = jax.device_get(params)
    ol, op, tape = forward_reference_numpy(params_np, x, mcfg, capture=True)
    np.testing.assert_allclose(np.asarray(logits), ol, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(aux["activations"]["final_avg_pool"]),
        tape["final_avg_pool"], rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(aux["activations"]["pred"]), op, rtol=1e-4, atol=1e-5
    )


def test_resnet50_batch1_forward_matches_reference_oracle(rng):
    """The fidelity gate's shape: full ResNet-50, fp32, batch 1, 224^2.
    Tight-eps elementwise (fp32 reduction orders differ between XLA and
    numpy BLAS; 'bitwise-comparable' per SURVEY.md section 7)."""
    mcfg = model_config("resnet50")
    params = init_params(jax.random.PRNGKey(1234), mcfg)
    x = rng.normal(0, 50, (1, 224, 224, 3)).astype(np.float32)
    logits, _ = forward(params, jnp.asarray(x), mcfg, FP32, train=True)
    ol, _, _ = forward_reference_numpy(jax.device_get(params), x, mcfg)
    np.testing.assert_allclose(np.asarray(logits), ol, rtol=1e-3, atol=2e-4)
