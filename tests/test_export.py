"""Serving-export tests: the frozen StableHLO artifact reproduces the eval
forward exactly, round-trips through bytes on disk, and serves any batch
size via the symbolic batch dimension. (New capability — the reference has
no inference path; SURVEY.md §2 maps serving to this module.)"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from resnet_tpu.config import (
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    TrainConfig,
    tiny_model_config,
)
from resnet_tpu.export import (
    export_inference,
    export_inference_from_state,
    load_inference,
    save_inference,
)
from resnet_tpu.models import forward, init_bn_state, init_params
from resnet_tpu.train import init_train_state


@pytest.fixture(scope="module")
def tiny():
    mcfg = tiny_model_config()
    params = init_params(jax.random.PRNGKey(1234), mcfg)
    # perturb the fresh (0, 1) running stats so frozen-BN eval is nontrivial
    bn_state = jax.tree.map(
        lambda a: a + 0.1, init_bn_state(mcfg)
    )
    return mcfg, params, bn_state


def _images(rng, n, d):
    return jnp.asarray(rng.normal(0, 50, (n, d, d, 3)).astype(np.float32))


def test_export_matches_eval_forward(tiny, rng):
    mcfg, params, bn_state = tiny
    x = _images(rng, 4, mcfg.input_dim)
    exported = export_inference(params, mcfg, bn_state=bn_state, batch=4)
    got = np.asarray(exported.call(x))
    want, _ = forward(
        params, x, mcfg, ExecutionConfig(), train=False, bn_state=bn_state
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-5)


def test_export_symbolic_batch_serves_any_size(tiny, rng):
    mcfg, params, bn_state = tiny
    exported = export_inference(params, mcfg, bn_state=bn_state)  # symbolic batch
    for n in (1, 3, 8):
        x = _images(rng, n, mcfg.input_dim)
        got = np.asarray(exported.call(x))
        want, _ = forward(
            params, x, mcfg, ExecutionConfig(), train=False, bn_state=bn_state
        )
        assert got.shape == (n, mcfg.num_classes)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-5)


def test_export_roundtrip_through_disk(tiny, rng, tmp_path):
    mcfg, params, bn_state = tiny
    x = _images(rng, 2, mcfg.input_dim)
    exported = export_inference(params, mcfg, bn_state=bn_state)
    path = save_inference(str(tmp_path / "model.stablehlo"), exported)
    restored = load_inference(path)
    np.testing.assert_array_equal(
        np.asarray(exported.call(x)), np.asarray(restored.call(x))
    )
    # loader also accepts raw bytes
    restored2 = load_inference((tmp_path / "model.stablehlo").read_bytes())
    np.testing.assert_array_equal(
        np.asarray(exported.call(x)), np.asarray(restored2.call(x))
    )


def test_export_from_train_state_uses_running_stats(rng):
    # a trained state's running BN statistics must be baked in: perturbing
    # bn_state changes the artifact's output
    cfg = TrainConfig(
        model=tiny_model_config(),
        execution=ExecutionConfig(),
        optimizer=OptimizerConfig(),
        data=DataConfig(batch_size=4, synthetic=True),
    )
    state = init_train_state(cfg)
    x = _images(rng, 2, cfg.model.input_dim)
    base = np.asarray(export_inference_from_state(state, cfg, batch=2).call(x))

    bumped_bn = jax.tree.map(lambda a: a + 0.25, state.bn_state)
    state2 = state._replace(bn_state=bumped_bn)
    shifted = np.asarray(export_inference_from_state(state2, cfg, batch=2).call(x))
    assert not np.allclose(base, shifted)


def test_quantized_export_roundtrip(tiny, rng, tmp_path):
    """The W8A8 artifact serves any batch size and reproduces the direct
    quantized forward exactly after a disk round-trip."""
    from resnet_tpu.export import export_quantized_inference
    from resnet_tpu.quantize import quantize_model, quantized_forward

    mcfg, params, bn_state = tiny
    calib = _images(rng, 8, mcfg.input_dim)
    exported = export_quantized_inference(
        params, mcfg, calib, bn_state=bn_state
    )
    path = save_inference(str(tmp_path / "model_int8.stablehlo"), exported)
    served = load_inference(path)

    qparams, scales = quantize_model(params, bn_state, mcfg, calib)
    for n in (1, 4):
        x = _images(rng, n, mcfg.input_dim)
        got = np.asarray(served.call(x))
        want = np.asarray(quantized_forward(qparams, scales, x, mcfg))
        assert got.shape == (n, mcfg.num_classes)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_weights_export_halves_artifact(tiny, rng):
    """weights_dtype='bfloat16' halves the baked-constant payload while the
    logits stay close to the fp32 artifact's."""
    mcfg, params, bn_state = tiny
    from resnet_tpu.export import serialize_inference

    fp = serialize_inference(export_inference(params, mcfg, bn_state=bn_state))
    bf = serialize_inference(export_inference(
        params, mcfg, bn_state=bn_state, weights_dtype="bfloat16"
    ))
    assert len(bf) < 0.65 * len(fp), (len(fp), len(bf))
    x = _images(rng, 2, mcfg.input_dim)
    a = np.asarray(load_inference(fp).call(x))
    b = np.asarray(load_inference(bf).call(x))
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.3)
