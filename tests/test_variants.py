"""The reference's six trainer binaries as config presets (SURVEY.md §0):
each builds and takes one train step on the tiny model through the one XLA
path, with its own layout, precision, remat policy and ReLU cap."""

import dataclasses

import jax
import numpy as np
import pytest

from resnet_tpu.config import VARIANT_PRESETS, tiny_model_config, variant_config
from resnet_tpu.train import init_train_state, make_train_step


@pytest.mark.parametrize("variant", sorted(VARIANT_PRESETS))
def test_variant_preset_trains_one_step(rng, variant):
    cfg = variant_config(variant)
    assert cfg.model.name == "resnet50"
    cfg = dataclasses.replace(
        cfg,
        model=tiny_model_config(),
        data=dataclasses.replace(cfg.data, batch_size=4),
    )
    d = cfg.model.input_dim
    shape = (4, d, d, 3) if cfg.execution.layout == "NHWC" else (4, 3, d, d)
    batch = {
        "images": rng.normal(0, 50, shape).astype(np.float32),
        "labels": rng.integers(0, cfg.model.num_classes, (4,)).astype(np.int32),
    }
    state, metrics = make_train_step(cfg, donate=False)(
        init_train_state(cfg), batch
    )
    assert int(state.step) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # the step moved the parameters
    before = jax.tree.leaves(init_train_state(cfg).params)
    after = jax.tree.leaves(state.params)
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(before, after))
