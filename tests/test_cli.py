"""CLI config-building and end-to-end smoke tests."""

import numpy as np
import pytest

from resnet_tpu.train.cli import build_config, main


def test_build_config_defaults():
    cfg, args = build_config([])
    assert cfg.model.name == "resnet50"
    assert cfg.data.batch_size == 32  # resnet.cu:3279
    assert cfg.optimizer.learning_rate == pytest.approx(1e-4)  # resnet.cu:3286
    assert cfg.epochs == 40  # resnet.cu:3291
    assert cfg.checkpoint_every == 1000  # resnet.cu:2947
    assert cfg.seed == 1234  # resnet.cu:3266


def test_build_config_fast_variant_axes():
    cfg, _ = build_config([
        "--dtype", "bfloat16", "--layout", "NCHW", "--remat", "block",
        "--optimizer", "sgd", "--schedule", "step",
        "--steps", "100",
    ])
    assert cfg.execution.compute_dtype == "bfloat16"
    assert cfg.execution.matmul_precision == "default"  # bf16 implies
    assert cfg.execution.layout == "NCHW"
    assert cfg.execution.remat == "block"
    assert cfg.optimizer.name == "sgd"
    assert cfg.optimizer.total_steps == 100


def test_cli_trains_and_evaluates(tmp_path, capsys):
    ckpt = str(tmp_path / "dumps")
    main([
        "--model", "tiny", "--synthetic", "--steps", "3", "--batch-size", "8",
        "--checkpoint-dir", ckpt, "--checkpoint-every", "2", "--log-every", "0",
        "--no-mesh",
    ])
    import os

    assert os.path.isdir(tmp_path / "dumps" / "00000002")
    assert os.path.isdir(tmp_path / "dumps" / "77777777")

    main([
        "--model", "tiny", "--synthetic", "--eval-batches", "2", "--evaluate",
        "--batch-size", "8", "--checkpoint-dir", ckpt, "--log-every", "0",
        "--no-mesh",
    ])
    out = capsys.readouterr().out
    assert "eval over 2 batches" in out

    # --resume-from latest + --async-checkpoint: continue the run above
    # from its final dump (77777777), background-writing periodic dumps
    main([
        "--model", "tiny", "--synthetic", "--steps", "2", "--batch-size", "8",
        "--checkpoint-dir", ckpt, "--checkpoint-every", "1", "--log-every", "0",
        "--no-mesh", "--resume-from", "latest", "--async-checkpoint",
    ])
    out = capsys.readouterr().out
    assert "resumed from dump 77777777 at step 3" in out

    with pytest.raises(SystemExit):
        build_config(["--resume-from", "not-a-dump-id"])

    # --export: freeze the latest checkpoint into a serving artifact,
    # reload it and run inference with only the artifact bytes
    art = str(tmp_path / "model.stablehlo")
    main([
        "--model", "tiny", "--synthetic", "--batch-size", "8",
        "--checkpoint-dir", ckpt, "--resume-from", "latest", "--no-mesh",
        "--log-every", "0", "--export", art,
    ])
    out = capsys.readouterr().out
    assert "exported serving artifact" in out
    from resnet_tpu.export import load_inference

    served = load_inference(art)
    logits = np.asarray(served.call(np.zeros((2, 16, 16, 3), np.float32)))
    assert logits.shape == (2, 8)
    assert np.all(np.isfinite(logits))


def test_variant_presets():
    """The reference's six binaries map onto config presets (SURVEY.md §0)."""
    from resnet_tpu.config import variant_config

    fast = variant_config("fast")
    assert fast.execution.compute_dtype == "bfloat16"
    assert fast.execution.relu_cap == 10.0  # resnet_cudnn_fast.cu:1143
    assert fast.data.batch_size == 192  # resnet_cudnn_fast.cu:3278
    assert fast.optimizer.learning_rate == pytest.approx(1e-3)

    naive = variant_config("resnet")
    assert naive.execution.remat == "none"  # cache everything
    assert naive.data.batch_size == 32  # resnet.cu:3279
    assert naive.optimizer.learning_rate == pytest.approx(1e-4)

    clean = variant_config("clean")
    # resnet_clean.cu caches conv outputs, recomputes activations
    assert clean.execution.remat == "elementwise"
    assert clean.data.batch_size == 224  # resnet_clean.cu:3786

    nchw = variant_config("nchw")
    assert nchw.execution.layout == "NCHW"

    cfg, _ = build_config(["--variant", "fast", "--synthetic", "--steps", "1"])
    assert cfg.execution.compute_dtype == "bfloat16"
    assert cfg.data.synthetic
