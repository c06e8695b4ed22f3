"""Smoke test on NVIDIA GPUs: ResNet-50 training end to end.

Drives the system through the entry points a user calls (``Trainer``,
``Trainer.evaluate``, ``quantize``, ``export``) at full ResNet-50 width,
random weights from a seed, synthetic data staged on the device:

  device      the first JAX device is a GPU; no CPU fallback
  reference   float32 forward at 224 (``matmul_precision='highest'``, no
              TF32) against the numpy transliteration of the reference
              network, then the bf16 forward against the float32 one
  train       batch-256 bf16 steps through ``Trainer``: initial summed loss
              ~ ln(1000) x 256, finite grad norm, loss falling on a fixed
              batch; compile s, step ms, img/s, peak device memory
  checkpoint  dump, resume in a new ``Trainer``, one more step on each,
              restored state bit-exact and the two steps in agreement
  eval        ``Trainer.evaluate`` (the jitted eval step) at batch 256
  int8        W8A8 ``quantized_forward`` against ``folded_forward``
  export      serving artifact exported for this backend, reloaded,
              called, compared with the eval forward

Usage:
  python chip_smoke.py               # the phases above, on one GPU
  python chip_smoke.py --four-cards  # only: data parallel over 4 GPUs
                                     # (auto, shard_map, ZeRO) vs one GPU,
                                     # ResNet-50 widths, one block a stage

Any failed phase ends the run with a non-zero exit code and no result line.
On success the last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Tolerances, each with its reason.
#
# float32 forward vs the numpy reference, as max|dlogit| / max|logit|: both
# are float32 with different summation orders; batch-stats BN renormalises
# every layer, so the difference stays at float32 rounding scale.
REF_FP32_TOL = 1e-3
# bf16 forward vs the float32 forward, as ||dlogits|| / ||logits||: bf16
# keeps 8 bits of mantissa, about 50 rounded layers compound, and batch-2
# BN statistics amplify it; an H100 measures ~9e-2 at this seed, while a
# broken bf16 path (wrong layout or cast) lands near 1.
REF_BF16_TOL = 2e-1
# Initial summed CE: the FC layer starts at variance 1e-4, so logits are
# near zero and the per-sample loss is near ln(num_classes).
INIT_LOSS_BAND = 0.05
# Resumed step vs uninterrupted step, same params and batch: only the
# order of sums differs (cuDNN algorithms, atomics in the maxpool backward).
RESUME_LOSS_TOL = 1e-3
RESUME_UPDATE_TOL = 5e-2  # ||dB' - dB|| / ||dB|| over all params
# W8A8 vs the folded float forward: the CPU test's threshold
# (tests/test_quantize.py::test_quantized_forward_tracks_fp).
INT8_MIN_CORR = 0.98
# Exported artifact vs the jitted eval forward, bf16 compute: the same
# program compiled twice, possibly with other conv algorithms.
EXPORT_TOL = 2e-2
# Four cards vs one card on the same global batch (float32, 'highest'):
# the tolerances of __graft_entry__.dryrun_multichip.
DP_LOSS_RTOL = 1e-4
DP_GNORM_RTOL = 1e-3


class PhaseError(AssertionError):
    """A phase's check did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def parse_smi(text: str):
    """Parse ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output into [(name, power_limit)], one per card."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


def query_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out, parse_smi(out)


def cudnn_conv_operand_types(hlo_text: str):
    """For each cuDNN convolution custom-call in compiled HLO text, the
    element types of its two operands (looked up from the instructions
    that define them: operands print by name only)."""
    defs = {}
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT )?(%[\w.\-]+) = \(?(\w+)\[", line)
        if m:
            defs[m.group(1)] = m.group(2)
    out = []
    for line in hlo_text.splitlines():
        if "__cudnn$conv" not in line:
            continue
        m = re.search(r"custom-call\(([^)]*)\)", line)
        args = re.findall(r"%[\w.\-]+", m.group(1))[:2]
        out.append(tuple(defs.get(a) for a in args))
    return out


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(devices),
        },
    })


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What each phase runs at. ``full()`` is the on-chip configuration;
    tests pass a tiny one."""

    model: object  # ModelConfig
    dp_model: object = None  # ModelConfig of the four-card comparison
    batch: int = 256
    ref_batch: int = 2
    int8_batch: int = 64
    export_batch: int = 8
    timed_steps: int = 10
    dp_batch: int = 32  # global batch of the four-card comparison

    @staticmethod
    def full() -> "Sizes":
        from resnet_tpu.config import model_config

        # ResNet-50 with standard 1x1/s2 projections, 224x224, 1000 classes.
        # The four-card comparison keeps every width (and each stage's
        # projection block) but one block per stage: it compiles five
        # float32 train steps, and depth adds compile time, not coverage
        # of the collectives.
        rn50 = model_config("resnet50", stride_projection_kernel=1)
        return Sizes(model=rn50, dp_model=dataclasses.replace(
            rn50, block_sizes=(1, 1, 1, 1)))


def _rel_maxdiff(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _images(seed: int, n: int, d: int) -> np.ndarray:
    # the synthetic pipeline's pixel scale (data/synthetic.py)
    return np.random.default_rng(seed).normal(0, 50, (n, d, d, 3)).astype(
        np.float32
    )


# ------------------------------------------------------------------ phases


def phase_device(want_count: int, require_gpu: bool = True) -> str:
    import jax
    import jaxlib

    devs = jax.devices()
    d = devs[0]
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}")
    print(f"[device] jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"[device] compile cache: "
          f"{jax.config.jax_compilation_cache_dir or 'off'}")
    if require_gpu:
        check(d.platform == "gpu",
              f"the first JAX device is {d.platform!r}, not a GPU")
        check(len(devs) >= want_count,
              f"need {want_count} GPUs, JAX sees {len(devs)}")
        raw, cards = query_smi()
        for line in raw.strip().splitlines():
            print(f"[device] nvidia-smi: {line.strip()}")
        name, limit = cards[0]
        return f"{name}, power limit {limit}"
    return f"{d.device_kind} (no nvidia-smi)"


def phase_reference(sizes: Sizes) -> None:
    import jax

    from resnet_tpu.analysis.reference_numpy import forward_reference_numpy
    from resnet_tpu.config import ExecutionConfig
    from resnet_tpu.models import forward, init_params

    mcfg = sizes.model
    params = init_params(jax.random.PRNGKey(1234), mcfg)
    x = _images(0, sizes.ref_batch, mcfg.input_dim)

    def logits_fn(ecfg):
        return jax.jit(lambda p, xx: forward(p, xx, mcfg, ecfg, train=True)[0])

    with jax.default_matmul_precision("highest"):
        fp32 = np.asarray(logits_fn(ExecutionConfig(
            compute_dtype="float32", matmul_precision="highest"))(params, x))
    want, _, _ = forward_reference_numpy(jax.device_get(params), x, mcfg)
    rel = _rel_maxdiff(fp32, want)
    print(f"[reference] fp32 vs numpy reference: max|dlogit|/max|logit| = "
          f"{rel:.3e} (tolerance {REF_FP32_TOL:g})")
    check(fp32.shape == want.shape, f"shape {fp32.shape} != {want.shape}")
    check(rel <= REF_FP32_TOL, f"fp32 forward off the reference by {rel:.3e}")

    bf16 = np.asarray(logits_fn(ExecutionConfig(
        compute_dtype="bfloat16", matmul_precision="default"))(params, x))
    rel16 = _rel_l2(bf16, fp32)
    print(f"[reference] bf16 vs fp32: ||dlogits||/||logits|| = {rel16:.3e} "
          f"(tolerance {REF_BF16_TOL:g}); max|dlogit|/max|logit| = "
          f"{_rel_maxdiff(bf16, fp32):.3e}")
    check(np.all(np.isfinite(bf16)), "non-finite bf16 logits")
    check(rel16 <= REF_BF16_TOL, f"bf16 forward off fp32 by {rel16:.3e}")


def _train_config(sizes: Sizes, ckpt_dir: str):
    from resnet_tpu.config import (
        DataConfig,
        ExecutionConfig,
        OptimizerConfig,
        TrainConfig,
    )

    return TrainConfig(
        model=sizes.model,
        execution=ExecutionConfig(
            compute_dtype="bfloat16", matmul_precision="default"
        ),
        optimizer=OptimizerConfig(),
        data=DataConfig(
            batch_size=sizes.batch, synthetic=True, device_batches=1
        ),
        checkpoint_dir=ckpt_dir,
        checkpoint_every=0,
        log_every=0,
    )


def _trainer(cfg, use_mesh=False):
    from resnet_tpu.data import SyntheticDataset
    from resnet_tpu.train import Trainer

    # one distinct batch, staged on the device once (device_batches=1):
    # every step trains on the same batch, with no host transfer
    data = SyntheticDataset(
        cfg.data.batch_size, image_dim=cfg.model.input_dim,
        num_classes=cfg.model.num_classes, seed=cfg.seed, distinct_batches=1,
    )
    return Trainer(cfg, data_source=data, use_mesh=use_mesh)


def phase_train(sizes: Sizes, ckpt_dir: str, card: str):
    import jax

    cfg = _train_config(sizes, ckpt_dir)
    trainer = _trainer(cfg)
    t0 = time.perf_counter()
    first = trainer.run(1)
    jax.block_until_ready(trainer.state)
    first_s = time.perf_counter() - t0

    n_classes = cfg.model.num_classes
    per_sample = first["loss_sum"] / sizes.batch
    print(f"[train] initial summed loss {first['loss_sum']:.2f} = "
          f"{per_sample:.4f} x {sizes.batch} (ln({n_classes}) = "
          f"{np.log(n_classes):.4f}); grad_norm {first['grad_norm']:.4g}")
    check(abs(per_sample / np.log(n_classes) - 1) <= INIT_LOSS_BAND,
          f"initial per-sample loss {per_sample} not ~ ln({n_classes})")
    check(np.isfinite(first["grad_norm"]), "non-finite grad norm")

    t0 = time.perf_counter()
    last = trainer.run(sizes.timed_steps)
    jax.block_until_ready(trainer.state)
    step_s = (time.perf_counter() - t0) / sizes.timed_steps
    losses = trainer.logger.loss_history
    print(f"[train] losses on the fixed batch: "
          + " ".join(f"{v:.4f}" for v in losses))
    check(np.isfinite(last["grad_norm"]), "non-finite grad norm")
    check(losses[-1] < losses[0],
          f"loss did not fall: {losses[0]} -> {losses[-1]}")

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"[train] {card}: first step (trace + compile + 1 step) "
          f"{first_s:.2f} s, compile ~{first_s - step_s:.2f} s; steady step "
          f"{1e3 * step_s:.2f} ms over {sizes.timed_steps} steps = "
          f"{sizes.batch / step_s:.1f} img/s; peak_bytes_in_use "
          f"{peak if peak is not None else 'not reported'}")
    return cfg, trainer


def phase_checkpoint(cfg, trainer):
    import jax

    from resnet_tpu.config import RESUME_LATEST
    from resnet_tpu.train.checkpoint import save_checkpoint

    step_a = int(jax.device_get(trainer.state.step))
    save_checkpoint(cfg.checkpoint_dir, step_a, trainer.state, trainer.cursor)
    state_a = jax.device_get(trainer.state)
    m_b = trainer.run(1)
    state_b = jax.device_get(trainer.state)
    del trainer  # free its device state before the second trainer

    resumed = _trainer(dataclasses.replace(cfg, resume_from=RESUME_LATEST))
    restored = jax.device_get(resumed.state)
    leaves_a = jax.tree.leaves(state_a)
    leaves_r = jax.tree.leaves(restored)
    check(len(leaves_a) == len(leaves_r), "restored state has another tree")
    check(all(np.array_equal(np.asarray(a), np.asarray(r))
              for a, r in zip(leaves_a, leaves_r)),
          "restored state differs from the dumped one")
    print(f"[checkpoint] dump {step_a} restored bit-exact "
          f"({len(leaves_a)} leaves)")

    m_r = resumed.run(1)
    state_r = jax.device_get(resumed.state)
    dloss = abs(m_r["loss"] - m_b["loss"]) / abs(m_b["loss"])
    upd_b = np.concatenate([
        (np.asarray(b, np.float64) - np.asarray(a, np.float64)).ravel()
        for a, b in zip(jax.tree.leaves(state_a.params),
                        jax.tree.leaves(state_b.params))])
    upd_r = np.concatenate([
        (np.asarray(r, np.float64) - np.asarray(a, np.float64)).ravel()
        for a, r in zip(jax.tree.leaves(state_a.params),
                        jax.tree.leaves(state_r.params))])
    dupd = float(np.linalg.norm(upd_r - upd_b) / np.linalg.norm(upd_b))
    print(f"[checkpoint] resumed step vs uninterrupted step: loss rel diff "
          f"{dloss:.2e} (tolerance {RESUME_LOSS_TOL:g}), update rel diff "
          f"{dupd:.2e} (tolerance {RESUME_UPDATE_TOL:g})")
    check(int(state_r.step) == step_a + 1, "resumed step counter is wrong")
    check(dloss <= RESUME_LOSS_TOL, f"resumed loss off by {dloss:.2e}")
    check(dupd <= RESUME_UPDATE_TOL, f"resumed update off by {dupd:.2e}")
    return resumed


def phase_eval(sizes: Sizes, trainer) -> None:
    from resnet_tpu.data import SyntheticDataset

    mcfg = trainer.cfg.model
    data = SyntheticDataset(
        sizes.batch, image_dim=mcfg.input_dim, num_classes=mcfg.num_classes,
        seed=7, distinct_batches=1,
    )
    m = trainer.evaluate(data, 1)
    print(f"[eval] batch {sizes.batch}: " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(m.items())))
    check(all(np.isfinite(v) for v in m.values()), "non-finite eval metrics")
    check(0.0 <= m["accuracy"] <= m["top5"] <= 1.0, "accuracy out of range")


def phase_int8(sizes: Sizes, state) -> None:
    import jax

    from resnet_tpu.config import ExecutionConfig
    from resnet_tpu.models import forward
    from resnet_tpu.quantize import (
        fold_bn_inference,
        folded_forward,
        quantize_model,
        quantized_forward,
    )
    from resnet_tpu.train.step import _merge_running_stats

    mcfg = sizes.model
    params = state.params
    calib = _images(11, sizes.int8_batch, mcfg.input_dim)
    x = _images(12, sizes.int8_batch, mcfg.input_dim)
    # running statistics as a deployed model has them: the batch statistics
    # of representative data (a few training steps leave them mostly init)
    _, aux = jax.jit(lambda p, xx: forward(
        p, xx, mcfg, ExecutionConfig(), train=True))(params, calib)
    bn_state = _merge_running_stats(state.bn_state, aux["bn_stats"], 0.0)

    qparams, scales = quantize_model(params, bn_state, mcfg, calib)
    qfn = jax.jit(lambda qp, xx: quantized_forward(qp, scales, xx, mcfg))
    convs = cudnn_conv_operand_types(qfn.lower(qparams, x).compile().as_text())
    n_s8 = sum(t == ("s8", "s8") for t in convs)
    print(f"[int8] compiled program: {len(convs)} cuDNN conv calls, "
          f"{n_s8} of them on s8 operands")
    # no float path: every conv cuDNN runs here takes int8 operands
    check(n_s8 == len(convs), f"int8 convs run on {convs}")
    q = np.asarray(qfn(qparams, x))
    fp = np.asarray(jax.jit(lambda ip, xx: folded_forward(ip, xx, mcfg))(
        fold_bn_inference(params, bn_state, mcfg), x))
    check(q.shape == fp.shape, f"int8 logits shape {q.shape} != {fp.shape}")
    check(np.all(np.isfinite(q)), "non-finite int8 logits")
    corr = float(np.corrcoef(fp.ravel(), q.ravel())[0, 1])
    agree = float(np.mean(fp.argmax(-1) == q.argmax(-1)))
    print(f"[int8] batch {sizes.int8_batch}: corr(int8, fp) = {corr:.5f} "
          f"(minimum {INT8_MIN_CORR}), top-1 agreement {agree:.3f}")
    check(corr > INT8_MIN_CORR, f"int8 logits correlate {corr:.5f} with fp")


def phase_export(sizes: Sizes, cfg, state, out_dir: str) -> None:
    import jax

    from resnet_tpu.export import (
        export_inference_from_state,
        load_inference,
        save_inference,
    )
    from resnet_tpu.models import forward

    exported = export_inference_from_state(state, cfg)
    path = save_inference(os.path.join(out_dir, "resnet50.stablehlo"),
                          exported)
    loaded = load_inference(path)
    x = _images(13, sizes.export_batch, cfg.model.input_dim)
    got = np.asarray(loaded.call(x))
    want = np.asarray(jax.jit(lambda p, b, xx: forward(
        p, xx, cfg.model, cfg.execution, train=False, bn_state=b)[0])(
            state.params, state.bn_state, x))
    rel = _rel_maxdiff(got, want)
    print(f"[export] platforms {tuple(loaded.platforms)}, "
          f"{os.path.getsize(path)} bytes; artifact vs eval forward at batch "
          f"{sizes.export_batch}: max|dlogit|/max|logit| = {rel:.3e} "
          f"(tolerance {EXPORT_TOL:g})")
    backend = jax.default_backend()
    want_platform = "cuda" if backend == "gpu" else backend
    check(tuple(loaded.platforms) == (want_platform,),
          f"artifact built for {loaded.platforms}, not {want_platform}")
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(rel <= EXPORT_TOL, f"exported logits off by {rel:.3e}")


def phase_four_cards(sizes: Sizes, n: int = 4) -> None:
    """Data parallel over n cards in 'auto' (jit + NamedSharding),
    'shard_map' (explicit psum) and ZeRO (state sharded over 'data') modes,
    each against one card on the same global batch, float32 'highest'.

    shard_map normalises each card's share with that card's own batch
    statistics (local BN), so its one-card twin is the same global batch
    split into n microbatches (grad_accum=n): BN statistics per microbatch,
    summed gradients — the same computation on one card."""
    import jax

    from resnet_tpu.config import ParallelConfig

    base = _train_config(dataclasses.replace(
        sizes, model=sizes.dp_model or sizes.model, batch=sizes.dp_batch), "")
    base = dataclasses.replace(
        base,
        execution=dataclasses.replace(
            base.execution, compute_dtype="float32",
            matmul_precision="highest",
        ),
        parallel=ParallelConfig(num_devices=n),
    )
    m = base.model
    print(f"[four-cards] {m.name} widths, block_sizes {m.block_sizes}, "
          f"{m.input_dim}x{m.input_dim}, global batch {sizes.dp_batch} = "
          f"{sizes.dp_batch // n} per card, float32 'highest'")

    def one_step(cfg, use_mesh):
        trainer = _trainer(dataclasses.replace(cfg, checkpoint_dir=""),
                           use_mesh=use_mesh)
        m = trainer.run(1)
        n_sharded = sum(
            1 for a in jax.tree.leaves(trainer.state.params)
            if any(s is not None for s in a.sharding.spec)
        ) if use_mesh else 0
        del trainer
        return m, n_sharded

    ref, _ = one_step(base, False)
    ref_accum, _ = one_step(dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, grad_accum=n)),
        False)
    cases = [
        ("auto", dataclasses.replace(base), ref),
        ("shard_map", dataclasses.replace(
            base, parallel=dataclasses.replace(base.parallel,
                                               mode="shard_map")), ref_accum),
        ("zero", dataclasses.replace(
            base, parallel=dataclasses.replace(base.parallel,
                                               zero_sharding=True)), ref),
    ]
    for name, cfg, want in cases:
        got, n_sharded = one_step(cfg, True)
        dl = abs(got["loss"] - want["loss"]) / max(1.0, abs(want["loss"]))
        dg = abs(got["grad_norm"] - want["grad_norm"]) / max(
            1.0, abs(want["grad_norm"]))
        print(f"[four-cards] {name}: {n} cards loss {got['loss']:.6f} vs "
              f"1 card {want['loss']:.6f} (rel {dl:.2e}, tolerance "
              f"{DP_LOSS_RTOL:g}); grad_norm {got['grad_norm']:.6f} vs "
              f"{want['grad_norm']:.6f} (rel {dg:.2e}, tolerance "
              f"{DP_GNORM_RTOL:g}); {n_sharded} param leaves sharded")
        check(dl <= DP_LOSS_RTOL, f"{name}: loss off one card by {dl:.2e}")
        check(dg <= DP_GNORM_RTOL, f"{name}: grad norm off by {dg:.2e}")
        if name == "zero":
            check(n_sharded > 0, "ZeRO sharded no param leaf")


# -------------------------------------------------------------------- main


def run(sizes: Sizes, four_cards: bool = False,
        require_gpu: bool = True) -> int:
    """Run the phases in order; returns the exit code. The result line is
    printed only when every phase passed."""
    import jax

    phase = "device"
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        card = phase_device(4 if four_cards else 1, require_gpu)
        if four_cards:
            phase = "four-cards"
            phase_four_cards(sizes)
        else:
            phase = "reference"
            phase_reference(sizes)
            phase = "train"
            cfg, trainer = phase_train(sizes, os.path.join(work, "dumps"),
                                       card)
            phase = "checkpoint"
            trainer = phase_checkpoint(cfg, trainer)
            phase = "eval"
            phase_eval(sizes, trainer)
            state = jax.device_get(trainer.state)
            del trainer
            phase = "int8"
            phase_int8(sizes, state)
            phase = "export"
            phase_export(sizes, cfg, state, work)
    except Exception:
        traceback.print_exc()
        print(f"[{phase}] FAILED", file=sys.stderr)
        print(f"[{phase}] FAILED")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"all phases passed on {card}")
    print(result_line(jax.devices()))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU data-parallel comparison")
    args = ap.parse_args(argv)
    return run(Sizes.full(), four_cards=args.four_cards)


if __name__ == "__main__":
    sys.exit(main())
