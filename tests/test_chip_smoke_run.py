"""chip_smoke.py end to end on the CPU at a tiny size: every phase runs and
the result line comes last; a failure in any phase gives a non-zero exit
and no result line; the four-card comparison holds on a virtual CPU mesh.
(The script itself refuses the CPU; these tests call its phase runner with
the GPU requirement lifted.)"""

import json

import jax
import pytest

import chip_smoke as cs
from resnet_tpu.config import tiny_model_config

TINY = cs.Sizes(model=tiny_model_config(), batch=8, int8_batch=16,
                export_batch=4, timed_steps=3, dp_batch=8)

PHASES = ["phase_reference", "phase_train", "phase_checkpoint", "phase_eval",
          "phase_int8", "phase_export"]


def test_all_phases_pass_and_result_line_is_last(capsys):
    assert cs.run(TINY, require_gpu=False) == 0
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True,
        "device": {"platform": "cpu", "kind": "cpu",
                   "count": len(jax.devices())},
    }
    for tag in ("[reference]", "[train]", "[checkpoint]", "[eval]",
                "[int8]", "[export]"):
        assert tag in out


@pytest.mark.parametrize("phase", PHASES)
def test_failing_phase_exits_nonzero(monkeypatch, capsys, phase):
    def boom(*a, **k):
        raise cs.PhaseError(f"{phase} broke")

    monkeypatch.setattr(cs, phase, boom)
    assert cs.run(TINY, require_gpu=False) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "FAILED" in out.strip().splitlines()[-1]


def test_four_cards_on_virtual_cpu_mesh(capsys):
    """auto, shard_map (vs grad_accum=4 on one device) and ZeRO each match
    one device on loss and grad norm — 4 of the suite's 8 CPU devices."""
    cs.phase_four_cards(TINY, n=4)
    out = capsys.readouterr().out
    for mode in ("auto", "shard_map", "zero"):
        assert f"[four-cards] {mode}:" in out
