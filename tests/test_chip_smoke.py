"""chip_smoke.py's own logic on the CPU: it refuses a non-GPU device with a
non-zero exit and no result line, the exact form of that line, the
nvidia-smi parser, and a non-zero exit when any phase fails."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_line(text):
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def test_refuses_cpu_in_process(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "[device] FAILED" in out


def test_refuses_cpu_as_a_script():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "not a GPU" in p.stderr


def test_fails_alone_without_the_repo(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot import the package and exits non-zero, printing no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_result_line_exact_form():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    four = json.loads(cs.result_line([dev] * 4))
    assert four["device"]["count"] == 4


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 400.00 W",
     [("NVIDIA H100 80GB HBM3", "400.00 W")]),
    ("NVIDIA H100, PCIe, 350.00 W\n",  # a comma inside the name
     [("NVIDIA H100, PCIe", "350.00 W")]),
    ("A, 700.00 W\nB, 700.00 W\n\nC, 650.00 W\nD, [N/A]\n",
     [("A", "700.00 W"), ("B", "700.00 W"), ("C", "650.00 W"),
      ("D", "[N/A]")]),
])
def test_parse_smi(text, want):
    assert cs.parse_smi(text) == want


@pytest.mark.parametrize("text", ["", "\n\n", "no comma here", ", 700 W"])
def test_parse_smi_rejects(text):
    with pytest.raises(ValueError):
        cs.parse_smi(text)


def test_cudnn_conv_operand_types_reads_compiled_hlo():
    """The int8 phase's evidence that cuDNN runs the convs on s8 operands:
    operands print by name, so their types come from their definitions."""
    hlo = "\n".join([
        "ENTRY %main.1 (x.1: s8[64,56,56,4], w.1: s8[7,7,4,64]) -> f32[1] {",
        "  %w.1 = s8[7,7,4,64]{3,2,1,0} parameter(1), metadata={op_name=\"w\"}",
        "  %x.1 = s8[64,56,56,4]{3,2,1,0} parameter(0)",
        "  %wrapped_transpose = s8[64,7,7,4]{3,2,1,0} fusion(%w.1), kind=kCustom",
        "  %loop_pad_fusion = s8[64,61,61,4]{3,2,1,0} fusion(%x.1), kind=kLoop",
        "  %cudnn-conv.4 = (f32[64,28,28,64]{3,2,1,0}, u8[0]{0}) custom-call("
        "%loop_pad_fusion, %wrapped_transpose), window={size=7x7 stride=2x2}, "
        "custom_call_target=\"__cudnn$convForward\"",
        "  %c2 = f32[64,61,61,4]{3,2,1,0} parameter(2)",
        "  %cudnn-conv.5 = (f32[64,28,28,64]{3,2,1,0}, u8[0]{0}) custom-call("
        "f32[64,61,61,4]{3,2,1,0} %c2, %wrapped_transpose), "
        "custom_call_target=\"__cudnn$convForward\"",
        "}",
    ])
    assert cs.cudnn_conv_operand_types(hlo) == [("s8", "s8"), ("f32", "s8")]
    assert cs.cudnn_conv_operand_types("ENTRY %m { ROOT %p = f32[] parameter(0) }") == []
