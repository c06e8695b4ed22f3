"""bench.py measures a GPU or nothing: on the CPU it exits non-zero unless
asked for a rehearsal, and a rehearsal names its device and reports no
times."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "bench.py", *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_bench_refuses_cpu():
    p = _bench("--batch-size", "2")
    assert p.returncode != 0
    assert "measures a GPU" in p.stderr
    assert p.stdout.strip() == ""


def test_bench_cpu_rehearsal_reports_no_times():
    p = _bench("--cpu-rehearsal", "--model", "resnet18", "--batch-size", "2",
               "--image-dim", "32", "--steps", "2", "--warmup", "1",
               "--grad-accum", "1", "--no-dual")
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["platform"] == "cpu" and line["device_count"] >= 1
    assert line["device_kind"]
    assert line["rehearsal"] is True
    assert line["value"] is None and line["step_ms"] is None
    assert (line["batch"], line["image_dim"]) == (2, 32)
