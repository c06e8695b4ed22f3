"""Post-hoc audit of a soak checkpoint directory.

`tools/soak.py` drives the live soak (launch -> kill -9 -> resume ->
audit) and emits its JSON verdict at the end — which means an outer
harness timeout that reaps soak.py loses the verdict even though every
piece of evidence (metrics.jsonl with per-step timestamps, the
checkpoint dumps, the stdout log) survives on disk. This tool re-runs
the same audit from the surviving directory so a truncated soak still
yields an artifact, honestly labeled as reconstructed.

Mirrors the audit section of tools/soak.py (reference analogue: the
in-anger resume evidence at /root/reference/resnet_cudnn.cu:3591 —
what matters is the dump integrity and the exact continuation, both of
which are on-disk facts).

Usage: python tools/soak_audit.py --dir soak_dir --out soak_audit.json
"""

import argparse
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def series(vals):
    if not vals:
        return None
    a = np.asarray(vals, float)
    k = max(1, len(a) // 10)
    return {
        "mean": round(float(a.mean()), 1),
        "min": round(float(a.min()), 1),
        "max": round(float(a.max()), 1),
        "first_decile_mean": round(float(a[:k].mean()), 1),
        "last_decile_mean": round(float(a[-k:].mean()), 1),
        "n": len(a),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--note", default="")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from resnet_tpu.train.checkpoint import (
        dump_id_dir,
        parse_trainer_checkpoint,
    )

    jsonl = os.path.join(args.dir, "metrics.jsonl")
    recs = [json.loads(l) for l in open(jsonl)]
    ips = [r["images_per_sec"] for r in recs if r.get("images_per_sec")]
    steps_logged = [r["step"] for r in recs]
    ts = [r["ts"] for r in recs if "ts" in r]

    # resume continuity: the metrics log is append-mode across both runs,
    # so run 2's first record is where the step sequence goes backwards
    # (the dump is taken BEFORE the update at that step).
    split = None
    for i in range(1, len(steps_logged)):
        if steps_logged[i] <= steps_logged[i - 1]:
            split = i
            break
    resume_first_step = steps_logged[split] if split is not None else None
    latest_at_kill = steps_logged[split - 1] if split is not None else None

    dumps = sorted(
        int(d) for d in os.listdir(args.dir) if re.fullmatch(r"\d{8}", d)
    )
    complete = {}
    for d in dumps:
        try:
            meta = parse_trainer_checkpoint(
                os.path.join(dump_id_dir(args.dir, d),
                             "trainer_checkpoint.txt"))
            complete[d] = bool(meta)
        except Exception:
            complete[d] = False
    partials = [d for d in os.listdir(args.dir)
                if d.startswith(".") or ".tmp" in d]

    resumed_from = max((d for d in dumps if d <= (resume_first_step or 0)),
                       default=None)
    out = {
        "reconstructed": True,
        "note": args.note,
        "source_dir": args.dir,
        "wall_seconds": round(ts[-1] - ts[0], 1) if len(ts) > 1 else None,
        "steps_logged": len(steps_logged),
        "final_step": steps_logged[-1] if steps_logged else None,
        "throughput_img_s": series(ips),
        "rss_mb_run1": None,   # live monitor was reaped with soak.py
        "rss_mb_run2": None,
        "checkpoints": {
            "ids": dumps,
            "all_complete": all(complete.values()),
            "incomplete": [d for d, ok in complete.items() if not ok],
            "partial_artifacts_left": partials,
        },
        "resume": {
            "latest_at_kill": resumed_from,
            "run2_first_logged_step": resume_first_step,
            "exact_continuation": resume_first_step == resumed_from,
        },
    }
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({
        "soak_audit": "done",
        "wall_s": out["wall_seconds"],
        "final_step": out["final_step"],
        "throughput": out["throughput_img_s"],
        "resume_exact": out["resume"]["exact_continuation"],
        "ckpts_complete": out["checkpoints"]["all_complete"],
    }))


if __name__ == "__main__":
    main()
