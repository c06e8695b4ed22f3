"""Compare two activation/parameter dumps tensor-by-tensor.

The fidelity gate: fp32 batch-1 forward activations compared
against reference dumps. This tool diffs either two of our manifest-style
dumps (analysis/dump.py) or two reference-style buffer directories
(numbered %03d.buffer files, the dump_trainer schema resnet.cu:2279-2317),
reporting per-tensor max-abs / rel errors and an overall verdict.

Usage:
  python tools/compare_dumps.py A B [--atol 1e-5] [--rtol 1e-4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_any(path: str):
    """Load a dump dir: manifest-style or numbered-buffer style."""
    manifest = os.path.join(path, "manifest.json")
    out = {}
    if os.path.exists(manifest):
        with open(manifest) as f:
            meta = json.load(f)
        for name, m in meta.items():
            arr = np.fromfile(os.path.join(path, m["file"]), dtype=np.float32)
            out[name] = arr.reshape(m["shape"])
        return out
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".buffer"):
            out[fname[: -len(".buffer")]] = np.fromfile(
                os.path.join(path, fname), dtype=np.float32
            )
    if not out:
        raise SystemExit(f"no manifest.json or *.buffer files in {path}")
    return out


def compare(a, b, *, atol=1e-5, rtol=1e-4):
    rows, failures = [], 0
    common = sorted(set(a) & set(b))
    for name in common:
        x, y = a[name].ravel(), b[name].ravel()
        if x.shape != y.shape:
            rows.append((name, "SHAPE MISMATCH", f"{x.shape} vs {y.shape}"))
            failures += 1
            continue
        diff = np.abs(x - y)
        denom = np.maximum(np.abs(y), 1e-30)
        max_abs = float(diff.max()) if diff.size else 0.0
        max_rel = float((diff / denom).max()) if diff.size else 0.0
        ok = np.allclose(x, y, atol=atol, rtol=rtol)
        rows.append((name, "ok" if ok else "FAIL", f"abs {max_abs:.3e} rel {max_rel:.3e}"))
        failures += 0 if ok else 1
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    return rows, failures, only_a, only_b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dump_a")
    ap.add_argument("dump_b")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--rtol", type=float, default=1e-4)
    args = ap.parse_args(argv)
    a, b = load_any(args.dump_a), load_any(args.dump_b)
    rows, failures, only_a, only_b = compare(a, b, atol=args.atol, rtol=args.rtol)
    for name, status, detail in rows:
        print(f"{status:>5}  {name:50s} {detail}")
    for n in only_a:
        print(f"only in A: {n}")
    for n in only_b:
        print(f"only in B: {n}")
    print(f"\n{len(rows)} compared, {failures} failed, "
          f"{len(only_a)}+{len(only_b)} unmatched")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
