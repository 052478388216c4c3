"""Grown-catalog first-refresh benchmark -> merges refresh_grown_first_s
into .cache/serve.json (catalog growth, cold jit-cache process, warm disk
cache; the reference's inductive update takes 3.4 s).

This script never touches JAX itself: each phase (tools/serve_grown_phase.py)
runs in its own subprocess, strictly one after the other, so the warm
phase's in-process jit caches cannot leak into the measurement and only one
process holds the card at a time.

Run: python tools/bench_serve_grown.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".cache", "serve.json")


def _run_phase(phase: str) -> dict:
    backend = sys.argv[1] if len(sys.argv) > 1 else "sparse"
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "serve_grown_phase.py"),
         phase, backend],
        capture_output=True, text=True, timeout=3600,
    )
    sys.stderr.write(p.stderr[-4000:])
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines:
        raise RuntimeError(
            f"phase {phase} failed rc={p.returncode}: {p.stdout[-2000:]}"
        )
    res = json.loads(lines[-1])
    print(f"# {phase}: {res}", flush=True)
    return res


def main():
    warm = _run_phase("warm")
    measure = _run_phase("measure")

    serve = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            serve = json.load(f)
    serve["refresh_grown_first_s"] = measure["refresh_grown_s"]
    serve["refresh_grown_warm_process_s"] = warm["refresh_grown_s"]
    serve["grown_probe"] = {
        "reduced_bucket": measure["reduced_bucket"],
        "grown_bucket": measure["grown_bucket"],
        "measure_prepare_s": measure["prepare_s"],
        "note": (
            "refresh_grown_first_s = first inductive refresh onto a GROWN "
            "catalog in a COLD process (in-process jit caches empty, "
            "persistent compilation cache warm on disk), catalog shapes "
            "bucketed (data/padded.py). Reference inductive update: 3.4 s."
        ),
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(serve, f, indent=1)
    print(json.dumps({"refresh_grown_first_s": serve["refresh_grown_first_s"],
                      "vs_reference_s": 3.4}), flush=True)
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
