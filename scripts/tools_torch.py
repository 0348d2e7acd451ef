#!/usr/bin/env python3
"""The repo's examples and tools on the card without the rest of
chip_smoke.py: its phase 11.

Builds the kernels, then runs chip_smoke.py's phase 11: rendered_e2e_torch's
253-frame loop (counts and verdict as the JAX script's CPU run), then,
beside two child processes running the CPU twins, the seven didactic
examples on the card against their ``--device cpu`` runs with each one's
launches against its prediction, and export_viewer; the three smoke
scripts (PASS); the loop's first 40 frames against the CPU;
ab_local_ba_torch, ab_seeded_detection_torch, ab_motion_envelopes_torch
--fast and diag_rendered_torch's part 1 against the JAX scripts' recorded
output, the kernels at their inputs against their plain versions, and the
A/B loops' first frames on the CPU's renders against the CPU.  Needs one
CUDA card; exits non-zero on any failure.

    python3 scripts/tools_torch.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from srrg2_proslam_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    report = {k: {"max_abs_err": 0.0} for k in ("fast", "brief", "gn_burst")}
    examples, tools = cs.phase_tools(torch.device("cuda:0"), smi, report)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print(json.dumps({"launches_examples": examples, "launches_tools": tools,
                      "max_abs_err": report}), flush=True)
    print("examples and tools: every check passed", flush=True)


if __name__ == "__main__":
    main()
