#!/usr/bin/env python3
"""The multi-GPU slice on the card without the rest of chip_smoke.py: its
phase 10 after the references it compares with.

Builds the kernels, renders the closed loop of tests/test_rendered_e2e.py
(145 frames, 480x640) on the card, runs it through ``adapt_stereo ->
GraphSLAM.process`` (phase 5's per-frame reference) and through
``process_sequence`` at chunk_size 16 (phase 9a's reference), a second
pass of each giving its ms/frame, then chip_smoke.py's phase 10: the dry
runs at 1 rank (NCCL) and 2 ranks sharing the card (gloo), and the loop
through ``GraphSLAM(mesh=...)`` at world size 2, chunked and per frame,
against the references.  Needs one CUDA card; exits non-zero on any
failure.

    python3 scripts/mesh_torch.py
"""
import dataclasses
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
    from srrg2_proslam_tpu_torch.io import synthetic
    from srrg2_proslam_tpu_torch.kernels import _build
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s", flush=True)
    adapt_cfg = StereoAdaptorConfig()
    scam = synthetic.synthetic_camera()
    loop = list(synthetic.iter_rendered_loop(side_a=10.0, side_b=6.0, step_m=0.4,
                                             turn_frames=10, device=dev))
    frames = [((f.left, f.right), f.timestamp) for f in loop]
    n = len(frames)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) / n * 1e3

    slam, rows = cs.run_slam(frames, scam, dev, adapt_cfg)
    ref_ms = timed(lambda: cs.run_slam(frames, scam, dev, adapt_cfg))
    config = dataclasses.replace(cs.slam_config(), speculation_depth=cs.SEQ_DEPTH,
                                 chunk_size=cs.SEQ_CHUNK)
    cslam, crows = cs.run_sequence(frames, scam, dev, adapt_cfg, config)
    chunk_ms = timed(lambda: cs.run_sequence(frames, scam, dev, adapt_cfg, config))
    print(f"per-frame GraphSLAM ms/frame {ref_ms:.3f}, chunk program {chunk_ms:.3f} "
          f"(second passes) [{smi}]", flush=True)
    t0 = time.perf_counter()
    cs.phase_mesh(dev, smi, loop, slam, rows, ref_ms, (cslam, crows, chunk_ms))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print("multi-GPU slice: every check passed", flush=True)


if __name__ == "__main__":
    main()
