#!/usr/bin/env python3
"""The chunk program on the card without the rest of chip_smoke.py: its
phase 9 after the references it compares with.

Builds the kernels, renders the closed loop of tests/test_rendered_e2e.py
(145 frames, 480x640) on the card, runs it through ``adapt_stereo ->
GraphSLAM.process`` (phase 5's per-frame reference; a second pass gives
its ms/frame) and through the speculative queue at depth 8 (phase 7's
ms/frame), then chip_smoke.py's phase 9: the loop through
``process_sequence`` at chunk_size 16 (gate, equal to the per-frame run,
launches against the prediction and torch.profiler, the CUDA graphs'
capture, instantiation and nodes, packet reads, ms/frame), the chunk
graph and the split branch against their eager runs, the measurement
streams, and the loop as RGB-D.  Needs one CUDA card; exits non-zero on
any failure.

    python3 scripts/chunk_graphs_torch.py
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
    slam, rows = cs.run_slam(frames, scam, dev, adapt_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.run_slam(frames, scam, dev, adapt_cfg)
    ref_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    config = dataclasses.replace(cs.slam_config(), speculation_depth=cs.SEQ_DEPTH,
                                 chunk_size=cs.SEQ_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.run_speculative(frames, scam, dev, adapt_cfg, config)
    seq_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    print(f"per-frame GraphSLAM ms/frame {ref_ms:.3f}, speculative queue {seq_ms:.3f} "
          f"(second passes) [{smi}]", flush=True)
    t0 = time.perf_counter()
    cs.phase_chunk(dev, smi, loop, slam, rows, ref_ms, seq_ms, adapt_cfg)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    print("chunk program: every check passed", flush=True)


if __name__ == "__main__":
    main()
