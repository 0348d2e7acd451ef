#!/usr/bin/env python3
"""Smoke test of the PyTorch port: 5-frame open-loop VO on the bundled
KITTI city frames, the twin of scripts/smoke_vo.py.

Mirrors the reference integration test (tests/test_trackers.cpp:327-365):
the final pose error against ground truth must be within (0.2, 0.2, 0.7) m
and 0.01 rad.  Same printed lines and verdict as the JAX script, plus
``--device`` (default ``cuda``: FAST, BRIEF and the GN burst run as the
hand-written kernels; ``cpu`` runs their plain versions).

    python3 scripts/smoke_vo_torch.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.models.tracker import (  # noqa: E402
    TrackerConfig, initial_state, track_step,
)
from srrg2_proslam_tpu_torch.ops import se3  # noqa: E402

GATE_T = np.array([0.2, 0.2, 0.7])   # m
GATE_ANGLE = 0.01                     # rad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    frames = list(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    print(f"{len(frames)} frames, image {frames[0].left.shape}, cam {cam}")

    adaptor_cfg = StereoAdaptorConfig()
    tracker_cfg = TrackerConfig()
    state = initial_state(capacity=4096, device=device)

    poses = []
    t0 = time.time()
    for i, fr in enumerate(frames):
        meas = adapt_stereo(torch.as_tensor(fr.left, device=device),
                            torch.as_tensor(fr.right, device=device), adaptor_cfg)
        state, stats, X = track_step(state, meas.points, meas.desc, meas.valid, cam,
                                     tracker_cfg, "stereo")
        pose = state.T_lm_robot.cpu().numpy()
        poses.append(pose)
        print(
            f"frame {i}: meas={int(stats.num_measurements)} "
            f"matches={int(stats.num_matches)} inliers={int(stats.num_inliers)} "
            f"chi/inl={float(stats.chi_per_inlier):.2f} "
            f"merges={int(stats.num_merges)} adds={int(stats.num_additions)} "
            f"stage={int(stats.matcher_stage)} map={int(state.arena.count)} "
            f"t={pose[:3,3].round(3)}"
        )
    dt = time.time() - t0
    print(f"wall: {dt:.2f}s ({len(frames)/dt:.2f} fps incl. compile)")

    gt_final = frames[-1].gt_pose
    t_err, angle = se3.error_t_and_angle(torch.as_tensor(poses[-1]), torch.as_tensor(gt_final))
    print("GT final t:", gt_final[:3, 3].round(3))
    print("per-axis |t err|:", t_err.numpy().round(4), "angle:", float(angle))
    ok = np.all(t_err.numpy() <= GATE_T) and float(angle) <= GATE_ANGLE
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
