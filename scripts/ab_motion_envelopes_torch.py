#!/usr/bin/env python3
"""A/B of the PyTorch port: the estimator arsenal on the documented
motion-envelope failures, the twin of scripts/ab_motion_envelopes.py.

Three regimes fail at the shipped defaults — 15 deg/frame turns do not
close, 0.5 m/frame steps and 14 x 8 m circuits exceed the 0.30 m KITTI
gate.  Every combination of mean-disparity inverse-depth weighting and the
pose-based smoother runs on every regime (rendered loops at 320x416,
sub-pixel disparity refinement on, GraphSLAM per frame) and prints its
t-RMSE, rotation error, closures, relocalizations, backstop rejections and
verdict.  Same flags and printed lines as the JAX script, plus
``--device`` (default ``cuda``).

    python3 scripts/ab_motion_envelopes_torch.py [--fast] [--device cuda|cpu]

``--fast`` runs the first regime only (4 x 119 frames).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as syn  # noqa: E402
from srrg2_proslam_tpu_torch.metrics import trajectory as tm  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.models.slam import (  # noqa: E402
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig  # noqa: E402

SCENARIOS = {
    # 15 deg/frame turns (turn_frames=6): closure recall failure
    "turn15deg": dict(side_a=10.0, side_b=6.0, step_m=0.45, turn_frames=6),
    # 0.5 m/frame forward speed: forward-axis RMSE past the 0.30 m gate
    "step0.5m": dict(side_a=10.0, side_b=6.0, step_m=0.5, turn_frames=8),
    # 14x8 m circuit: accumulated drift past the gate
    "circuit14x8": dict(side_a=14.0, side_b=8.0, step_m=0.45, turn_frames=8),
}

VARIANTS = {
    "baseline": dict(),
    "idw": dict(stereo_inverse_depth_weighting=True),
    "smoother": dict(landmark_estimator="smoother"),
    "idw+smoother": dict(stereo_inverse_depth_weighting=True,
                         landmark_estimator="smoother"),
}


def run(scn: dict, tweaks: dict, device=torch.device("cuda")):
    """One regime under one variant -> (TrajectoryError, GraphSLAM)."""
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    planes = syn.make_room(size_x=max(20.0, scn["side_a"] + 6.0),
                           size_z=max(26.0, scn["side_b"] + 18.0), device=device)
    poses = syn.loop_trajectory(**scn)
    config = GraphSLAMConfig(
        tracker=TrackerConfig(**tweaks),
        splitting=SplittingConfig(maximum_translation_m=3.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        arena_capacity=4096,
        database_capacity=8192,
        max_db_descriptors_per_map=256,
    )
    slam = GraphSLAM(cam, config, model="stereo", device=device)
    # the aggressive-motion regime runs the sub-pixel dial on (the
    # fast-rotation scenario's shipped posture)
    acfg = StereoAdaptorConfig(subpixel_refinement=True)
    gt = []
    for i, T_wc in enumerate(poses):
        left, right, _ = syn.render_stereo(cam, torch.as_tensor(T_wc, device=device), planes)
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
        gt.append(np.linalg.inv(T_wc).astype(np.float32))
    slam.flush()
    err = tm.evaluate(slam.trajectory(), gt)
    return err, slam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="first regime only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = {}
    for sname, scn in SCENARIOS.items():
        for vname, tweaks in VARIANTS.items():
            err, slam = run(scn, tweaks, device)
            results[sname, vname] = (err, slam)
            rmse = np.asarray(err.mean_translation_rmse)
            ok = (np.all(rmse <= 0.30) and err.mean_rotation_deg <= 3.0
                  and slam.num_closures >= 1)
            print(f"{sname:12s} {vname:13s}: t-RMSE {np.round(rmse, 3)} m "
                  f"rot {err.mean_rotation_deg:5.2f} deg  "
                  f"closures {slam.num_closures} relocs "
                  f"{slam.num_relocalizations} rej "
                  f"{slam.num_backstop_rejections} -> "
                  f"{'PASS' if ok else 'fail'}", flush=True)
        if args.fast:
            break
    return results


if __name__ == "__main__":
    main()
