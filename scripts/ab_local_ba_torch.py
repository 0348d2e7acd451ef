#!/usr/bin/env python3
"""A/B of the PyTorch port: split-time local bundle adjustment on the
rendered benchmark, the twin of scripts/ab_local_ba.py.

Two runs of the rendered 8 x 6 m closed loop (127 frames at 320x416, full
pipeline, per-frame mode, splits at 3 m / 0.35 rad, a 42-slot ring of 384
rows per map), local BA off and on; each prints its per-axis t-RMSE,
rotation error, ATE and its map, closure and backstop-rejection counts.
Same printed lines as the JAX script, plus ``--device`` (default
``cuda``).

    python3 scripts/ab_local_ba_torch.py [--device cuda|cpu]
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
    GraphSLAM, GraphSLAMConfig, LocalBAConfig, SplittingConfig,
)
from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig  # noqa: E402


def run(local_ba: bool, device=torch.device("cuda")):
    """The loop with local BA off or on -> (TrajectoryError, GraphSLAM)."""
    config = GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=3.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        local_ba=LocalBAConfig(enabled=local_ba),
        arena_capacity=4096,
        # 42 ring slots: the lap finishes ~25 maps and the loop must still
        # close against the first ones
        database_capacity=16384,
        max_db_descriptors_per_map=384,
    )
    cam = syn.synthetic_camera(rows=320, cols=416, fx=300.0)
    slam = GraphSLAM(cam, config, model="stereo", device=device)
    acfg = StereoAdaptorConfig()
    gt = []
    for fr in syn.iter_rendered_loop(side_a=8.0, side_b=6.0, step_m=0.4, turn_frames=8,
                                     rows=320, cols=416, fx=300.0, device=device):
        meas = adapt_stereo(fr.left, fr.right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        gt.append(fr.gt_pose)
    slam.flush()
    err = tm.evaluate(slam.trajectory(), gt)
    return err, slam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    results = {}
    for enabled in (False, True):
        err, slam = run(enabled, device)
        results[enabled] = (err, slam)
        rmse = np.asarray(err.mean_translation_rmse)
        print(f"local_ba={str(enabled):5s}: per-axis t-RMSE "
              f"{np.round(rmse, 4)} m, rot {err.mean_rotation_deg:.3f} deg, "
              f"ATE {err.ate_rmse:.4f} m "
              f"({slam.num_maps} maps, {slam.num_closures} closures, "
              f"{slam.num_backstop_rejections} backstop-rej)",
              flush=True)
    return results


if __name__ == "__main__":
    main()
