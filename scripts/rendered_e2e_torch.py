#!/usr/bin/env python3
"""End-to-end SLAM of the PyTorch port on the rendered closed-loop
sequence, the twin of scripts/rendered_e2e.py.

Drives the full pipeline — frontend, epipolar matching, tracker, splits,
loop closure, relocalization, PGO — over rendered stereo images against
exact ground truth, and reports per-axis RMSE and closure statistics.  The
default loop is 253 frames at 480x640 (20 x 10 m at 0.35 m steps) with
splits at 5 m / 0.35 rad and a 16384-row ring of 512 rows per map.  Same
flags, printed lines and verdict as the JAX script, plus ``--device``
(default ``cuda``).  The ``adapt=`` and ``track=`` timers each end in a
synchronize of the card, so they count the device work queued inside.

    python3 scripts/rendered_e2e_torch.py [--frames N] [--idw] [--prior INFO] \\
        [--local-ba] [--open-loop] [--side-a M --side-b M --step M \\
        --turn-frames N] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

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
from srrg2_proslam_tpu_torch.utils.profiling import sync  # noqa: E402
from srrg2_proslam_tpu_torch.utils import config as cfg  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--idw", action="store_true",
                    help="enable stereo inverse-depth weighting")
    ap.add_argument("--prior", type=float, default=0.0,
                    help="motion-prior info (m^-2 / rad^-2)")
    ap.add_argument("--local-ba", action="store_true")
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--side-a", type=float, default=20.0)
    ap.add_argument("--side-b", type=float, default=10.0)
    ap.add_argument("--step", type=float, default=0.35)
    ap.add_argument("--turn-frames", type=int, default=14)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    config = GraphSLAMConfig(
        tracker=TrackerConfig(
            stereo_inverse_depth_weighting=args.idw,
            motion_prior_translation_info=args.prior,
            motion_prior_rotation_info=args.prior,
        ),
        splitting=SplittingConfig(maximum_translation_m=5.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096,
        database_capacity=16384,
        max_db_descriptors_per_map=512,
        enable_loop_closing=not args.open_loop,
    )
    if args.local_ba:
        config = cfg.replace(config, local_ba=cfg.replace(config.local_ba, enabled=True))

    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo", device=device)
    acfg = StereoAdaptorConfig()

    gt = []
    t_adapt = t_track = 0.0
    n = 0
    t_start = time.perf_counter()
    for fr in syn.iter_rendered_loop(count=args.frames, side_a=args.side_a,
                                     side_b=args.side_b, step_m=args.step,
                                     turn_frames=args.turn_frames, device=device):
        sync(device)
        t0 = time.perf_counter()
        meas = adapt_stereo(fr.left, fr.right, acfg)
        sync(device)
        t1 = time.perf_counter()
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        sync(device)
        t2 = time.perf_counter()
        t_adapt += t1 - t0
        t_track += t2 - t1
        gt.append(fr.gt_pose)
        n += 1
        if n % 50 == 0:
            T = slam.robot_in_world()
            e = np.linalg.norm(T[:3, 3] - fr.gt_pose[:3, 3])
            print(f"frame {n}: maps={slam.num_maps} closures="
                  f"{slam.num_closures} reloc={slam.num_relocalizations} "
                  f"inliers={int(slam.last_stats.num_inliers)} "
                  f"pos_err={e:.3f}m", flush=True)

    wall = time.perf_counter() - t_start
    traj = slam.trajectory()
    err = tm.evaluate(traj, gt)
    final_err = np.linalg.norm(traj[-1][:3, 3] - gt[-1][:3, 3])
    print(f"\nframes={n} wall={wall:.1f}s adapt={t_adapt:.1f}s "
          f"track={t_track:.1f}s hz={n / (t_adapt + t_track):.2f}")
    print(f"maps={slam.num_maps} closures={slam.num_closures} "
          f"relocalizations={slam.num_relocalizations} "
          f"evictions={slam.num_db_evictions}")
    print(f"mean_t_rmse={np.asarray(err.mean_translation_rmse).round(3)} "
          f"std_t_rmse={np.asarray(err.std_translation_rmse).round(3)} "
          f"rot_deg={err.mean_rotation_deg:.2f} ate={err.ate_rmse:.3f} "
          f"final_err={final_err:.3f}")
    gates_ok = bool(np.all(np.asarray(err.mean_translation_rmse) <= 0.30)
                    and err.mean_rotation_deg <= 3.0)
    print(f"KITTI-gates: {'PASS' if gates_ok else 'FAIL'}")
    return slam, err


if __name__ == "__main__":
    main()
