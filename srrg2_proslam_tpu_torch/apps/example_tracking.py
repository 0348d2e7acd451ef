"""Didactic example: frame-to-frame stereo tracking on the bundled frames.

The port's twin of apps/example_tracking.py (the reference's
example_stereo_projective_tracking): walk a short stereo sequence, print
every pipeline stage per frame — measurements, projective matches,
Gauss-Newton inliers/chi, merges/additions, the matcher's search stage,
and the evolving pose — so a new user can watch the tracker work.  Same
flags and printed lines as the JAX app, plus ``--device`` (default
``cuda``: FAST, BRIEF and the GN burst run as the hand-written kernels;
``cpu`` runs their plain versions).

    python -m srrg2_proslam_tpu_torch.apps.example_tracking \\
        [--sequence kitti_dir] [--count N] [--device cuda|cpu]
"""
import argparse
import os

import torch

from ..io import datasets
from ..models.frontend import StereoAdaptorConfig, adapt_stereo
from ..models.tracker import TrackerConfig, initial_state, track_step

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "test_data")

# TrackStats.host_packet: [num_inliers, trans_in_map, rot_in_map, num_matches,
# num_merges, num_additions, chi_per_inlier, matcher_stage, T_lm_robot[:3, :]]
PACKET_INLIERS, PACKET_MATCHES, PACKET_MERGES, PACKET_ADDS = 0, 3, 4, 5
PACKET_CHI, PACKET_STAGE, PACKET_T = 6, 7, 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", default=None,
                    help="KITTI odometry folder (default: bundled frames)")
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.sequence:
        frames = list(datasets.iter_kitti_odometry(args.sequence, count=args.count))
    else:
        frames = list(datasets.iter_bundled_kitti(ROOT, "city"))
    cam = datasets.kitti_camera(*frames[0].left.shape)
    acfg = StereoAdaptorConfig()
    tcfg = TrackerConfig()
    state = initial_state(4096, device=device)

    print(f"{len(frames)} frames, camera fx={cam.fx:.1f} "
          f"baseline={cam.baseline_px / cam.fx:.3f} m")
    print(f"{'frame':>5} {'meas':>5} {'match':>6} {'inl':>5} {'chi/inl':>8} "
          f"{'merge':>6} {'add':>5} {'stage':>5} {'map':>5}  pose t [m]")
    for i, fr in enumerate(frames):
        meas = adapt_stereo(torch.as_tensor(fr.left, device=device),
                            torch.as_tensor(fr.right, device=device), acfg)
        state, stats, _ = track_step(state, meas.points, meas.desc, meas.valid,
                                     cam, tcfg, "stereo")
        pkt = stats.host_packet.cpu().numpy()   # [20]: 8 scalars + T[:3, :]
        t = pkt[PACKET_T + 3], pkt[PACKET_T + 7], pkt[PACKET_T + 11]  # rows 0..2, col 3
        print(f"{i:5d} {int(stats.num_measurements):5d} "
              f"{int(pkt[PACKET_MATCHES]):6d} {int(pkt[PACKET_INLIERS]):5d} "
              f"{pkt[PACKET_CHI]:8.2f} {int(pkt[PACKET_MERGES]):6d} "
              f"{int(pkt[PACKET_ADDS]):5d} {int(pkt[PACKET_STAGE]):5d} "
              f"{int(state.arena.count):5d}  [{t[0]:7.3f} {t[1]:7.3f} {t[2]:7.3f}]")


if __name__ == "__main__":
    main()
