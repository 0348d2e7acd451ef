"""Headless SLAM benchmark app: the port's twin of apps/app_benchmark.py.

Same flags, same regression gates, same final JSON line and exit code as
the JAX app, plus ``--device`` (default ``cuda``; ``--device cpu`` runs
the kernels' plain versions on the CPU).  Frames come from a dataset
folder, a BOSS log, the rendered closed loop (``synthetic``) or, with no
``--sequence``, the bundled 5-frame KITTI sequence; they go through
``adapt_stereo`` / ``adapt_rgbd`` and ``GraphSLAM.process`` one by one, or
with ``--chunked B`` through ``GraphSLAM.process_sequence`` in chunks of
B (the chunk program, models/chunk.py).  ``mean_frame_hz`` is frames over the summed compute time: each timed
window (a frame's upload, adaptor and SLAM step; with ``--chunked`` the
whole ``process_sequence`` call) ends in a synchronize of the card, so
the device work queued inside it is counted.

    python -m srrg2_proslam_tpu_torch.apps.app_benchmark --dataset kitti \\
        --sequence <dir> [--gt <poses.txt>] [--count N] [--config <config.json>] \\
        [--output traj] [--open-loop] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..io import datasets
from ..metrics import trajectory as traj_metrics
from ..models.frontend import DepthAdaptorConfig, StereoAdaptorConfig, adapt_rgbd, adapt_stereo
from ..models.slam import GraphSLAM, GraphSLAMConfig
from ..utils import config as cfg
from ..utils import profiling

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

# the reference's CI regression thresholds (benchmarks/benchmark_*.cpp:17-21);
# "synthetic" is the rendered closed loop (io/synthetic.py) at KITTI's
REGRESSION_GATES = {
    "kitti": dict(max_mean_t=0.30, max_std_t=1.00),
    "icl": dict(max_mean_t=0.02, max_std_t=0.10),
    "tum": dict(max_mean_t=0.05, max_std_t=0.25),
    "euroc": dict(max_mean_t=0.50, max_std_t=0.50),
    "malaga": dict(max_mean_t=25.0, max_std_t=10.0),
    "synthetic": dict(max_mean_t=0.30, max_std_t=1.00),
    "boss": dict(max_mean_t=0.30, max_std_t=1.00),        # converted KITTI-class
    "boss-rgbd": dict(max_mean_t=0.05, max_std_t=0.25),   # converted TUM-class
}

CAMERAS = {
    "kitti": datasets.kitti_camera,
    "icl": datasets.icl_camera,
    "tum": datasets.tum_camera,
    "euroc": datasets.euroc_camera,
    "malaga": datasets.malaga_camera,
}


def iter_frames(args, device):
    if args.dataset == "synthetic":
        from ..io import synthetic as syn

        yield from syn.iter_rendered_loop(count=args.count, device=device)
    elif args.sequence is None:
        yield from datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city")
    elif args.dataset == "kitti":
        yield from datasets.iter_kitti_odometry(args.sequence, args.gt, count=args.count)
    elif args.dataset in ("tum", "icl"):
        yield from datasets.iter_tum_rgbd(args.sequence, count=args.count)
    elif args.dataset == "euroc":
        yield from datasets.iter_euroc_stereo(args.sequence, count=args.count)
    elif args.dataset == "malaga":
        yield from datasets.iter_malaga_stereo(args.sequence, count=args.count)
    elif args.dataset == "boss":
        from ..io import boss

        yield from boss.iter_boss_stereo(args.sequence, count=args.count,
                                         left_topic=args.left_topic,
                                         right_topic=args.right_topic)
    elif args.dataset == "boss-rgbd":
        from ..io import boss

        yield from boss.iter_boss_rgbd(args.sequence, count=args.count,
                                       rgb_topic=args.left_topic, depth_topic=args.right_topic)
    else:
        raise SystemExit(f"unsupported dataset {args.dataset}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srrg2_proslam_tpu_torch.apps.app_benchmark")
    ap.add_argument("--dataset", default="kitti",
                    choices=sorted(CAMERAS) + ["synthetic", "boss", "boss-rgbd"])
    ap.add_argument("--sequence", default=None, help="dataset folder or BOSS log")
    ap.add_argument("--gt", default=None, help="ground-truth pose file")
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--config", default=None, help="pipeline config JSON (see configurations/)")
    ap.add_argument("--left-topic", default=None,
                    help="BOSS log left ImageMessage topic (overrides the left/right "
                         "substring heuristic)")
    ap.add_argument("--right-topic", default=None, help="BOSS log right ImageMessage topic")
    ap.add_argument("--adaptor-config", default=None,
                    help="adaptor config JSON (see configurations/)")
    ap.add_argument("--output", default=None, help="trajectory file prefix")
    ap.add_argument("--chunked", type=int, default=0, metavar="B",
                    help="process the sequence through GraphSLAM.process_sequence, "
                         "B frames per batched adaptor call")
    ap.add_argument("--open-loop", action="store_true",
                    help="disable loop closing (the reference's CI benchmark mode)")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage scoped timers (utils/profiling.py)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of the per-frame run into this dir")
    ap.add_argument("--viewer-port", type=int, default=None,
                    help="serve a live top-down map/trajectory view on this port "
                         "(viz.LiveViewer; 0 = any port)")
    ap.add_argument("--viewer-every", type=int, default=25,
                    help="refresh the live view every N frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' "
                         "plain versions)")
    return ap.parse_args(argv)


def _slam_config(args):
    slam_config = cfg.load(args.config) if args.config else GraphSLAMConfig()
    if args.open_loop:
        slam_config = cfg.replace(slam_config, enable_loop_closing=False)
    if args.dataset == "euroc" and args.sequence is not None:
        # the body-from-rectified-camera extrinsic feeds the tracker's
        # sensor offset (the reference's camera-info-driven initialization)
        from ..io.rectify import find_euroc_rectification

        rect = find_euroc_rectification(args.sequence)
        if rect is not None and rect.T_B_rect is not None:
            tracker = cfg.replace(slam_config.tracker, T_robot_sensor=tuple(
                np.asarray(rect.T_B_rect, np.float32).ravel().tolist()))
            slam_config = cfg.replace(slam_config, tracker=tracker)
    if args.chunked:
        slam_config = cfg.replace(slam_config, chunk_size=args.chunked)
    return slam_config


def _camera(args, first, rgbd: bool):
    image = first.intensity if rgbd else first.left
    if args.dataset in ("boss", "boss-rgbd"):
        from ..io import boss

        cam = boss.boss_camera(args.sequence)
        if cam is None:
            raise SystemExit("no CameraInfoMessage in the BOSS log")
        if cam.rows == 0:
            cam = cam._replace(rows=image.shape[0], cols=image.shape[1])
        return cam
    if rgbd:
        return CAMERAS[args.dataset]()
    if args.dataset == "synthetic":
        from ..io import synthetic as syn

        return syn.synthetic_camera(*image.shape)
    if args.dataset == "kitti":
        return datasets.kitti_camera(*image.shape)
    if args.dataset == "euroc" and args.sequence is not None:
        # iter_euroc_stereo rectifies: its frames go with the rectified pinhole
        return datasets.euroc_rectified_camera(args.sequence)
    return CAMERAS[args.dataset]()


def _stack(images, device):
    if torch.is_tensor(images[0]):
        return torch.stack([torch.as_tensor(x, device=device) for x in images])
    return np.stack(images)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    viewer = None
    if args.viewer_port is not None:
        from ..viz import LiveViewer

        viewer = LiveViewer(port=args.viewer_port)
    if args.profile:
        profiling.enable()
    try:
        _run(args, device, viewer)
    finally:
        if viewer is not None:
            viewer.close()
        if args.profile:
            profiling.enable(False)


def _run(args, device, viewer):
    rgbd = args.dataset in ("tum", "icl", "boss-rgbd")
    slam_config = _slam_config(args)
    frames = iter_frames(args, device)
    first = next(iter(frames))
    cam = _camera(args, first, rgbd)
    default_adaptor = DepthAdaptorConfig if rgbd else StereoAdaptorConfig
    adaptor = cfg.load(args.adaptor_config) if args.adaptor_config else default_adaptor()
    slam = GraphSLAM(cam, slam_config, model="rgbd" if rgbd else "stereo", device=device)

    if args.chunked:
        all_frames = [first] + list(frames)
        if rgbd:
            a = _stack([fr.intensity for fr in all_frames], device)
            b = _stack([fr.depth for fr in all_frames], device)
        else:
            a = _stack([fr.left for fr in all_frames], device)
            b = _stack([fr.right for fr in all_frames], device)
        gt_poses = [fr.gt_pose for fr in all_frames if fr.gt_pose is not None]
        profiling.sync(device)
        t0 = time.perf_counter()
        slam.process_sequence(a, b, [fr.timestamp for fr in all_frames], adaptor)
        profiling.sync(device)
        compute_time = time.perf_counter() - t0
        if viewer is not None:
            viewer.update(slam)
        _finish(args, slam, len(all_frames), compute_time, gt_poses)
        return

    gt_poses = []
    compute_time = 0.0
    n = 0

    def handle(fr):
        nonlocal compute_time, n
        t0 = time.perf_counter()
        with profiling.profile_time("adaptor"):
            if rgbd:
                meas = adapt_rgbd(torch.as_tensor(fr.intensity, device=device),
                                  torch.as_tensor(fr.depth, device=device), adaptor)
            else:
                meas = adapt_stereo(torch.as_tensor(fr.left, device=device),
                                    torch.as_tensor(fr.right, device=device), adaptor)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)
        profiling.sync(device)
        compute_time += time.perf_counter() - t0
        if fr.gt_pose is not None:
            gt_poses.append(fr.gt_pose)
        n += 1
        if viewer is not None and n % args.viewer_every == 0:
            viewer.update(slam)
        if n % 100 == 0:
            T = slam.robot_in_world()
            print(f"frame {n}: maps={slam.num_maps} closures={slam.num_closures} "
                  f"t={T[:3, 3].round(2)}")

    def run_all():
        nonlocal compute_time
        handle(first)
        for fr in frames:
            handle(fr)
        t0 = time.perf_counter()
        slam.flush()      # frames still queued behind a speculation depth
        profiling.sync(device)
        compute_time += time.perf_counter() - t0

    if args.trace_dir:
        with profiling.device_trace(args.trace_dir):
            run_all()
    else:
        run_all()
    _finish(args, slam, n, compute_time, gt_poses)


def _finish(args, slam, n, compute_time, gt_poses):
    # mean_frame_hz: frames over the summed compute time (app_benchmark.cpp:350-366)
    hz = n / max(compute_time, 1e-9)
    print(f"processed {n} frames, mean_frame_hz={hz:.2f}")
    if args.profile:
        print(profiling.report())

    est = slam.trajectory()
    if args.output:
        datasets.write_kitti_trajectory(args.output + "_kitti.txt", est)
        datasets.write_tum_trajectory(args.output + "_tum.txt", slam.timestamps(), est)
        print(f"trajectories written to {args.output}_{{kitti,tum}}.txt")

    if len(gt_poses) == len(est) and len(est) > 1:
        err = traj_metrics.evaluate(est, gt_poses)
        regression = traj_metrics.is_regression(err, **REGRESSION_GATES[args.dataset])
        print(json.dumps({
            "mean_translation_rmse": err.mean_translation_rmse.tolist(),
            "std_translation_rmse": err.std_translation_rmse.tolist(),
            "mean_rotation_deg": err.mean_rotation_deg,
            "ate_rmse": err.ate_rmse,
            "mean_frame_hz": hz,
            "regression": bool(regression),
        }))
        sys.exit(1 if regression else 0)


if __name__ == "__main__":
    main()
