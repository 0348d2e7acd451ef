#!/usr/bin/env python3
"""Where a frame of the PyTorch port synchronizes the host with the card.

Usage (one CUDA card; builds the kernels from csrc/ on first use):

    python3 scripts/sync_trace_torch.py

For the stereo model (KITTI frames 0 and 1, adapt_stereo) and the RGB-D
model (ICL frames 0 and 1, adapt_rgbd), and for each landmark estimator
and the motion prior on the stereo frames, this runs the adaptor and
``track_step`` on frame 0, then traces frame 1's adaptor and
``track_step`` under ``torch.cuda.set_sync_debug_mode("warn")``: every
operation that synchronizes the host with the card is counted by the
innermost line of the port that issued it.  The last line is one JSON
object: the syncs of each traced frame, by site.
"""
import json
import os
import sys
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models import frontend, tracker

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this run needs a CUDA card")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    data = os.path.join(ROOT, "test_data")
    kitti = [(f.left, f.right) for f in datasets.iter_bundled_kitti(data, "city")][:2]
    icl = [(f.intensity, f.depth) for f in datasets.iter_bundled_icl(data)][:2]
    cases = {
        "stereo, ekf": ("stereo", kitti, tracker.TrackerConfig()),
        "stereo, weighted_mean": ("stereo", kitti,
                                  tracker.TrackerConfig(landmark_estimator="weighted_mean")),
        "stereo, smoother": ("stereo", kitti,
                             tracker.TrackerConfig(landmark_estimator="smoother")),
        "stereo, ekf + motion prior": ("stereo", kitti, tracker.TrackerConfig(
            motion_prior_translation_info=1.0, motion_prior_rotation_info=4.0)),
        "rgbd, ekf": ("rgbd", icl, tracker.TrackerConfig()),
    }
    sites = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        port = [f for f in traceback.extract_stack()[:-1]
                if f"{os.sep}srrg2_proslam_tpu_torch{os.sep}" in f.filename]
        where = (f"{os.path.relpath(port[-1].filename, ROOT)}:{port[-1].lineno} "
                 f"{port[-1].line}" if port else f"{filename}:{lineno}")
        sites[where] += 1

    out = {"device": torch.cuda.get_device_name(0), "card": smi, "frames": {}}
    for name, (model, frames, cfg) in cases.items():
        if model == "stereo":
            cam = datasets.kitti_camera(*frames[0][0].shape)
            adapt = lambda a, b: frontend.adapt_stereo(a, b, frontend.StereoAdaptorConfig())
        else:
            cam = datasets.icl_camera()
            adapt = lambda a, b: frontend.adapt_rgbd(a, b, frontend.DepthAdaptorConfig())
        state = tracker.initial_state(4096, cfg.landmark_estimator, device=dev)
        sites.clear()
        for i, (a, b) in enumerate(frames):
            a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
            torch.cuda.synchronize()
            if i == 1:
                shown = warnings.showwarning
                warnings.showwarning = record
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            try:
                meas = adapt(a, b)
                state, stats, _ = tracker.track_step(state, meas.points, meas.desc,
                                                     meas.valid, cam, cfg, model)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                if i == 1:
                    warnings.showwarning = shown
        torch.cuda.synchronize()
        out["frames"][name] = {"syncs": sum(sites.values()), "sites": dict(sites),
                               "inliers": int(stats.num_inliers)}
        print(f"{name}: frame 1 (adaptor + track_step) synchronized {sum(sites.values())} "
              f"times; inliers {int(stats.num_inliers)} [{smi}]", flush=True)
        for where, n in sites.most_common():
            print(f"  {n} x {where}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
