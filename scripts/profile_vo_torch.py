#!/usr/bin/env python3
"""Where a steady stereo VO frame of the PyTorch port spends its time.

Usage (one CUDA card; builds the kernels from csrc/ on first use):

    python3 scripts/profile_vo_torch.py [--passes 3] [--out DIR]

Drives the 5 bundled 376x1241 KITTI frames through adapt_stereo ->
track_step with the default configs, as chip_smoke.py does, after one
warm-up pass, and prints:

  * ms/frame of each steady pass (host clock, one synchronize at the end);
  * the stage split: a pass with a synchronize after adapt_stereo and after
    track_step, ms/frame of each;
  * one pass under torch.profiler: CUDA runtime calls per frame (kernel
    launches, copies, synchronizes), the device time summed over all
    device ops and the union of their intervals (busy time), the busy share
    of the pass's wall time, the device time per call of the three
    hand-written kernels, and the device ops that take the most time.

The summary is the last line, one JSON object; with --out the profiler's
operator table and the summary are also written into DIR.  ``--device
cpu`` runs the same passes on the CPU (no device ops; for debugging).
"""
import argparse
import json
import os
import sys
import time
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNEL_NAMES = {"fast": "fast_scores_kernel", "brief": "brief_descriptors_kernel",
                "gn_burst": "gn_burst_stereo_kernel"}


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in the same unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    import torch
    from torch.autograd import DeviceType

    from chip_smoke import run_vo
    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import (
        TrackerConfig, initial_state, track_step)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None, help="directory for the operator table")
    args = ap.parse_args()
    dev = torch.device(args.device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this run needs a CUDA card")

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    frames_np = list(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames_np[0].left.shape)
    adapt_cfg, track_cfg = StereoAdaptorConfig(), TrackerConfig()
    frames = [(torch.from_numpy(f.left).to(dev), torch.from_numpy(f.right).to(dev))
              for f in frames_np]
    n = len(frames)

    def vo_pass(split=None):
        state = initial_state(capacity=4096, device=dev)
        for left, right in frames:
            t0 = time.perf_counter()
            meas = adapt_stereo(left, right, adapt_cfg)
            if split is not None:
                sync()
                t1 = time.perf_counter()
            state, _, _ = track_step(state, meas.points, meas.desc, meas.valid,
                                     cam, track_cfg, "stereo")
            if split is not None:
                sync()
                split["adapt_stereo"] += t1 - t0
                split["track_step"] += time.perf_counter() - t1
        return state

    summary = {"device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
               "frames": n}
    kernels.reset_launch_counts()
    run_vo(frames, cam, dev, adapt_cfg, track_cfg)   # warm-up: builds the kernels
    summary["warmup_launches"] = kernels.launch_counts()

    steady = []
    for _ in range(args.passes):
        sync()
        t0 = time.perf_counter()
        vo_pass()
        sync()
        steady.append((time.perf_counter() - t0) / n * 1e3)
    summary["steady_ms_per_frame"] = steady

    split = defaultdict(float)
    vo_pass(split)
    summary["stage_ms_per_frame"] = {k: v / n * 1e3 for k, v in split.items()}

    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        vo_pass()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    runtime = Counter(e.name for e in events
                      if e.device_type == DeviceType.CPU and e.name.startswith("cuda"))
    dev_total = sum(e.time_range.elapsed_us() for e in dev_events)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev_events])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    per_kernel = {}
    for key, sub in KERNEL_NAMES.items():
        hits = [v for name, v in by_name.items() if sub in name]
        calls = sum(c for _, c in hits)
        per_kernel[key] = {"calls": calls,
                           "ms_per_call": sum(t for t, _ in hits) / calls / 1e3
                           if calls else None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    summary["profiled_pass"] = {
        "wall_ms_per_frame": wall_us / n / 1e3,
        "runtime_calls_per_frame": {k: v / n for k, v in runtime.most_common()},
        "device_ms_per_frame": dev_total / n / 1e3 if dev_events else "not measured",
        "busy_ms_per_frame": busy / n / 1e3 if dev_events else "not measured",
        "busy_share": busy / wall_us if dev_events else "not measured",
        "kernels": per_kernel,
        "top_device_ops_ms": [{"name": name[:100], "ms": t / 1e3, "calls": c}
                              for name, (t, c) in top],
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        sort_key = "self_device_time_total" if on_cuda else "self_cpu_time_total"
        with open(os.path.join(args.out, "profile_vo_torch_ops.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort_key, row_limit=40))
        with open(os.path.join(args.out, "profile_vo_torch.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
