#!/usr/bin/env python3
"""Where the PyTorch port's GraphSLAM split time goes, on the rendered loop.

Usage (one CUDA card; builds the kernels from csrc/ on first use):

    python3 scripts/profile_slam_torch.py [--rgbd] [--out DIR]

Renders the closed loop of tests/test_rendered_e2e.py on the card (145
frames, 480x640) and runs adapt_stereo -> GraphSLAM.process over it with
chip_smoke.py's config (with --rgbd: the loop as RGB-D through
adapt_rgbd -> GraphSLAM(model="rgbd") with local BA on, chip_smoke.py
phase 6), twice; the second pass records the stages under
``utils/profiling.profile_time`` (each scope synchronizes) and keeps the
inputs of the last loop query, of the first PGO and (--rgbd) of the first
local BA.  Then, each under torch.profiler after a warm-up call, it
replays:

  * ``loop_closure.detect_and_validate`` on that query's inputs, and its
    two halves: ``query`` and ``validate_batch``;
  * ``pgo.optimize`` on that graph;
  * (--rgbd) ``ba.optimize`` on that BA problem;
  * one ``track_step`` of a steady frame;

and prints for each: host ms per call (CUDA events), device ms (sum of
device op durations), CUDA runtime calls (launches, copies, synchronizes)
and the device ops and host-side operators that take the most time.  The
summary is the last line, one JSON object; with --out the operator tables
are also written into DIR.
"""
import argparse
import json
import os
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile_call(name, fn, reps=3):
    """Profile ``reps`` calls of fn after a warm-up: a summary dict and the
    operator table."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    runtime = Counter()
    device_us = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device_us[e.name] += e.time_range.elapsed_us()
        elif e.name.startswith("cuda") or e.name.startswith("cu"):
            runtime[e.name] += 1
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25)
    summary = {
        "name": name,
        "ms_per_call": host_ms,
        "device_ms_per_call": sum(device_us.values()) / reps / 1e3,
        "runtime_calls_per_call": {k: v / reps for k, v in runtime.most_common(8)},
        "top_device_ops_ms": {k[:80]: v / reps / 1e3 for k, v in device_us.most_common(8)},
    }
    return summary, table


def main():
    import torch

    from chip_smoke import run_slam, slam_config
    from srrg2_proslam_tpu_torch.io import synthetic
    from srrg2_proslam_tpu_torch.models import loop_closure, slam as slam_mod
    from srrg2_proslam_tpu_torch.models.frontend import (
        DepthAdaptorConfig, StereoAdaptorConfig, adapt_rgbd, adapt_stereo)
    from srrg2_proslam_tpu_torch.models.tracker import track_step
    from srrg2_proslam_tpu_torch.ops import ba, pgo, se3
    from srrg2_proslam_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rgbd", action="store_true",
                    help="the loop as RGB-D with local BA on (chip_smoke.py phase 6)")
    ap.add_argument("--out", default=None, help="directory for the operator tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this run needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)

    kw = dict(side_a=10.0, side_b=6.0, step_m=0.4, turn_frames=10, device=dev)
    if args.rgbd:
        frames = [((f.intensity, f.depth), f.timestamp)
                  for f in synthetic.iter_rendered_loop_rgbd(**kw)]
        model, acfg, adapt = "rgbd", DepthAdaptorConfig(), adapt_rgbd
    else:
        frames = [((f.left, f.right), f.timestamp) for f in synthetic.iter_rendered_loop(**kw)]
        model, acfg, adapt = "stereo", StereoAdaptorConfig(), adapt_stereo
    config = slam_config(local_ba=args.rgbd)
    cam = synthetic.synthetic_camera()
    run_slam(frames, cam, dev, acfg, model=model, config=config)     # warm-up pass

    kept = {}
    real_dv, real_opt, real_ba = loop_closure.detect_and_validate, pgo.optimize, ba.optimize

    def keep_dv(*a, **k):
        kept["detect"] = (a, k)
        return real_dv(*a, **k)

    def keep_opt(graph, config):
        kept.setdefault("pgo", (graph, config))
        return real_opt(graph, config)

    def keep_ba(*a, **k):
        kept.setdefault("ba", (a, k))
        return real_ba(*a, **k)

    slam_mod.loop_closure.detect_and_validate = keep_dv
    slam_mod.pgo.optimize = keep_opt
    slam_mod.ba_ops.optimize = keep_ba
    profiling.reset()
    profiling.enable()
    try:
        t0 = time.perf_counter()
        s, _ = run_slam(frames, cam, dev, acfg, model=model, config=config)
        wall = time.perf_counter() - t0
    finally:
        slam_mod.loop_closure.detect_and_validate = real_dv
        slam_mod.pgo.optimize = real_opt
        slam_mod.ba_ops.optimize = real_ba
        profiling.enable(False)
    stages = {k: {"calls": v["calls"], "mean_ms": v["mean_ms"], "total_ms": v["total_s"] * 1e3}
              for k, v in profiling.stats().items()}
    print(f"pass: {len(frames)} frames, {wall / len(frames) * 1e3:.3f} ms/frame (stages "
          f"synchronized); stages {json.dumps(stages)} [{smi}]", flush=True)

    (q_desc, q_valid, q_pos, q_map, db, poses, lcfg, n_maps), _ = kept["detect"]
    K = min(lcfg.max_candidates, db.num_slots, n_maps)
    result = loop_closure.query(q_desc, q_valid, q_map, db, lcfg, n_maps)
    cand = result.candidate_maps.clamp_min(0).long()
    T_init = se3.inverse(poses[cand]) @ poses[q_map]
    graph, pcfg = kept["pgo"]
    meas = adapt(*frames[-1][0], acfg)
    state = s.tracker_state
    calls = {
        "detect_and_validate": lambda: real_dv(*kept["detect"][0]),
        "query": lambda: loop_closure.query(q_desc, q_valid, q_map, db, lcfg, n_maps),
        "validate_batch": lambda: loop_closure.validate_batch(q_pos, result, T_init, lcfg),
        "pgo_optimize": lambda: real_opt(graph, pcfg),
        "track_step": lambda: track_step(state, meas.points, meas.desc, meas.valid, cam,
                                         config.tracker, model),
    }
    if "ba" in kept:
        calls["ba_optimize"] = lambda: real_ba(*kept["ba"][0], **kept["ba"][1])
    out = {"device": torch.cuda.get_device_name(0), "card": smi, "model": model,
           "local_ba": config.local_ba.enabled, "stages": stages,
           "ms_per_frame": wall / len(frames) * 1e3, "query_rows": int(q_desc.shape[0]),
           "db_slots": db.num_slots, "db_budget": db.budget, "candidates": K,
           "pgo_poses": graph.capacity, "calls": []}
    for name, fn in calls.items():
        summary, table = profile_call(name, fn)
        out["calls"].append(summary)
        print(f"{name}: {summary['ms_per_call']:.3f} ms/call, device "
              f"{summary['device_ms_per_call']:.3f} ms; runtime calls "
              f"{summary['runtime_calls_per_call']}; top device ops "
              f"{json.dumps(summary['top_device_ops_ms'])} [{smi}]", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
                f.write(table)
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
