#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port: stereo VO on full-size KITTI frames.

Usage (needs one CUDA card and nvcc; builds the kernels from csrc/):

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (nvcc, sm_90a) and print the build time;
  3. hold each kernel against its plain PyTorch version on the inputs the
     main path gives it (FAST on frame 0's KITTI pair [2, 376, 1241], BRIEF
     at that pair's 2 x 1152 keypoints, the GN burst on frame 1's round-0
     correspondences); time each as device time per call (torch.profiler),
     and compute its bound from these inputs;
  4. run the 5 bundled KITTI frames through adapt_stereo -> track_step on
     the card: the reference's pose gate must pass, the per-frame counts
     and final pose must agree with the port's CPU run (plain versions),
     and the kernels must have been launched FAST 5, BRIEF 5, GN 15 times;
     then time a second pass.
The line before the last is the kernels' JSON record (agreement, launches,
times, bounds); the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

GATE_T = (0.2, 0.2, 0.7)     # m, reference tests/test_trackers.cpp:327-365
GATE_ANGLE = 0.01            # rad
COUNT_TOL = 2                # per-frame count tolerance, GPU vs CPU run
POSE_TOL_M = 0.01            # final pose, GPU vs CPU run
POSE_TOL_RAD = 1e-3
GN_ATOL = 5e-4               # GN burst X, kernel vs plain (tests/test_gn_pallas.py)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


# H100 SXM peaks (datasheet): HBM3 bytes/s, f32 ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST-9/16 per pixel, with one set of ring differences (arcmin(c - ring) =
# -arcmax(ring - c)): 16 subtractions; for the arc minima and maxima each,
# 2 x 16 min/max for the 16 cyclic 3-windows, 2 x 16 for the 9-arcs built
# from three windows, and 15 for the best arc; 4 for the final max and the
# threshold
FAST_OPS_PER_PIXEL = 16 + 2 * (32 + 32 + 15) + 4
# GN burst per active correspondence and iteration (csrc/gn_burst.cu
# accumulate; an FMA counts 2): transform 18, projection 11, residual 3,
# Jacobian 36, robust weight 10, H 147, b 42, stats 5
GN_FLOPS_PER_TERM = 272


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around back-to-back calls,
    after warm-up (holds the host's cost of each call where it exceeds the
    device's)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, kernel: str = None) -> float:
    """Device time per call under torch.profiler over ``reps`` calls, after
    warm-up: the mean duration of the launches of ``kernel`` (the profiler
    may drop one of them), or, with no kernel named, the summed durations of
    all device ops over ``reps``."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and (kernel is None or kernel in e.name)]
    if not events:
        fail(f"profiler saw no device time for {kernel or 'a plain version'}")
    calls = reps if kernel is None else len(events)
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_inputs(frames_gpu, cam, adapt_cfg, track_cfg):
    """The kernels' inputs as the main path forms them: frame 0's pair and
    its keypoints (K3, K1), frame 1's round-0 correspondences (K2)."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import associate, initial_state, track_step
    from srrg2_proslam_tpu_torch.ops import se3
    from srrg2_proslam_tpu_torch.ops.features import (
        _boxfilter, _keypoint_rows_cols, detect_keypoints_batch)

    ext = adapt_cfg.extractor
    images = torch.stack(frames_gpu[0])
    uv, _, valid = detect_keypoints_batch(images, ext)
    y, x = _keypoint_rows_cols(uv, images.shape[1], images.shape[2])
    smooth = _boxfilter(images, ext.smoothing_window)

    state = initial_state(capacity=4096)
    meas0 = adapt_stereo(*frames_gpu[0], adapt_cfg)
    state, _, _ = track_step(state, meas0.points, meas0.desc, meas0.valid, cam,
                             track_cfg, "stereo")
    meas1 = adapt_stereo(*frames_gpu[1], adapt_cfg)
    X_pred = se3.inverse(state.T_lm_robot @ se3.exp(state.velocity))
    weights_all = 1.0 + torch.log1p(state.arena.num_updates.to(torch.float32))
    idw = torch.ones(meas1.points.shape[0], device=images.device)
    matches, _, pts, w = associate(state.arena, X_pred, meas1.points, meas1.desc,
                                   meas1.valid, cam, track_cfg, 0, weights_all, idw)
    gn_kw = dict(iterations=track_cfg.gn_iterations, damping=track_cfg.damping,
                 min_inliers=track_cfg.min_num_inliers, epsilon=track_cfg.gn_epsilon,
                 chi_threshold=track_cfg.chi_threshold)
    gn_args = (X_pred, pts, meas1.points[:, :3].contiguous(), w, matches.mask, cam)
    return {"images": images, "smooth": smooth, "y": y, "x": x, "valid": valid,
            "gn_args": gn_args, "gn_kw": gn_kw}


def run_vo(frames, cam, device, adapt_cfg, track_cfg):
    """The port's main path over the frames; returns (per-frame stats, poses)."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import initial_state, track_step

    state = initial_state(capacity=4096, device=device)
    rows, poses = [], []
    for left, right in frames:
        meas = adapt_stereo(left, right, adapt_cfg)
        state, stats, _ = track_step(state, meas.points, meas.desc, meas.valid,
                                     cam, track_cfg, "stereo")
        rows.append({
            "meas": int(stats.num_measurements), "matches": int(stats.num_matches),
            "inliers": int(stats.num_inliers), "chi": float(stats.chi_per_inlier),
            "merges": int(stats.num_merges), "adds": int(stats.num_additions),
            "stage": int(stats.matcher_stage), "map": int(state.arena.count),
        })
        poses.append(state.T_lm_robot.detach().cpu())
    return rows, poses


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.kernels import _build
    from srrg2_proslam_tpu_torch.kernels.brief import (
        brief_bitplanes_plain, brief_descriptors, brief_descriptors_plain,
        descriptors_from_planes)
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain
    from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo, gn_burst_stereo_plain
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig, initial_state, track_step
    from srrg2_proslam_tpu_torch.ops import se3
    from srrg2_proslam_tpu_torch.ops.features import _BRIEF_PAIRS
    from srrg2_proslam_tpu_torch.ops.gn import gn_iterate, stereo_projective_system

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}",
          flush=True)

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    nvcc = "cached build" if _build.build_seconds is None else f"nvcc {_build.build_seconds:.2f} s"
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s ({nvcc})", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions ------------------------------
    frames_np = list(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames_np[0].left.shape)
    adapt_cfg, track_cfg = StereoAdaptorConfig(), TrackerConfig()
    frames_gpu = [(torch.from_numpy(f.left).to(dev), torch.from_numpy(f.right).to(dev))
                  for f in frames_np]
    thr = adapt_cfg.extractor.detector_threshold
    inp = main_path_inputs(frames_gpu, cam, adapt_cfg, track_cfg)
    images = inp["images"]
    report = {}

    k = fast_scores_kernel(images, thr)
    p = fast_scores_plain(images, thr)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    print(f"K3 fast  {tuple(images.shape)}: max_abs_err {err} "
          f"(corners {int((p > 0).sum())}; tolerance 0, bit-exact)", flush=True)
    if err != 0.0:
        fail("FAST kernel disagrees with its plain version")
    report["fast"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: fast_scores_kernel(images, thr), kernel="fast_scores_kernel"),
        "plain_ms": device_ms(lambda: fast_scores_plain(images, thr)),
        "event_ms": cuda_ms(lambda: fast_scores_kernel(images, thr)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * images.numel() * 4, images.numel() * FAST_OPS_PER_PIXEL)))}

    smooth, y, x, valid = (inp[key] for key in ("smooth", "y", "x", "valid"))
    k = brief_descriptors(smooth, y, x, valid)
    p = brief_descriptors_plain(smooth, y, x, valid)
    dense = torch.where(valid[..., None],
                        descriptors_from_planes(brief_bitplanes_plain(smooth), y, x), -1)
    torch.cuda.synchronize()
    err = float((k.to(torch.int32) - p.to(torch.int32)).abs().max())
    print(f"K1 brief {tuple(smooth.shape)} at {tuple(y.shape)} keypoints "
          f"({int(valid.sum())} valid) -> {tuple(k.shape)}: max_abs_err {err} "
          f"(differing entries {int((k != p).sum())}, vs dense bitplanes "
          f"{int((k != dense).sum())}; tolerance 0, bit-exact)", flush=True)
    if err != 0.0 or not torch.equal(k, dense.to(torch.int8)):
        fail("BRIEF kernel disagrees with its plain version")
    # bytes: each distinct sampled pixel of the valid keypoints once, the
    # keypoints (y, x int64, valid), the int8 output; ops: 256 comparisons
    B, H, W = smooth.shape
    pairs = torch.as_tensor(_BRIEF_PAIRS, device=dev).long().reshape(512, 2)
    bidx = torch.arange(B, device=dev)[:, None, None]
    lin = (bidx * H + y[..., None] + pairs[:, 0]) * W + x[..., None] + pairs[:, 1]
    samples = int(torch.unique(lin[valid]).numel())
    report["brief"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: brief_descriptors(smooth, y, x, valid),
                        kernel="brief_descriptors_kernel"),
        "plain_ms": device_ms(lambda: brief_descriptors_plain(smooth, y, x, valid)),
        "event_ms": cuda_ms(lambda: brief_descriptors(smooth, y, x, valid)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(samples * 4 + y.numel() * 17 + k.numel(),
                         int(valid.sum()) * 256)))}

    args, gn_kw = inp["gn_args"], inp["gn_kw"]
    Xk, sk = gn_burst_stereo(*args, **gn_kw)
    iterations_run = []

    def counted(X, *rest):
        iterations_run.append(1)
        return stereo_projective_system(X, *rest)

    X_pred, pts, gn_meas, w, mask, _ = args
    Xp, sp = gn_iterate(lambda X: counted(X, pts, gn_meas, w, mask, cam, gn_kw["chi_threshold"]),
                        X_pred, gn_kw["iterations"], damping=gn_kw["damping"],
                        min_inliers=gn_kw["min_inliers"], epsilon=gn_kw["epsilon"])
    err = float((Xk - Xp).abs().max())
    active = int(mask.sum())
    print(f"K2 gn    C={pts.shape[0]} active={active} iterations={len(iterations_run)}: "
          f"max_abs_err(X) {err:.3e} (tolerance {GN_ATOL}); terms {int(sk.num_terms)}/"
          f"{int(sp.num_terms)} inliers {int(sk.num_inliers)}/{int(sp.num_inliers)} "
          f"chi {float(sk.chi_total):.4f}/{float(sp.chi_total):.4f}", flush=True)
    if not (err <= GN_ATOL and int(sk.num_terms) == int(sp.num_terms)
            and abs(int(sk.num_inliers) - int(sp.num_inliers)) <= 1):
        fail("GN burst kernel disagrees with its plain version")
    # bytes: X0, the mask, the active rows' point, measurement and weight,
    # the 19-word output; ops: the accumulation of the iterations this
    # run's data needs (the 6x6 solves add ~0.3 kflop each)
    report["gn_burst"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: gn_burst_stereo(*args, **gn_kw), kernel="gn_burst_stereo_kernel"),
        "plain_ms": device_ms(lambda: gn_burst_stereo_plain(*args, **gn_kw)),
        "event_ms": cuda_ms(lambda: gn_burst_stereo(*args, **gn_kw)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(64 + pts.shape[0] + active * 28 + 19 * 4,
                         GN_FLOPS_PER_TERM * active * len(iterations_run))))}
    for kname, r in report.items():
        print(f"  {kname}: device {r['ms']:.5f} ms/call (events {r['event_ms']:.5f}), "
              f"plain {r['plain_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}) [{smi}]", flush=True)

    # ---- 4. the main path ------------------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows, poses = run_vo(frames_gpu, cam, dev, adapt_cfg, track_cfg)
    torch.cuda.synchronize()
    first_pass = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for i, (r, pose) in enumerate(zip(rows, poses)):
        print(f"frame {i}: meas={r['meas']} matches={r['matches']} inliers={r['inliers']} "
              f"chi/inl={r['chi']:.2f} merges={r['merges']} adds={r['adds']} "
              f"stage={r['stage']} map={r['map']} t={pose[:3, 3].numpy().round(3)}",
              flush=True)
    print(f"launches on the main path: {counts}", flush=True)
    if counts != {"fast": 5, "brief": 5, "gn_burst": 15}:
        fail(f"kernel launch counts {counts} != fast 5, brief 5, gn_burst 15")

    gt = torch.from_numpy(frames_np[-1].gt_pose)
    t_err, angle = se3.error_t_and_angle(poses[-1], gt)
    gate = bool((t_err <= torch.tensor(GATE_T)).all()) \
        and float(angle) <= GATE_ANGLE
    print(f"per-axis |t err|: {t_err.numpy().round(4)} angle: {float(angle):.5f} "
          f"-> {'PASS' if gate else 'FAIL'}", flush=True)
    if not gate:
        fail("the 5-frame KITTI gate failed")

    cpu_frames = [(torch.from_numpy(f.left), torch.from_numpy(f.right)) for f in frames_np]
    t0 = time.perf_counter()
    cpu_rows, cpu_poses = run_vo(cpu_frames, cam, "cpu", adapt_cfg, track_cfg)
    print(f"CPU run (plain versions): {time.perf_counter() - t0:.1f} s", flush=True)
    for i, (g, c) in enumerate(zip(rows, cpu_rows)):
        for key in ("meas", "matches", "inliers", "merges", "adds"):
            if abs(g[key] - c[key]) > COUNT_TOL:
                fail(f"frame {i} {key}: GPU {g[key]} vs CPU {c[key]} (tolerance {COUNT_TOL})")
    dt, dang = se3.error_t_and_angle(poses[-1], cpu_poses[-1])
    print(f"GPU vs CPU run: counts within {COUNT_TOL}; final pose |dt| "
          f"{dt.numpy()} angle {float(dang):.3e} (tolerance {POSE_TOL_M} m, "
          f"{POSE_TOL_RAD} rad)", flush=True)
    if not (float(dt.max()) <= POSE_TOL_M and float(dang) <= POSE_TOL_RAD):
        fail("GPU and CPU final poses disagree")

    state = initial_state(capacity=4096)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for left, right in frames_gpu:
        meas = adapt_stereo(left, right, adapt_cfg)
        state, _, _ = track_step(state, meas.points, meas.desc, meas.valid, cam,
                                 track_cfg, "stereo")
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / len(frames_gpu) * 1e3
    print(f"VO ms/frame: steady {steady:.3f} (second pass), first pass "
          f"{first_pass / len(frames_gpu) * 1e3:.3f} incl. per-frame readback "
          f"[{smi}]", flush=True)

    sources = {"fast": ("srrg2_proslam_tpu_torch/csrc/fast.cu",
                        "srrg2_proslam_tpu/ops/fast_pallas.py:86"),
               "brief": ("srrg2_proslam_tpu_torch/csrc/brief.cu",
                         "srrg2_proslam_tpu/ops/brief_pallas.py:103"),
               "gn_burst": ("srrg2_proslam_tpu_torch/csrc/gn_burst.cu",
                            "srrg2_proslam_tpu/ops/gn_pallas.py:255")}
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[kname], "launches_per_frame": counts[kname] / len(frames_gpu),
         "library_ms": None, **report[kname]}
        for kname, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
