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
     and compute its bound from these inputs; FAST also on uniform noise
     of the same shape, with the share of pixels its compass test passes;
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
# sm_90 issue rates, lanes per SM and clock (the SM count and clock are read
# from the card): FADD/FFMA on the FMA pipe, FMNMX and FSETP on the ALU
# pipe, one warp instruction per scheduler and clock (4 x 32) in all
FMA_LANES_PER_SM_CLK = 128
ALU_LANES_PER_SM_CLK = 64
DISPATCH_LANES_PER_SM_CLK = 128
# K3's operations (csrc/fast.cu): every pixel 4 min/max of opposite compass
# samples, 4 subtractions and 4 comparisons; every set polarity of a
# candidate 57 min/max for its best arc (42 for the 16 arcs by van Herk
# blocks, 15 for the best), 1 subtraction, and 1 min/max or comparison where
# the polarities meet the threshold
FAST_PIXEL_FMA, FAST_PIXEL_ALU = 4, 8
FAST_POLARITY_FMA, FAST_POLARITY_ALU = 1, 58
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
    may drop one of them, or, rarely, all: then the window is taken again),
    or, with no kernel named, the summed durations of all device ops over
    ``reps``."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):   # a window can come back without device events: take another
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and (kernel is None or kernel in e.name)]
        if events:
            break
    else:
        fail(f"profiler saw no device time for {kernel or 'a plain version'} in 3 windows")
    calls = reps if kernel is None else len(events)
    return sum(e.time_range.elapsed_us() for e in events) / calls / 1e3


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clocks_per_s(device) -> float:
    """SM count x the card's maximum SM clock (Hz): SM-clocks per second."""
    import torch

    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.clock_rate * 1e3   # clock_rate in kHz


def fast_candidates(images, threshold: float):
    """K3's compass test in plain torch: (bright, dark) bool maps, two
    adjacent compass differences ring - centre > t (bright) or < -t (dark),
    zeros outside the image."""
    import torch.nn.functional as F

    H, W = images.shape[-2:]
    p = F.pad(images, (3, 3, 3, 3))
    d = [p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - images
         for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    t = threshold
    bright = ((d[0] > t) | (d[2] > t)) & ((d[1] > t) | (d[3] > t))
    dark = ((d[0] < -t) | (d[2] < -t)) & ((d[1] < -t) | (d[3] < -t))
    return bright, dark


def fast_bound(images, threshold: float) -> dict:
    """K3's bound on these images: bytes (each pixel read once and written
    once) against the operations this input needs, each pipe at its own
    rate (and all at the issue rate); with the counts behind it."""
    bright, dark = fast_candidates(images, threshold)
    pixels = images.numel()
    candidates = int((bright | dark).sum())
    polarities = int(bright.sum()) + int(dark.sum())
    fma = FAST_PIXEL_FMA * pixels + FAST_POLARITY_FMA * polarities
    alu = FAST_PIXEL_ALU * pixels + FAST_POLARITY_ALU * polarities
    clocks = max(fma / FMA_LANES_PER_SM_CLK, alu / ALU_LANES_PER_SM_CLK,
                 (fma + alu) / DISPATCH_LANES_PER_SM_CLK)
    t_ops = clocks / sm_clocks_per_s(images.device) * 1e3
    t_bytes = 2 * pixels * 4 / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops, "pixels": pixels,
            "candidates": candidates, "polarities": polarities,
            "candidate_share": candidates / pixels}


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

    # K3 on frame 0's pair, and on uniform noise of the same shape (nearly
    # every pixel a candidate)
    noise = torch.randint(0, 256, images.shape, generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32).to(dev, torch.float32)
    errs = []
    for tag, img in (("KITTI frame 0", images), ("uniform noise", noise)):
        k = fast_scores_kernel(img, thr)
        p = fast_scores_plain(img, thr)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        print(f"K3 fast  {tuple(img.shape)} {tag}: max_abs_err {err} "
              f"(corners {int((p > 0).sum())}; tolerance 0, bit-exact)", flush=True)
        if not torch.equal(k, p):
            fail(f"FAST kernel disagrees with its plain version on {tag}")
        errs.append(err)
    kb, nb = fast_bound(images, thr), fast_bound(noise, thr)
    report["fast"] = {
        "max_abs_err": errs[0],
        "ms": device_ms(lambda: fast_scores_kernel(images, thr), kernel="fast_scores_kernel"),
        "plain_ms": device_ms(lambda: fast_scores_plain(images, thr)),
        "event_ms": cuda_ms(lambda: fast_scores_kernel(images, thr)),
        "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
        "candidate_share": kb["candidate_share"],
        "noise_ms": device_ms(lambda: fast_scores_kernel(noise, thr), kernel="fast_scores_kernel"),
        "noise_bound_ms": nb["bound_ms"], "noise_bound_by": nb["bound_by"],
        "noise_candidate_share": nb["candidate_share"]}
    for tag, c, ms in (("KITTI frame 0", kb, report["fast"]["ms"]),
                       ("uniform noise", nb, report["fast"]["noise_ms"])):
        print(f"  fast on {tag}: device {ms:.5f} ms/call, candidate share "
              f"{c['candidate_share']:.4f} ({c['candidates']} of {c['pixels']} pixels, "
              f"{c['polarities']} set polarities); bound by bytes {c['bytes_ms']:.6f} ms, "
              f"by operations {c['operations_ms']:.6f} ms ({sm_clocks_per_s(dev):.4g} "
              f"SM-clocks/s) [{smi}]", flush=True)

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
