#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port: stereo VO on full-size KITTI frames.

Usage (needs one CUDA card and nvcc; builds the kernels from csrc/):

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels (nvcc, sm_90a) and print the build time;
  3. hold each kernel against its plain PyTorch version at main-path shapes
     (FAST and BRIEF on the bundled KITTI pair [2, 376, 1241], the GN burst
     on frame 1's real correspondences) and time both with CUDA events;
  4. run the 5 bundled KITTI frames through adapt_stereo -> track_step on
     the card: the reference's pose gate must pass, the per-frame counts
     and final pose must agree with the port's CPU run (plain versions),
     and the kernels must have been launched FAST 5, BRIEF 5, GN 15 times;
     then time a second pass.
The last line is {"ok": true, "device": {...}}.
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


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
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
    from srrg2_proslam_tpu_torch.kernels.brief import brief_bitplanes, brief_bitplanes_plain
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain
    from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo, gn_burst_stereo_plain
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import (
        TrackerConfig, associate, initial_state, track_step)
    from srrg2_proslam_tpu_torch.ops import se3
    from srrg2_proslam_tpu_torch.ops.features import _boxfilter

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
    images = torch.stack(frames_gpu[0])
    report = {}

    k = fast_scores_kernel(images, thr)
    p = fast_scores_plain(images, thr)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    print(f"K3 fast  {tuple(images.shape)}: max_abs_err {err} "
          f"(corners {int((p > 0).sum())}; tolerance 0, bit-exact)", flush=True)
    if err != 0.0:
        fail("FAST kernel disagrees with its plain version")
    report["fast"] = {"max_abs_err": err,
                      "ms": cuda_ms(lambda: fast_scores_kernel(images, thr)),
                      "plain_ms": cuda_ms(lambda: fast_scores_plain(images, thr))}

    smooth = _boxfilter(images, adapt_cfg.extractor.smoothing_window).contiguous()
    k = brief_bitplanes(smooth)
    p = brief_bitplanes_plain(smooth)
    torch.cuda.synchronize()
    err = float((k.to(torch.int64) - p.to(torch.int64)).abs().max())
    print(f"K1 brief {tuple(smooth.shape)} -> {tuple(k.shape)}: max_abs_err {err} "
          f"(differing words {int((k != p).sum())}; tolerance 0, bit-exact)", flush=True)
    if err != 0.0:
        fail("BRIEF kernel disagrees with its plain version")
    report["brief"] = {"max_abs_err": err,
                       "ms": cuda_ms(lambda: brief_bitplanes(smooth)),
                       "plain_ms": cuda_ms(lambda: brief_bitplanes_plain(smooth), reps=5)}

    # frame 1's round-0 correspondences, exactly as track_step forms them
    state = initial_state(capacity=4096, device=dev)
    meas0 = adapt_stereo(*frames_gpu[0], adapt_cfg)
    state, _, _ = track_step(state, meas0.points, meas0.desc, meas0.valid, cam,
                             track_cfg, "stereo")
    meas1 = adapt_stereo(*frames_gpu[1], adapt_cfg)
    X_pred = se3.inverse(state.T_lm_robot @ se3.exp(state.velocity))
    weights_all = 1.0 + torch.log1p(state.arena.num_updates.to(torch.float32))
    idw = torch.ones(meas1.points.shape[0], device=dev)
    matches, _, pts, w = associate(state.arena, X_pred, meas1.points, meas1.desc,
                                   meas1.valid, cam, track_cfg, 0, weights_all, idw)
    gn_meas = meas1.points[:, :3].contiguous()
    gn_kw = dict(iterations=track_cfg.gn_iterations, damping=track_cfg.damping,
                 min_inliers=track_cfg.min_num_inliers, epsilon=track_cfg.gn_epsilon,
                 chi_threshold=track_cfg.chi_threshold)
    args = (X_pred, pts, gn_meas, w, matches.mask, cam)
    Xk, sk = gn_burst_stereo(*args, **gn_kw)
    Xp, sp = gn_burst_stereo_plain(*args, **gn_kw)
    err = float((Xk - Xp).abs().max())
    print(f"K2 gn    C={pts.shape[0]} active={int(matches.mask.sum())}: "
          f"max_abs_err(X) {err:.3e} (tolerance {GN_ATOL}); terms {int(sk.num_terms)}/"
          f"{int(sp.num_terms)} inliers {int(sk.num_inliers)}/{int(sp.num_inliers)} "
          f"chi {float(sk.chi_total):.4f}/{float(sp.chi_total):.4f}", flush=True)
    if not (err <= GN_ATOL and int(sk.num_terms) == int(sp.num_terms)
            and abs(int(sk.num_inliers) - int(sp.num_inliers)) <= 1):
        fail("GN burst kernel disagrees with its plain version")
    report["gn_burst"] = {"max_abs_err": err,
                          "ms": cuda_ms(lambda: gn_burst_stereo(*args, **gn_kw)),
                          "plain_ms": cuda_ms(lambda: gn_burst_stereo_plain(*args, **gn_kw))}
    for kname, r in report.items():
        print(f"  {kname}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              f"({smi})", flush=True)

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

    state = initial_state(capacity=4096, device=dev)
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
         "launches": counts[kname], **report[kname]}
        for kname, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
