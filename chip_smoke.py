#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port: stereo VO on full-size KITTI
frames, per-frame GraphSLAM over a rendered closed loop, then RGB-D
GraphSLAM (ICL and the loop as RGB-D, with local BA), the other landmark
estimators and the motion prior on KITTI, the shipped configurations
and the speculative queue, the host surface (the apps, checkpoints, the
trace, entry() and the native decoder), the chunk program, the mesh, and
the repo's examples and tools.  It needs no PIL: phase 8 reads JPEG,
palette, 1-bit and interlaced PNG and BMP through the port's own library.

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
     then time a second pass;
  5. render the closed loop of tests/test_rendered_e2e.py on the card with
     the port's renderer (145 frames, 480x640, supersample 2) and run
     adapt_stereo -> GraphSLAM.process over it at that test's config with
     every other setting at its default (a 4096-landmark arena, 512 local
     maps, 1024 edges): the test's gates must pass (>= 120 frames, >= 10
     maps, >= 1 closure, >= 1 relocalisation, per-axis t-RMSE <= 0.30 m,
     rotation <= 3 deg, ATE <= 0.5 m), the kernels must have been launched
     FAST n, BRIEF n, GN 3n times for n frames, and each kernel must agree
     with its plain version at this path's inputs (FAST and BRIEF on the
     first rendered pair, the GN burst on every burst captured from the run);
     the port's CPU run over the same images (copied to the host) must give
     the same per-frame status and map, the same map, closure and
     relocalisation counts and closure events, and every frame's pose
     within SLAM_POSE_TOL_M / SLAM_POSE_TOL_RAD (a prefix with >= 3 splits
     when the CPU run would take longer than CPU_BUDGET_S); a second pass,
     with no stage timing, gives GraphSLAM ms/frame; a third, under
     utils/profiling.profile_time with synchronized scopes, the stage
     times and the loop query's peak memory; then the last split's query
     rows run against a database of the default size (64 slots x 1024)
     seeded with noisy copies of them, dense and tiled;
  6. RGB-D and the estimators: FAST and BRIEF bit-exact at ICL frame 0
     [1, 480, 640] (and timed there); ICL frames 0 and 1 through
     adapt_rgbd -> GraphSLAM(model="rgbd") at the default config within
     5e-3 m per axis and 0.01 rad of the fixture's camera_01_in_00; the
     loop of phase 5 as RGB-D (the left view and its depth in millimetres)
     through adapt_rgbd -> GraphSLAM(model="rgbd") at phase 5's config
     with local BA on: phase 5's gates, launches FAST n, BRIEF n, GN 0 (the
     depth factor has no kernel, as in the JAX package), FAST and BRIEF
     bit-exact on the first frame, the port's CPU run equal frame for frame
     (a prefix past RGBD_CPU_BUDGET_S), RGB-D ms/frame from a second pass;
     then the 5 KITTI frames with the weighted-mean estimator, the
     smoother, and the EKF with the motion prior at euroc_slam.json's
     1.0 / 4.0: the VO gate, the CPU run's counts and final pose, launches
     FAST 5 / BRIEF 5 / GN 15 (GN 0 with the prior: its GN has no kernel,
     as in the JAX package) and every GN burst within GN_ATOL of its plain
     burst;
  7. the shipped configurations and the sequence API: the 5 KITTI pairs
     under the port-loaded euroc_adaptor.json (oriented BRIEF, sub-pixel
     disparities) and aggressive_motion_adaptor.json (sub-pixel) on the
     card against the port's CPU run (keypoints, valid rows and uL/v
     bit-exact, u_R within UR_ATOL, oriented descriptor bits within
     ORIENTED_BITS per frame, both from tests/torch_bounds.py; launches
     FAST 5 / BRIEF 0 oriented, FAST 5 / BRIEF 5 upright);
     the rendered loop of phase 5 through the speculative per-frame queue
     (the batched adaptor over each 16 frames, then process_dispatch /
     process_finalize per frame at speculation_depth 8, then flush): FAST
     and BRIEF bit-exact and timed at the first chunk's inputs ([32, 480,
     640], 32 x 1152 keypoints), launches FAST and BRIEF once per chunk
     and GN 3 per tracker step (frames replayed after splits and losses
     included), phase 5's gates, phase 5's per-frame run equal frame for
     frame (status, map, every pose within SLAM_POSE_TOL_M /
     SLAM_POSE_TOL_RAD), ms/frame from a second pass beside phase 5's;
     kitti_slam.json + kitti_adaptor.json through process_sequence (the
     chunk program) over the 5 KITTI pairs equal to the CPU run, and every
     shipped SLAM config constructs a GraphSLAM on the card;
  8. the host surface, through the port's apps in this process: 8a
     app_benchmark --dataset kitti on a KITTI-odometry folder written from
     the 5 bundled pairs (launches FAST 5 / BRIEF 5 / GN 15, the exit code
     and regression flag of the same invocation with --device cpu, the
     trajectory within APP_POSE_TOL_M of it, both trajectory files
     written); 8b the folder converted to a BOSS log by convert_dataset
     and run with --dataset boss (the trajectory equal to 8a's); 8c
     --dataset synthetic --count 145 --chunked 16 through the chunk
     program (the synthetic gate, launches FAST = BRIEF = the chunks
     through the batched adaptor and GN 3 per tracker step with the
     graph's warm-up, a chunk graph replayed, mean_frame_hz beside phase
     5's rate);
     8d phase 5's loop on the card to frame 72, checkpoint.save, load into
     a fresh card GraphSLAM and continue (status, map, counts and closure
     events equal phase 5's, poses within CKPT_POSE_TOL_M), and the same
     checkpoint continued on the CPU on the card's measurements for up to
     CKPT_CPU_BUDGET_S (poses within APP_POSE_TOL_M); 8e 8a with
     --trace-dir (the trace names the three kernels); 8f entry() on the
     card (3 GN launches, pose within ENTRY_TOL of the CPU's); the native
     decoder built with g++ equal to the plain decoder on every bundled
     image, and its prefetcher in order; 8g the second image library
     (io/images.py, g++) and its plain twin on the committed fixtures of
     test_data/torch_io (JPEG baseline with and without restart markers,
     progressive 4:2:0, palette, 1-bit and Adam7 PNG, BMP, and the
     KITTI- and TUM-layout TIFF folders): load_gray and load_depth equal
     to MANIFEST.json's SHA-256 of the JAX package's; the KITTI JPEG pairs
     through iter_malaga_stereo and the KITTI TIFF pairs (8-bit LZW with
     predictor 2, 16-bit) through iter_kitti_odometry, each then
     adapt_stereo -> track_step on the card (K3, K1, K2 against their
     plain versions at these frames, K2 within TIFF_GN_ATOL on the TIFF
     pair, launches FAST 2 / BRIEF 2 / GN 6, counts and pose against the
     CPU run); the TUM TIFF folder (16-bit and float32 depth) through
     iter_tum_rgbd, then adapt_rgbd -> track_step(model="rgbd") (K3 and K1
     bit-exact, counts and pose against the CPU run); the KITTI TGA folder
     (RLE) as the TIFF one (launches_tga_vo, max_abs_err_tga); the later
     fixtures (CCITT G3 / G4, JPEG and YCbCr TIFF, orientation 6, BigTIFF
     with fill order 2, a block-smoothed progressive JPEG, RLE TGA, DDS,
     SGI, PCX, ICO, QOI, IM, XBM, MSP, lossless and lossy WebP) to the
     manifest; save_gray to .jpg, .tif, .gif, .tga, .sgi, .pcx, .dds and
     .im byte for byte PIL's files; the small JPEG 2000 (JP2 9/7 RGB, J2K
     16-bit depth in tiles) and Zstandard TIFF fixtures to the manifest
     through the library and its twin, the KITTI Zstandard TIFF folder as
     the TIFF one (launches_zstd_vo, max_abs_err_zstd) and the TUM JPEG
     2000 folder (JP2 RGB, 16-bit J2K depth) as the TUM TIFF one
     (launches_jp2_rgbd, max_abs_err_jp2_rgbd), each read through the
     library and the folder readers; the KITTI folder of lossless
     animated WebP (each file's first frame) as the TIFF one, through the
     library and the folder readers (launches_webp_anim_vo,
     max_abs_err_webp), and the BC6H DDS files (DXGI 95 and 96) to the
     manifest through the library and its twin;
     ms per decode of the 376x1241 JPEG, the 480x640 progressive one, four
     TIFF files, a KITTI TGA, a DDS, three of the later fixtures, the
     480x640 JP2 RGB, the 16-bit J2K depth, a KITTI Zstandard TIFF, a
     KITTI animated WebP and the two BC6H files;
  9. the chunk program (models/chunk.py; scripts/chunk_graphs_torch.py
     runs this phase alone): 9a the rendered loop through
     GraphSLAM.process_sequence at chunk_size 16, chunk_lag 2 (one CUDA
     graph replay per full chunk): phase 5's gates, phase 5's per-frame
     run equal frame for frame, launches equal to the prediction from the
     run's chunk_stats and, over a 48-frame window, to the kernel events
     torch.profiler sees (at most one dropped per kernel), each captured
     graph's capture and instantiate ms and nodes, dispatches, replays,
     eager frames, packet reads, rollbacks and replays, ms/frame from a
     second pass beside phases 5 and 7, stage times from a third pass
     under profile_time (chunk_dispatch, chunk_readback, closure_decision,
     pgo, reloc); 9b three chunks of the loop
     through the chunk graph and eagerly from the same state, and each
     of their split branches through its graph and eagerly: counts,
     maps, split heads and database slots equal, floats within
     CHUNK_EAGER_TOL; 9c the measurement streams of the CPU tests
     (rebuilt with numpy) per frame and chunked (STREAM_CHUNKS, the
     rollback stream also in chunks of 20) on the card, each equal, with
     at least one relocalisation rollback; 9d the loop as RGB-D (local BA
     off) through process_sequence equal to its per-frame run.
  10. the multi-GPU slice (parallel/, GraphSLAM(mesh=...)), every rank a
     process spawned by parallel/launch.py on the one card: 10a
     entry.dryrun_multichip(1) over NCCL and dryrun_multichip(2) with two
     ranks sharing the card over gloo: the sharded tracker step, ring
     query, PGO (dense, CG) and BA (structure-only, joint) each equal to
     its single-rank call on the card (query keys, matches and counts bit
     for bit, floats within parallel/checks.py's FLOAT_TOL), and a short
     meshed chunk-program run equal to the unmeshed one; 10b the rendered
     loop through GraphSLAM(mesh=...).process_sequence at world size 2
     (chunk 16, lag 2): phase 5's gates, phase 9a's run frame for frame
     (status and map; counts and closure events; every pose within
     MESH_POSE_TOL_M), each rank's launches equal to the prediction from
     its chunk_stats, and over a 48-frame window the kernel events
     torch.profiler sees on rank 0 (at most one dropped per kernel); 10c
     the loop per frame (process + flush) at world size 2 equal to phase
     5's run, launches FAST n, BRIEF n, GN 3n per rank; with ms/frame
     (10b a second pass, 10c its one pass) beside phases 9a and 5,
     collectives and bytes per pass by stage, and the eagerly run split
     branches' ms.
  11. the examples and tools (scripts/tools_torch.py runs this phase
     alone): 11c's default loop first, with nothing else running; then
     the card's runs that two child processes repeat on the CPU, on the
     card's renders (as phase 5's CPU run), while the card runs the rest:
     11a the seven didactic examples (apps/example_*) on the card, each
     printout equal to its --device cpu run (tests/torch_printout.py:
     counts exactly, floats within one printed unit, timings left out)
     and its launches equal to the prediction (EXAMPLES), and
     export_viewer (it renders where matplotlib imports, else its
     ImportError is the expected result); 11b smoke_vo, smoke_slam and
     smoke_rgbd (scripts/*_torch.py) print PASS with their predicted
     launches; 11c rendered_e2e_torch over its default 253-frame loop:
     counts and verdict equal to the JAX script's CPU run (JAX_E2E),
     launches FAST 253, BRIEF 253, GN 759, and its first E2E_CPU_FRAMES
     frames equal to the CPU's within E2E_POSE_TOL_M; 11d
     ab_local_ba_torch, ab_seeded_detection_torch,
     ab_motion_envelopes_torch --fast and diag_rendered_torch --part 1
     against the JAX scripts' recorded CPU output (the JAX_* constants:
     GraphSLAM counts exactly, the frontend's tallies within
     RENDER_REL_TOL, each run's ATE and t-RMSE within RENDER_POSE_TOL_M),
     each with its predicted launches; K3 and K1 bit-exact on the motion
     loop's first 320x416 pair and the seeded A/B's crushed right image,
     K2 on each A/B run's busiest burst; and the seeded A/B's and the
     idw+smoother motion loop's first AB_CPU_FRAMES frames and
     diag_rendered's part 1 against the CPU twin's runs (matches and
     diag's rows exactly, VO inliers per frame within COUNT_TOL, counts
     exactly, every pose within E2E_POSE_TOL_M).
The line before the last is the kernels' JSON record (agreement, launches,
times, bounds); the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import glob
import json
import os
import runpy
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
# the rendered loop: tests/test_rendered_e2e.py's gates
E2E_MIN_FRAMES, E2E_MIN_MAPS = 120, 10
E2E_T_RMSE, E2E_ROT_DEG, E2E_ATE = 0.30, 3.0, 0.5
SLAM_POSE_TOL_M = 1e-3       # every frame's pose, GPU vs CPU GraphSLAM run
SLAM_POSE_TOL_RAD = 1e-3
SEQ_CHUNK = 16               # phase 7: chunk_size of the sequence run
SEQ_DEPTH = 8                # phase 7: speculation_depth of the sequence run
CPU_BUDGET_S = 240.0         # the CPU reference stops after this once >= 3 splits ran
RGBD_CPU_BUDGET_S = 60.0     # likewise for the RGB-D loop's CPU reference
ICL_GATE_T, ICL_GATE_ANGLE = 5e-3, 0.01   # tests/test_rgbd_integration.py:73-74


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


# windows device_ms takes before it gives up on a kernel's events: three
# in a row came back without K1's events once (phase 6, ICL frame 0)
PROFILER_WINDOWS = 6


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
    for _ in range(PROFILER_WINDOWS):   # a window can come back without device events
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and (kernel is None or kernel in e.name)]
        if events:
            break
    else:
        fail(f"profiler saw no device time for {kernel or 'a plain version'} in "
             f"{PROFILER_WINDOWS} windows")
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


def frontend_inputs(images, ext) -> dict:
    """K3's and K1's inputs as the adaptors form them for a batch of images
    (a stereo pair [2, H, W], an RGB-D intensity [1, H, W]): the images,
    the box-filtered images and the keypoints."""
    from srrg2_proslam_tpu_torch.ops.features import (
        _boxfilter, _keypoint_rows_cols, detect_keypoints_batch)

    uv, _, valid = detect_keypoints_batch(images, ext)
    y, x = _keypoint_rows_cols(uv, images.shape[1], images.shape[2])
    smooth = _boxfilter(images, ext.smoothing_window)
    return {"images": images, "smooth": smooth, "y": y, "x": x, "valid": valid}


def main_path_inputs(frames_gpu, cam, adapt_cfg, track_cfg):
    """The kernels' inputs as the main path forms them: frame 0's pair and
    its keypoints (K3, K1), frame 1's round-0 correspondences (K2)."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import associate, initial_state, track_step
    from srrg2_proslam_tpu_torch.ops import se3

    inp = frontend_inputs(torch.stack(frames_gpu[0]), adapt_cfg.extractor)
    state = initial_state(capacity=4096)
    meas0 = adapt_stereo(*frames_gpu[0], adapt_cfg)
    state, _, _ = track_step(state, meas0.points, meas0.desc, meas0.valid, cam,
                             track_cfg, "stereo")
    meas1 = adapt_stereo(*frames_gpu[1], adapt_cfg)
    X_pred = se3.inverse(state.T_lm_robot @ se3.exp(state.velocity))
    weights_all = 1.0 + torch.log1p(state.arena.num_updates.to(torch.float32))
    idw = torch.ones(meas1.points.shape[0], device=inp["images"].device)
    matches, _, pts, w = associate(state.arena, X_pred, meas1.points, meas1.desc,
                                   meas1.valid, cam, track_cfg, 0, weights_all, idw)
    gn_kw = dict(iterations=track_cfg.gn_iterations, damping=track_cfg.damping,
                 min_inliers=track_cfg.min_num_inliers, epsilon=track_cfg.gn_epsilon,
                 chi_threshold=track_cfg.chi_threshold)
    inp["gn_args"] = (X_pred, pts, meas1.points[:, :3].contiguous(), w, matches.mask, cam)
    inp["gn_kw"] = gn_kw
    return inp


def check_fast(images, threshold: float, tag: str) -> float:
    """K3 against its plain version, bit for bit; returns max_abs_err."""
    import torch

    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain

    k = fast_scores_kernel(images, threshold)
    p = fast_scores_plain(images, threshold)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    print(f"K3 fast  {tuple(images.shape)} {tag}: max_abs_err {err} "
          f"(corners {int((p > 0).sum())}; tolerance 0, bit-exact)", flush=True)
    if not torch.equal(k, p):
        fail(f"FAST kernel disagrees with its plain version on {tag}")
    return err


def check_kernels(inp, cam, threshold: float, tag: str):
    """Hold K3, K1 and K2 against their plain versions on one pair's
    frontend inputs and one burst's (as ``main_path_inputs`` forms them;
    K3 and K1 bit-exact, K2 within GN_ATOL); fail on a mismatch.  Returns ({kernel: max_abs_err}, (active GN rows,
    GN iterations the plain burst ran))."""
    errs = check_frontend(inp, threshold, tag)
    errs["gn_burst"], active, iterations = check_gn(inp["gn_args"], inp["gn_kw"], cam, tag)
    return errs, (active, iterations)


def check_frontend(inp, threshold: float, tag: str) -> dict:
    """K3 and K1 against their plain versions, bit for bit, on frontend
    inputs (``frontend_inputs``); returns {kernel: max_abs_err}."""
    import torch

    from srrg2_proslam_tpu_torch.kernels.brief import (
        brief_bitplanes_plain, brief_descriptors, brief_descriptors_plain,
        descriptors_from_planes)

    errs = {"fast": check_fast(inp["images"], threshold, tag)}
    smooth, y, x, valid = (inp[key] for key in ("smooth", "y", "x", "valid"))
    k = brief_descriptors(smooth, y, x, valid)
    p = brief_descriptors_plain(smooth, y, x, valid)
    dense = torch.where(valid[..., None],
                        descriptors_from_planes(brief_bitplanes_plain(smooth), y, x), -1)
    torch.cuda.synchronize()
    err = float((k.to(torch.int32) - p.to(torch.int32)).abs().max())
    print(f"K1 brief {tuple(smooth.shape)} {tag} at {tuple(y.shape)} keypoints "
          f"({int(valid.sum())} valid) -> {tuple(k.shape)}: max_abs_err {err} "
          f"(differing entries {int((k != p).sum())}, vs dense bitplanes "
          f"{int((k != dense).sum())}; tolerance 0, bit-exact)", flush=True)
    if err != 0.0 or not torch.equal(k, dense.to(torch.int8)):
        fail(f"BRIEF kernel disagrees with its plain version on {tag}")
    errs["brief"] = err
    return errs


def brief_bound(smooth, y, x, valid):
    """K1's (bound_ms, bound_by) at these keypoints: bytes are each distinct
    sampled pixel of the valid keypoints once, the keypoints (y, x int64,
    valid) and the int8 output; operations 256 comparisons per valid
    keypoint."""
    import torch

    from srrg2_proslam_tpu_torch.ops.features import _BRIEF_PAIRS

    B, H, W = smooth.shape
    pairs = torch.as_tensor(_BRIEF_PAIRS, device=smooth.device).long().reshape(512, 2)
    bidx = torch.arange(B, device=smooth.device)[:, None, None]
    lin = (bidx * H + y[..., None] + pairs[:, 0]) * W + x[..., None] + pairs[:, 1]
    samples = int(torch.unique(lin[valid]).numel())
    return bound(samples * 4 + y.numel() * 17 + y.numel() * 256, int(valid.sum()) * 256)


def check_gn(args, gn_kw, cam, tag: str, quiet: bool = False):
    """K2 against its plain burst (gn_iterate) on one burst's inputs: X
    within GN_ATOL, equal terms, inliers within 1; fail on a mismatch.
    Returns (max_abs_err of X, active rows, iterations the plain burst ran)."""
    from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo
    from srrg2_proslam_tpu_torch.ops.gn import gn_iterate, stereo_projective_system

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
    if not quiet:
        print(f"K2 gn    {tag} C={pts.shape[0]} active={active} "
              f"iterations={len(iterations_run)}: max_abs_err(X) {err:.3e} (tolerance "
              f"{GN_ATOL}); terms {int(sk.num_terms)}/{int(sp.num_terms)} inliers "
              f"{int(sk.num_inliers)}/{int(sp.num_inliers)} chi {float(sk.chi_total):.4f}/"
              f"{float(sp.chi_total):.4f}", flush=True)
    if not (err <= GN_ATOL and int(sk.num_terms) == int(sp.num_terms)
            and abs(int(sk.num_inliers) - int(sp.num_inliers)) <= 1):
        fail(f"GN burst kernel disagrees with its plain version on {tag}: X err {err:.3e}, "
             f"terms {int(sk.num_terms)}/{int(sp.num_terms)}, inliers "
             f"{int(sk.num_inliers)}/{int(sp.num_inliers)}")
    return err, active, len(iterations_run)


@contextlib.contextmanager
def recorded(module, name: str, keep=None):
    """``module.name`` wrapped for the block: the list it yields collects the
    arguments (args, kw; tensors cloned) of each call whose index ``keep``
    picks, of every call where ``keep`` is None."""
    import torch

    real, calls, seen = getattr(module, name), [], [0]

    def wrapped(*args, **kw):
        if keep is None or keep(seen[0]):
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args), kw))
        seen[0] += 1
        return real(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def run_vo(frames, cam, device, adapt_cfg, track_cfg):
    """The port's main path over the frames; returns (per-frame stats, poses)."""
    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import initial_state, track_step

    state = initial_state(4096, track_cfg.landmark_estimator, device=device)
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


def slam_config(local_ba: bool = False):
    """tests/test_rendered_e2e.py's GraphSLAM config (with local BA on if
    asked); the rest at defaults."""
    from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig
    from srrg2_proslam_tpu_torch.models.slam import (
        GraphSLAMConfig, LocalBAConfig, SplittingConfig)

    return GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=4.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        local_ba=LocalBAConfig(enabled=local_ba),
        arena_capacity=4096, database_capacity=8192, max_db_descriptors_per_map=384)


def run_slam(frames, cam, device, adapt_cfg, budget_s=None, min_maps=0,
             model="stereo", config=None):
    """adapt -> GraphSLAM.process over image pairs on ``device``: (left,
    right) through adapt_stereo, or with ``model="rgbd"`` (intensity, raw
    depth) through adapt_rgbd; ``config`` defaults to ``slam_config()``.
    Returns (slam, per-frame (status, map) rows).  With ``budget_s`` the
    run stops at the first frame past the budget once the graph holds
    ``min_maps`` maps."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_rgbd, adapt_stereo
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    adapt = adapt_stereo if model == "stereo" else adapt_rgbd
    slam = GraphSLAM(cam, config or slam_config(), model=model, device=device)
    rows = []
    t0 = time.perf_counter()
    for (a, b), stamp in frames:
        meas = adapt(a, b, adapt_cfg)
        slam.process(meas.points, meas.desc, meas.valid, stamp)
        rows.append((slam.status, slam.current_map))
        if (budget_s is not None and time.perf_counter() - t0 > budget_s
                and slam.num_maps >= min_maps):
            break
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return slam, rows


def slam_counts(slam) -> dict:
    return {k: getattr(slam, k) for k in ("num_maps", "num_edges", "num_closures",
                                          "num_relocalizations", "num_losses",
                                          "num_backstop_rejections")}


def query_memory(dev, smi, q_desc, q_valid):
    """The loop query at the default database size (64 slots of 1024) with a
    real split's query rows (``q_desc`` [4096, 256], ``q_valid``), dense and
    tiled (query_tile 8192): peak allocated bytes above the inputs and time
    per call.  Four slots hold noisy copies (8 of 256 bits flipped) of n,
    3n/4, n/2 and n/4 of the valid query rows (n up to 1024), the rest
    random bits, so the top 4 candidates are known and their votes and
    masks are not empty."""
    import torch

    from srrg2_proslam_tpu_torch.models import loop_closure as lc

    g = torch.Generator(device=dev).manual_seed(0)
    desc = (torch.randint(0, 2, (64, 1024, 256), generator=g, device=dev,
                          dtype=torch.int8) * 2 - 1)
    rows = q_desc[q_valid]
    n = min(1024, rows.shape[0])
    seeded = {5: n, 23: 3 * n // 4, 40: n // 2, 58: n // 4}
    for slot, count in seeded.items():
        flips = torch.rand((count, 256), generator=g, device=dev).argsort(dim=1)[:, :8]
        copy = rows[:count].clone()
        copy.scatter_(1, flips, -copy.gather(1, flips))
        desc[slot, :count] = copy
    db = lc.empty_database(65536, 1024, dev)
    db = db._replace(desc=desc, valid=torch.ones_like(db.valid),
                     map_id=torch.arange(64, dtype=torch.int32, device=dev),
                     next=torch.tensor(64, dtype=torch.int32, device=dev))
    query_map = 80
    results = []
    for tile in (0, 8192):
        cfg = lc.LoopDetectorConfig(query_tile=tile)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        results.append(lc.query(q_desc, q_valid, query_map, db, cfg, 512))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        ms = cuda_ms(lambda: lc.query(q_desc, q_valid, query_map, db, cfg, 512),
                     reps=5, warmup=1)
        print(f"  loop query [{q_desc.shape[0]} x 64 x 1024], query_tile {tile}: peak "
              f"{peak / 2**30:.3f} GiB above the inputs, {ms:.3f} ms/call (CUDA events) "
              f"[{smi}]", flush=True)
    dense = results[0]
    if not all(torch.equal(a, b) for a, b in zip(*results)):
        fail("tiled loop query disagrees with the dense one")
    cands, votes = dense.candidate_maps.tolist(), dense.votes.tolist()
    print(f"  candidates {cands}, votes {votes}, matched rows "
          f"{dense.match_mask.sum(1).tolist()} ({rows.shape[0]} valid query rows; "
          f"tiled equals dense)", flush=True)
    if cands != [s for s in sorted(seeded, key=seeded.get, reverse=True)] \
            or not all(v > 0 for v in votes):
        fail(f"loop query at the default size missed the seeded slots {seeded}")


def icl_fixture_pose():
    """camera_01 in camera_00 from the fixture's GT poses (fixtures.hpp:
    597-608, as tests/test_rgbd_integration.py:30-37 builds them)."""
    import numpy as np

    from srrg2_proslam_tpu_torch.io.quaternions import quaternion_to_rotation

    def pose(t, q_wxyz):
        T = np.eye(4)
        w, x, y, z = q_wxyz
        T[:3, :3] = quaternion_to_rotation(np.array([x, y, z, w]))
        T[:3, 3] = t
        return T

    T_w_c0 = pose([0.0, 0.0, -2.25], [1.0, 0.0, 0.0, 0.0])
    T_w_c1 = pose([0.000466347, 0.00895357, -2.24935],
                  [0.999999, -0.00101358, 0.00052453, -0.000231475])
    return (np.linalg.inv(T_w_c0) @ T_w_c1).astype(np.float32)


def loop_gate(slam, gt, tag: str, smi: str):
    """tests/test_rendered_e2e.py's gates on a GraphSLAM run of the loop."""
    from srrg2_proslam_tpu_torch.metrics import trajectory

    err = trajectory.evaluate(slam.trajectory(), gt)
    rmse = err.mean_translation_rmse
    gate = (len(gt) >= E2E_MIN_FRAMES and slam.num_maps >= E2E_MIN_MAPS
            and slam.num_closures >= 1 and slam.num_relocalizations >= 1
            and bool((rmse <= E2E_T_RMSE).all()) and err.mean_rotation_deg <= E2E_ROT_DEG
            and err.ate_rmse <= E2E_ATE)
    print(f"{tag} gate: t-RMSE per axis {rmse.round(4)} (<= {E2E_T_RMSE}), rotation "
          f"{err.mean_rotation_deg:.4f} deg (<= {E2E_ROT_DEG}), ATE {err.ate_rmse:.4f} m "
          f"(<= {E2E_ATE}), maps {slam.num_maps}, closures {slam.num_closures}, "
          f"relocalisations {slam.num_relocalizations} -> {'PASS' if gate else 'FAIL'} "
          f"[{smi}]", flush=True)
    if not gate:
        fail(f"the {tag} gate failed")


def compare_slam_runs(ref_slam, ref_rows, cpu_slam, cpu_rows, tag: str, smi: str):
    """Two GraphSLAM runs over the same frames (the card's and the CPU's, or
    two modes): per-frame (status, map) rows, counts and closure events
    equal, every pose within SLAM_POSE_TOL_M / SLAM_POSE_TOL_RAD; fail
    otherwise.  Returns the largest |dt| (m)."""
    import numpy as np
    import torch

    from srrg2_proslam_tpu_torch.ops import se3

    if cpu_rows != ref_rows:
        diff = next((i for i, (a, b) in enumerate(zip(ref_rows, cpu_rows)) if a != b),
                    min(len(ref_rows), len(cpu_rows)))
        fail(f"{tag}: the runs part at frame {diff}: {ref_rows[diff]} vs {cpu_rows[diff]}")
    if (slam_counts(ref_slam) != slam_counts(cpu_slam)
            or ref_slam.closure_events != cpu_slam.closure_events):
        fail(f"{tag}: the runs disagree: {slam_counts(ref_slam)} "
             f"{ref_slam.closure_events} vs {slam_counts(cpu_slam)} {cpu_slam.closure_events}")
    dt, dang = se3.error_t_and_angle(torch.from_numpy(np.stack(ref_slam.trajectory())),
                                     torch.from_numpy(np.stack(cpu_slam.trajectory())))
    worst_t = dt.max(dim=1).values
    print(f"{tag} over {len(cpu_rows)} frames: per-frame status and map "
          f"equal, counts and closure events equal; trajectory frame for frame: max |dt| "
          f"{float(worst_t.max()):.3e} m (frame {int(worst_t.argmax())}), max angle "
          f"{float(dang.max()):.3e} rad (frame {int(dang.argmax())}), final |dt| "
          f"{dt[-1].numpy()} (tolerance {SLAM_POSE_TOL_M} m, {SLAM_POSE_TOL_RAD} rad per "
          f"frame) [{smi}]", flush=True)
    if not (float(worst_t.max()) <= SLAM_POSE_TOL_M
            and float(dang.max()) <= SLAM_POSE_TOL_RAD):
        fail(f"{tag}: the trajectories disagree")
    return float(worst_t.max())


def phase_rgbd(dev, smi, report, thr):
    """Phase 6, RGB-D: ICL and the rendered loop through
    adapt_rgbd -> GraphSLAM(model="rgbd"); returns the loop's launches."""
    import numpy as np
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets, synthetic
    from srrg2_proslam_tpu_torch.kernels.brief import brief_descriptors, brief_descriptors_plain
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain
    from srrg2_proslam_tpu_torch.models.frontend import DepthAdaptorConfig
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAMConfig
    from srrg2_proslam_tpu_torch.ops import se3

    dcfg = DepthAdaptorConfig()
    icl = list(datasets.iter_bundled_icl(os.path.join(ROOT, "test_data")))[:2]
    icam = datasets.icl_camera()
    icl_gpu = [((torch.from_numpy(f.intensity).to(dev), torch.from_numpy(f.depth).to(dev)),
                f.timestamp) for f in icl]
    inp = frontend_inputs(icl_gpu[0][0][0][None], dcfg.extractor)
    errs = check_frontend(inp, thr, "ICL frame 0")
    images, smooth, y, x, valid = (inp[k] for k in ("images", "smooth", "y", "x", "valid"))
    fb = fast_bound(images, thr)
    timed = {
        "fast": (lambda: fast_scores_kernel(images, thr), "fast_scores_kernel",
                 lambda: fast_scores_plain(images, thr), (fb["bound_ms"], fb["bound_by"])),
        "brief": (lambda: brief_descriptors(smooth, y, x, valid), "brief_descriptors_kernel",
                  lambda: brief_descriptors_plain(smooth, y, x, valid),
                  brief_bound(smooth, y, x, valid))}
    for kname, (fn, kernel, plain, (b_ms, b_by)) in timed.items():
        r = report[kname]
        r["ms_rgbd"] = device_ms(fn, kernel=kernel)
        r["plain_ms_rgbd"] = device_ms(plain)
        r["bound_ms_rgbd"], r["bound_by_rgbd"] = b_ms, b_by
        r["max_abs_err"] = max(r["max_abs_err"], errs[kname])
        print(f"  {kname} at ICL frame 0 {tuple(images.shape)} ({int(valid.sum())} valid "
              f"keypoints): device {r['ms_rgbd']:.5f} ms/call, plain {r['plain_ms_rgbd']:.5f} "
              f"ms, bound {b_ms:.6f} ms ({b_by}) [{smi}]", flush=True)

    kernels.reset_launch_counts()
    slam, _ = run_slam(icl_gpu, icam, dev, dcfg, model="rgbd", config=GraphSLAMConfig())
    counts = kernels.launch_counts()
    stats = slam.last_stats
    t_err, angle = se3.error_t_and_angle(
        torch.from_numpy(slam.robot_in_world().astype(np.float32)),
        torch.from_numpy(icl_fixture_pose()))
    gate = bool((t_err <= ICL_GATE_T).all()) and float(angle) <= ICL_GATE_ANGLE
    print(f"ICL frames 0 -> 1, GraphSLAM(model=\"rgbd\"): meas {int(stats.num_measurements)} "
          f"inliers {int(stats.num_inliers)} status {slam.status}; |t err| "
          f"{t_err.numpy().round(5)} m angle {float(angle):.5f} rad vs the fixture "
          f"(<= {ICL_GATE_T} m, {ICL_GATE_ANGLE} rad) -> {'PASS' if gate else 'FAIL'}; "
          f"launches {counts} [{smi}]", flush=True)
    if not gate or counts != {"fast": 2, "brief": 2, "gn_burst": 0}:
        fail(f"ICL RGB-D: gate {gate}, launches {counts} != fast 2, brief 2, gn_burst 0")

    scam = synthetic.synthetic_camera()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = list(synthetic.iter_rendered_loop_rgbd(side_a=10.0, side_b=6.0, step_m=0.4,
                                                  turn_frames=10, device=dev))
    torch.cuda.synchronize()
    n = len(loop)
    print(f"rendered loop as RGB-D: {n} frames {tuple(loop[0].intensity.shape)} on the card "
          f"in {time.perf_counter() - t0:.2f} s [{smi}]", flush=True)
    frames = [((f.intensity, f.depth), f.timestamp) for f in loop]
    config = slam_config(local_ba=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam, rows = run_slam(frames, scam, dev, dcfg, model="rgbd", config=config)
    first_pass = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"RGB-D GraphSLAM with local BA: {n} frames, {slam_counts(slam)}, closure events "
          f"{slam.closure_events}; launches {counts} [{smi}]", flush=True)
    if counts != {"fast": n, "brief": n, "gn_burst": 0}:
        fail(f"RGB-D launch counts {counts} != fast {n}, brief {n}, gn_burst 0")
    loop_gate(slam, [f.gt_pose for f in loop], "RGB-D rendered-loop", smi)
    errs = check_frontend(frontend_inputs(frames[0][0][0][None], dcfg.extractor), thr,
                          "rendered loop as RGB-D, frame 0")
    for kname, e in errs.items():
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], e)

    cpu_frames = [((f.intensity.cpu(), f.depth.cpu()), f.timestamp) for f in loop]
    t0 = time.perf_counter()
    cpu_slam, cpu_rows = run_slam(cpu_frames, scam, "cpu", dcfg, budget_s=RGBD_CPU_BUDGET_S,
                                  min_maps=4, model="rgbd", config=config)
    m = len(cpu_rows)
    if m < n:
        print(f"RGB-D CPU run stopped after {m} of {n} frames ({time.perf_counter() - t0:.1f} "
              f"s, {cpu_slam.num_maps} maps): comparing that prefix with a GPU run of it "
              f"[{smi}]", flush=True)
        ref_slam, ref_rows = run_slam(frames[:m], scam, dev, dcfg, model="rgbd", config=config)
    else:
        print(f"RGB-D CPU run over all {n} frames: {time.perf_counter() - t0:.1f} s [{smi}]",
              flush=True)
        ref_slam, ref_rows = slam, rows
    compare_slam_runs(ref_slam, ref_rows, cpu_slam, cpu_rows,
                      "RGB-D loop, GPU vs CPU GraphSLAM", smi)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam2, _ = run_slam(frames, scam, dev, dcfg, model="rgbd", config=config)
    steady = (time.perf_counter() - t0) / n * 1e3
    print(f"RGB-D ms/frame: {steady:.3f} (second pass, adapt_rgbd + process with local BA, "
          f"{slam2.num_maps} maps, no stage timing), first pass {first_pass / n * 1e3:.3f} "
          f"[{smi}]", flush=True)
    return counts


def phase_estimators(dev, smi, report, frames_np, frames_gpu, cam, adapt_cfg):
    """Phase 6, estimators: the 5 KITTI frames with the weighted mean, the
    smoother and the EKF with the motion prior; every GN burst against its
    plain burst."""
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig
    from srrg2_proslam_tpu_torch.ops import se3

    gt = torch.from_numpy(frames_np[-1].gt_pose)
    cpu_frames = [(torch.from_numpy(f.left), torch.from_numpy(f.right)) for f in frames_np]
    gn_errs = []
    for tag, cfg, gn_launches in (
            ("weighted_mean", TrackerConfig(landmark_estimator="weighted_mean"), 15),
            ("smoother", TrackerConfig(landmark_estimator="smoother"), 15),
            ("motion prior 1.0/4.0", TrackerConfig(motion_prior_translation_info=1.0,
                                                   motion_prior_rotation_info=4.0), 0)):
        kernels.reset_launch_counts()
        with recorded(kernels.gn, "gn_burst_stereo") as bursts:
            rows, poses = run_vo(frames_gpu, cam, dev, adapt_cfg, cfg)
        counts = kernels.launch_counts()
        t_err, angle = se3.error_t_and_angle(poses[-1], gt)
        gate = bool((t_err <= torch.tensor(GATE_T)).all()) and float(angle) <= GATE_ANGLE
        cpu_rows, cpu_poses = run_vo(cpu_frames, cam, "cpu", adapt_cfg, cfg)
        dt, dang = se3.error_t_and_angle(poses[-1], cpu_poses[-1])
        errs = [check_gn(args, kw, cam, f"{tag} burst {i}", quiet=True)[0]
                for i, (args, kw) in enumerate(bursts)]
        gn_errs += errs
        print(f"KITTI VO, {tag}: matches {[r['matches'] for r in rows]} inliers "
              f"{[r['inliers'] for r in rows]} merges {[r['merges'] for r in rows]}; |t err| "
              f"{t_err.numpy().round(4)} angle {float(angle):.5f} -> "
              f"{'PASS' if gate else 'FAIL'}; GPU vs CPU final |dt| {dt.numpy()} angle "
              f"{float(dang):.3e}; launches {counts}; {len(bursts)} GN bursts within "
              f"{max(errs, default=0.0):.3e} of their plain bursts [{smi}]", flush=True)
        if not gate:
            fail(f"the 5-frame KITTI gate failed with {tag}")
        if counts != {"fast": 5, "brief": 5, "gn_burst": gn_launches}:
            fail(f"{tag}: launch counts {counts} != fast 5, brief 5, gn_burst {gn_launches}")
        for i, (g, c) in enumerate(zip(rows, cpu_rows)):
            for key in ("meas", "matches", "inliers", "merges", "adds"):
                if abs(g[key] - c[key]) > COUNT_TOL:
                    fail(f"{tag} frame {i} {key}: GPU {g[key]} vs CPU {c[key]} "
                         f"(tolerance {COUNT_TOL})")
        if not (float(dt.max()) <= POSE_TOL_M and float(dang) <= POSE_TOL_RAD):
            fail(f"{tag}: GPU and CPU final poses disagree")
    report["gn_burst"]["max_abs_err_estimators"] = max(gn_errs)
    report["gn_burst"]["max_abs_err"] = max(report["gn_burst"]["max_abs_err"], max(gn_errs))




def phase_adaptor_configs(dev, smi, frames_np, frames_gpu):
    """Phase 7a: the 5 KITTI pairs under the port-loaded euroc_adaptor.json
    (oriented, sub-pixel) and aggressive_motion_adaptor.json (upright,
    sub-pixel) on the card against the port's CPU run."""
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.ops.features import extract_features_batch
    from srrg2_proslam_tpu_torch.utils import config as cfg
    # oriented descriptor bits per frame and u_R px, card vs CPU: the bounds
    # pinned against JAX on the CPU (0 bits and 0 px measured on the H100);
    # read by path, as an installed package named ``tests`` may shadow the
    # repo's directory
    bounds = runpy.run_path(os.path.join(ROOT, "tests", "torch_bounds.py"))
    ORIENTED_BITS, UR_ATOL = bounds["ORIENTED_BITS"], bounds["UR_ATOL"]

    for name in ("euroc_adaptor", "aggressive_motion_adaptor"):
        acfg = cfg.load(os.path.join(ROOT, "configurations", f"{name}.json"))
        oriented = acfg.extractor.oriented
        kernels.reset_launch_counts()
        gpu = [adapt_stereo(l, r, acfg) for l, r in frames_gpu]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {"fast": 5, "brief": 0 if oriented else 5, "gn_burst": 0}
        bits, ur, valid_diff, kp_exact = [], [], [], True
        for (l, r), (lc, rc), g in zip(frames_gpu, (
                (torch.from_numpy(f.left), torch.from_numpy(f.right)) for f in frames_np), gpu):
            c = adapt_stereo(lc, rc, acfg)
            fg = extract_features_batch(torch.stack([l, r]), acfg.extractor)
            fc = extract_features_batch(torch.stack([lc, rc]), acfg.extractor)
            kp_exact &= all(torch.equal(getattr(fg, k).cpu(), getattr(fc, k))
                            for k in ("uv", "response", "valid"))
            g = [t.cpu() for t in g]
            both = g[2] & c.valid
            bits.append(int((g[1][both] != c.desc[both]).sum()))
            valid_diff.append(int((g[2] != c.valid).sum()))
            d = (g[0][both] - c.points[both]).abs()
            ur.append((float(d[:, 2].max()), float(d[:, [0, 1, 3]].max())))
        print(f"KITTI adaptor {name}.json (oriented {oriented}, sub-pixel "
              f"{acfg.subpixel_refinement}), card vs CPU: keypoints bit-exact {kp_exact}; "
              f"valid rows differing per frame {valid_diff}; descriptor bits differing per "
              f"frame {bits} (bound {ORIENTED_BITS if oriented else 0}); u_R max diff "
              f"{max(u for u, _ in ur):.3e} px (bound {UR_ATOL}), uL/v max diff "
              f"{max(o for _, o in ur):.3e}; launches {counts} [{smi}]", flush=True)
        if counts != want:
            fail(f"{name}: launches {counts} != {want}")
        if not kp_exact or max(u for u, _ in ur) > UR_ATOL or max(o for _, o in ur) > 0:
            fail(f"{name}: the card's adaptor disagrees with the CPU run")
        if max(bits) > (ORIENTED_BITS if oriented else 0) or max(valid_diff) > 0:
            fail(f"{name}: descriptor bits {bits} / valid rows {valid_diff} past the bound")


def watch_statuses(slam) -> list:
    """The status after each frame the host consumes, in order: the
    per-frame queue's ``_consume_frame`` and the chunk program's mirror
    ``_consume_chunk_frame`` are wrapped to record it."""
    statuses = []
    for name in ("_consume_frame", "_consume_chunk_frame"):
        consume = getattr(slam, name)

        def consume_and_record(*args, consume=consume):
            out = consume(*args)
            statuses.append(slam.status)
            return out

        setattr(slam, name, consume_and_record)
    return statuses


def run_sequence(frames, cam, device, adapt_cfg, config, model="stereo"):
    """GraphSLAM.process_sequence (the chunk program) over stacked image
    pairs ((left, right), or (intensity, raw depth) with ``model="rgbd"``);
    returns (slam, per-frame (status, map) rows)."""
    import torch

    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    slam = GraphSLAM(cam, config, model=model, device=device)
    statuses = watch_statuses(slam)
    lefts = torch.stack([a for (a, _), _ in frames])
    rights = torch.stack([b for (_, b), _ in frames])
    slam.process_sequence(lefts, rights, [t for _, t in frames], adapt_cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return slam, list(zip(statuses, (f.local_map_index for f in slam.frames)))


def run_speculative(frames, cam, device, adapt_cfg, config):
    """Phase 7's loop: the batched adaptor over each ``chunk_size`` frames
    (one K3 and one K1 launch), then every frame through
    ``process_dispatch`` / ``process_finalize`` at the config's
    speculation depth, then ``flush``: the per-frame speculative queue.
    Returns (slam, per-frame (status, map) rows)."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo_batch
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    slam = GraphSLAM(cam, config, device=device)
    statuses = watch_statuses(slam)
    lefts = torch.stack([a for (a, _), _ in frames])
    rights = torch.stack([b for (_, b), _ in frames])
    B = config.chunk_size
    for start in range(0, len(frames), B):
        meas = adapt_stereo_batch(lefts[start:start + B], rights[start:start + B], adapt_cfg)
        for i in range(meas.points.shape[0]):
            slam.process_dispatch(meas.points[i], meas.desc[i], meas.valid[i],
                                  frames[start + i][1])
            slam.process_finalize()
    slam.flush()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return slam, list(zip(statuses, (f.local_map_index for f in slam.frames)))


def phase_sequence(dev, smi, report, thr, loop, ref_slam, ref_rows, ref_ms, adapt_cfg):
    """Phase 7b: the rendered loop through the speculative per-frame queue
    at phase 5's config with speculation_depth 8, the batched adaptor over
    chunks of 16 (``run_speculative``): K3 and K1 at the first chunk's
    inputs, launches, the gates, phase 5's per-frame run frame for frame,
    and ms/frame.  Returns (the launches, ms/frame)."""
    import dataclasses

    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import synthetic
    from srrg2_proslam_tpu_torch.kernels.brief import brief_descriptors, brief_descriptors_plain
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain

    scam = synthetic.synthetic_camera()
    frames = [((f.left, f.right), f.timestamp) for f in loop]
    n = len(frames)
    config = dataclasses.replace(slam_config(), speculation_depth=SEQ_DEPTH,
                                 chunk_size=SEQ_CHUNK)
    first = torch.cat([torch.stack([f.left for f in loop[:SEQ_CHUNK]]),
                       torch.stack([f.right for f in loop[:SEQ_CHUNK]])])
    inp = frontend_inputs(first, adapt_cfg.extractor)
    errs = check_frontend(inp, thr, f"first chunk of the sequence, B = {2 * SEQ_CHUNK}")
    images, smooth, y, x, valid = (inp[k] for k in ("images", "smooth", "y", "x", "valid"))
    fb = fast_bound(images, thr)
    timed = {
        "fast": (lambda: fast_scores_kernel(images, thr), "fast_scores_kernel",
                 lambda: fast_scores_plain(images, thr), (fb["bound_ms"], fb["bound_by"])),
        "brief": (lambda: brief_descriptors(smooth, y, x, valid), "brief_descriptors_kernel",
                  lambda: brief_descriptors_plain(smooth, y, x, valid),
                  brief_bound(smooth, y, x, valid))}
    for kname, (fn, kernel, plain, (b_ms, b_by)) in timed.items():
        r = report[kname]
        r["ms_b32"] = device_ms(fn, kernel=kernel)
        r["plain_ms_b32"] = device_ms(plain)
        r["bound_ms_b32"], r["bound_by_b32"] = b_ms, b_by
        r["max_abs_err"] = max(r["max_abs_err"], errs[kname])
        print(f"  {kname} at the first chunk {tuple(images.shape)} ({int(valid.sum())} valid "
              f"keypoints): device {r['ms_b32']:.5f} ms/call, plain {r['plain_ms_b32']:.5f} "
              f"ms, bound {b_ms:.6f} ms ({b_by}) [{smi}]", flush=True)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam, rows = run_speculative(frames, scam, dev, adapt_cfg, config)
    first_pass = time.perf_counter() - t0
    counts = kernels.launch_counts()
    chunks = -(-n // SEQ_CHUNK)
    gn_want = 3 * (n + slam.num_replayed_frames)
    print(f"speculative queue (speculation_depth {SEQ_DEPTH}, adaptor per {SEQ_CHUNK}): {n} "
          f"frames, {slam_counts(slam)}, {slam.num_replayed_frames} frames replayed "
          f"({slam.num_reloc_rollbacks} relocalisation rollbacks, {slam.num_reloc_replays} "
          f"frames replayed there); launches {counts}, predicted fast {chunks}, brief "
          f"{chunks}, gn_burst 3 x ({n} + {slam.num_replayed_frames}) = {gn_want} [{smi}]",
          flush=True)
    if counts != {"fast": chunks, "brief": chunks, "gn_burst": gn_want}:
        fail(f"sequence launch counts {counts} != fast {chunks}, brief {chunks}, "
             f"gn_burst {gn_want}")
    loop_gate(slam, [f.gt_pose for f in loop], "speculative rendered-loop", smi)
    compare_slam_runs(ref_slam, ref_rows, slam, rows,
                      "speculative queue vs phase 5's per-frame GraphSLAM", smi)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_speculative(frames, scam, dev, adapt_cfg, config)
    steady = (time.perf_counter() - t0) / n * 1e3
    print(f"sequence ms/frame: {steady:.3f} (second pass, the speculative queue with the "
          f"batched adaptor, speculation_depth {SEQ_DEPTH}), first pass "
          f"{first_pass / n * 1e3:.3f}; phase 5 per-frame GraphSLAM ms/frame {ref_ms:.3f} "
          f"[{smi}]", flush=True)
    return counts, steady


def phase_shipped(dev, smi, frames_np, frames_gpu):
    """Phase 7c: kitti_slam.json + kitti_adaptor.json through
    process_sequence over the 5 KITTI pairs on the card against the CPU,
    and every shipped SLAM config constructs a GraphSLAM on the card."""
    import glob

    import torch

    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM
    from srrg2_proslam_tpu_torch.utils import config as cfg

    conf = os.path.join(ROOT, "configurations")
    scfg = cfg.load(os.path.join(conf, "kitti_slam.json"))
    acfg = cfg.load(os.path.join(conf, "kitti_adaptor.json"))
    cam = datasets.kitti_camera(*frames_np[0].left.shape)
    stamps = [f.timestamp for f in frames_np]
    gpu, gpu_rows = run_sequence(list(zip(frames_gpu, stamps)), cam, dev, acfg, scfg)
    cpu, cpu_rows = run_sequence(
        [((torch.from_numpy(f.left), torch.from_numpy(f.right)), f.timestamp)
         for f in frames_np], cam, "cpu", acfg, scfg)
    compare_slam_runs(gpu, gpu_rows, cpu, cpu_rows,
                      "KITTI, kitti_slam.json + kitti_adaptor.json, process_sequence, GPU vs CPU",
                      smi)
    names = []
    for path in sorted(glob.glob(os.path.join(conf, "*_slam.json"))):
        name = os.path.basename(path)[:-len("_slam.json")]
        model = "rgbd" if name in ("icl", "tum") else "stereo"
        GraphSLAM(cam, cfg.load(path), model=model, device=dev)
        names.append(name)
    print(f"shipped SLAM configs constructed on the card: {names} [{smi}]", flush=True)
    if len(names) != 6:
        fail(f"expected 6 shipped SLAM configs, found {names}")


# phase 8's files, in the git-ignored build directory, removed at its end
HOST_DIR = os.path.join(ROOT, "srrg2_proslam_tpu_torch", "build", "host_surface")
APP_POSE_TOL_M = 1e-3        # 8a: the app's trajectory, card vs --device cpu
CKPT_POSE_TOL_M = 1e-4       # 8d: resumed card run vs phase 5's (as phase 7's card runs)
CKPT_CPU_BUDGET_S = 60.0     # 8d: the CPU continuation stops after this
ENTRY_TOL = 5e-4             # 8f: entry()'s step, card vs CPU (tests/test_gn_pallas.py)
KERNEL_NAMES = ("fast_scores_kernel", "brief_descriptors_kernel", "gn_burst_stereo_kernel")
IMAGE_FIXTURES = os.path.join(ROOT, "test_data", "torch_io")   # 8g: files and MANIFEST.json
DECODE_REPS = 20             # 8g: decodes per timed file
# 8g: the full-size folders read through the library and the folder readers
# only (the twin's tier-1 in Python takes minutes on a 480 x 640 JPEG 2000)
LIBRARY_ONLY = ("tum_jp2/", "kitti_zstd/", "kitti_webp_anim/")
TIFF_GN_ATOL = 2e-6          # 8g: K2 against its plain version at the TIFF pair


def run_app(module: str, argv, tag: str):
    """An app's ``main(argv)`` in this process -> (exit code, stdout lines);
    its output is echoed with ``tag``."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"srrg2_proslam_tpu_torch.apps.{module}").main
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code or 0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  [{tag}] {line}", flush=True)
    return code, lines


def app_result(lines) -> dict:
    return json.loads(lines[-1])


def kitti_traj(prefix: str):
    import numpy as np

    return np.loadtxt(prefix + "_kitti.txt").reshape(-1, 3, 4)


def phase_host(dev, smi, report, frames_np, loop, ref_slam, ref_rows, ref_ms, adapt_cfg):
    """Phase 8, the host surface on the card: the port's apps, checkpoints,
    trace, entry(), the native decoder and the second image library.
    Returns the app runs' launches."""
    import shutil

    import numpy as np
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.entry import entry
    from srrg2_proslam_tpu_torch.io import checkpoint, datasets, native, synthetic
    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM
    from srrg2_proslam_tpu_torch.ops import se3

    shutil.rmtree(HOST_DIR, ignore_errors=True)
    seq = os.path.join(HOST_DIR, "kitti_city")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub))
    for i, f in enumerate(frames_np):
        datasets.save_gray(os.path.join(seq, "image_0", f"{i:06d}.png"), f.left)
        datasets.save_gray(os.path.join(seq, "image_1", f"{i:06d}.png"), f.right)
    np.savetxt(os.path.join(seq, "times.txt"), [f.timestamp for f in frames_np])
    poses = os.path.join(seq, "poses.txt")
    np.savetxt(poses, np.stack([f.gt_pose[:3].reshape(-1) for f in frames_np]))
    launches = {}

    # ---- 8a: app_benchmark on the KITTI folder, card and CPU ----
    kitti = ["--dataset", "kitti", "--sequence", seq, "--gt", poses]
    out_gpu, out_cpu = os.path.join(HOST_DIR, "kitti_gpu"), os.path.join(HOST_DIR, "kitti_cpu")
    kernels.reset_launch_counts()
    code, lines = run_app("app_benchmark", kitti + ["--output", out_gpu], "8a card")
    launches["app_kitti"] = kernels.launch_counts()
    res = app_result(lines)
    code_cpu, lines_cpu = run_app("app_benchmark", kitti + ["--output", out_cpu,
                                                            "--device", "cpu"], "8a cpu")
    res_cpu = app_result(lines_cpu)
    t_gpu, t_cpu = kitti_traj(out_gpu), kitti_traj(out_cpu)
    dt = float(np.abs(t_gpu[:, :, 3] - t_cpu[:, :, 3]).max())
    print(f"8a app_benchmark --dataset kitti: exit {code}, regression {res['regression']}, "
          f"mean_frame_hz {res['mean_frame_hz']:.3f}, launches {launches['app_kitti']}; "
          f"--device cpu: exit {code_cpu}, regression {res_cpu['regression']}; trajectory "
          f"card vs cpu max |dt| {dt:.3e} m (tolerance {APP_POSE_TOL_M}) [{smi}]", flush=True)
    if launches["app_kitti"] != {"fast": 5, "brief": 5, "gn_burst": 15}:
        fail(f"8a launches {launches['app_kitti']} != fast 5, brief 5, gn_burst 15")
    # the JAX app reports regression true and exits 1 on these 5 frames
    # (tests/test_torch_app.py holds the port's CPU run to it): the card's
    # run must report what the CPU run reports
    if (code, res["regression"]) != (code_cpu, res_cpu["regression"]) or dt > APP_POSE_TOL_M:
        fail("8a: the card's app run disagrees with the CPU's")
    for path in (out_gpu + "_kitti.txt", out_gpu + "_tum.txt"):
        if not os.path.getsize(path):
            fail(f"8a: {path} is empty")

    # ---- 8b: the folder as a BOSS log, through --dataset boss ----
    log = os.path.join(HOST_DIR, "boss", "messages.json")
    os.makedirs(os.path.dirname(log))
    code, _ = run_app("convert_dataset", ["--dataset", "kitti", "--sequence", seq, "--gt",
                                          poses, "--format", "boss", "--output", log],
                      "8b convert")
    out_boss = os.path.join(HOST_DIR, "boss_gpu")
    kernels.reset_launch_counts()
    code_b, lines = run_app("app_benchmark", ["--dataset", "boss", "--sequence", log,
                                              "--output", out_boss], "8b card")
    launches["app_boss"] = kernels.launch_counts()
    t_boss = kitti_traj(out_boss)
    same = t_boss.shape == t_gpu.shape and bool((t_boss == t_gpu).all())
    print(f"8b --dataset boss: convert exit {code}, app exit {code_b}, launches "
          f"{launches['app_boss']}, trajectory equal to 8a's frame for frame: {same} [{smi}]",
          flush=True)
    if code != 0 or not same:
        fail("8b: the BOSS log's run differs from the folder's")

    # ---- 8c: the rendered loop through --chunked (the chunk program) ----
    from srrg2_proslam_tpu_torch.models import slam as slam_mod
    from srrg2_proslam_tpu_torch.utils import graphs

    apps_slam = []
    real_seq = slam_mod.GraphSLAM.process_sequence

    def recording(self, *args, **kw):
        apps_slam.append(self)
        return real_seq(self, *args, **kw)

    before = set(graphs.programs())
    kernels.reset_launch_counts()
    slam_mod.GraphSLAM.process_sequence = recording
    try:
        code, lines = run_app("app_benchmark", ["--dataset", "synthetic", "--count", "145",
                                                "--chunked", "16"], "8c card")
    finally:
        slam_mod.GraphSLAM.process_sequence = real_seq
    launches["app_chunked"] = kernels.launch_counts()
    res = app_result(lines)
    want, warm = chunk_launches_wanted(apps_slam[0], before)
    print(f"8c --dataset synthetic --count 145 --chunked 16: exit {code}, regression "
          f"{res['regression']}, mean_frame_hz {res['mean_frame_hz']:.3f} (phase 5 per-frame "
          f"GraphSLAM {1e3 / ref_ms:.3f} frames/s in this call), launches "
          f"{launches['app_chunked']}, predicted {want} (chunk program: "
          f"{apps_slam[0].chunk_stats}, {warm} warm-up frames) [{smi}]", flush=True)
    if code != 0 or res["regression"]:
        fail("8c: the synthetic regression gate failed")
    if launches["app_chunked"] != want or apps_slam[0].chunk_stats["graph_replays"] == 0:
        fail(f"8c launches {launches['app_chunked']} != {want}, or no chunk graph replayed")

    # ---- 8d: checkpoint at frame 72 of phase 5's loop, card and CPU ----
    scam = synthetic.synthetic_camera()
    half = len(loop) // 2
    meas = []
    first = GraphSLAM(scam, slam_config(), device=dev)
    rows = []
    for f in loop:
        m = adapt_stereo(f.left, f.right, adapt_cfg)
        meas.append((m.points, m.desc, m.valid, f.timestamp))
    for p, d, ok, stamp in meas[:half]:
        first.process(p, d, ok, stamp)
        rows.append((first.status, first.current_map))
    path = os.path.join(HOST_DIR, "loop_ckpt.npz")
    checkpoint.save(first, path)
    resumed = checkpoint.load(GraphSLAM(scam, slam_config(), device=dev), path)
    for p, d, ok, stamp in meas[half:]:
        resumed.process(p, d, ok, stamp)
        rows.append((resumed.status, resumed.current_map))
    torch.cuda.synchronize()
    if rows != ref_rows or slam_counts(resumed) != slam_counts(ref_slam) \
            or resumed.closure_events != ref_slam.closure_events:
        fail(f"8d: the resumed card run differs from phase 5's: {slam_counts(resumed)} "
             f"{resumed.closure_events} vs {slam_counts(ref_slam)} {ref_slam.closure_events}")
    A, B = (torch.from_numpy(np.stack(s.trajectory())) for s in (resumed, ref_slam))
    d_res = float(se3.error_t_and_angle(A, B)[0].max())
    print(f"8d checkpoint at frame {half} of {len(loop)} ({os.path.getsize(path)} bytes), "
          f"loaded into a fresh card GraphSLAM: per-frame status and map, counts and closure "
          f"events equal phase 5's, max |dt| {d_res:.3e} m (tolerance {CKPT_POSE_TOL_M}) "
          f"[{smi}]", flush=True)
    if d_res > CKPT_POSE_TOL_M:
        fail("8d: the resumed card run's poses differ from phase 5's")
    cpu = checkpoint.load(GraphSLAM(scam, slam_config(), device="cpu"), path)
    t0 = time.perf_counter()
    n_cpu = 0
    for p, d, ok, stamp in meas[half:]:
        cpu.process(p.cpu(), d.cpu(), ok.cpu(), stamp)
        n_cpu += 1
        if time.perf_counter() - t0 > CKPT_CPU_BUDGET_S:
            break
    A = torch.from_numpy(np.stack(cpu.trajectory()))
    B = torch.from_numpy(np.stack(resumed.trajectory()[:len(cpu.frames)]))
    d_cpu = float(se3.error_t_and_angle(A, B)[0].max())
    cpu_maps = [f.local_map_index for f in cpu.frames]
    print(f"8d the same checkpoint continued on the CPU over frames {half}-{half + n_cpu - 1} "
          f"(the card's measurements; {time.perf_counter() - t0:.1f} s): maps equal "
          f"{cpu_maps == [f.local_map_index for f in resumed.frames[:len(cpu.frames)]]}, "
          f"max |dt| vs the card {d_cpu:.3e} m (tolerance {APP_POSE_TOL_M}) [{smi}]", flush=True)
    if d_cpu > APP_POSE_TOL_M or cpu_maps != [f.local_map_index for f in
                                              resumed.frames[:len(cpu.frames)]]:
        fail("8d: the CPU continuation differs from the card's")

    # ---- 8e: 8a under --trace-dir ----
    trace_dir = os.path.join(HOST_DIR, "trace")
    run_app("app_benchmark", kitti + ["--trace-dir", trace_dir], "8e card")
    trace = os.path.join(trace_dir, "trace.json")
    with open(trace) as f:
        text = f.read()
    named = {k: text.count(k) for k in KERNEL_NAMES}
    print(f"8e trace {trace}: {len(text)} bytes, kernel name counts {named} [{smi}]",
          flush=True)
    if not all(named.values()):
        fail(f"8e: the trace does not name every kernel: {named}")

    # ---- 8f: entry() ----
    fn, args = entry(device=dev)
    kernels.reset_launch_counts()
    state, stats, _ = fn(*args)
    torch.cuda.synchronize()
    launches["entry"] = kernels.launch_counts()
    fn_cpu, args_cpu = entry(device="cpu")
    state_cpu, stats_cpu, _ = fn_cpu(*args_cpu)
    d_entry = float((state.T_lm_robot.cpu() - state_cpu.T_lm_robot).abs().max())
    print(f"8f entry(): inliers {int(stats.num_inliers)} (cpu {int(stats_cpu.num_inliers)}), "
          f"launches {launches['entry']}, pose vs cpu max |d| {d_entry:.3e} (tolerance "
          f"{ENTRY_TOL}) [{smi}]", flush=True)
    if launches["entry"] != {"fast": 0, "brief": 0, "gn_burst": 3} or d_entry > ENTRY_TOL:
        fail("8f: entry()'s step on the card is off")

    # ---- the native decoder and its prefetcher ----
    t0 = time.perf_counter()
    so = native.build()
    files = sorted(glob.glob(os.path.join(ROOT, "test_data", "kitti", "*", "*.png"))
                   + glob.glob(os.path.join(ROOT, "test_data", "icl", "*"))
                   + glob.glob(os.path.join(ROOT, "test_data", "xtion", "*"))
                   + glob.glob(os.path.join(ROOT, "test_data", "scene_flow", "*.png")))
    for fpath in files:
        a, b = native.decode(fpath), datasets.decode_plain(fpath)
        if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
            fail(f"native decoder differs from the plain one on {fpath}")
    with native.Prefetcher(files) as pf:
        for fpath, arr in zip(files, pf):
            if not np.array_equal(arr, datasets.decode_plain(fpath)):
                fail(f"the prefetcher's {fpath} differs")
    print(f"native library {os.path.basename(so)} built and checked in "
          f"{time.perf_counter() - t0:.2f} s: {len(files)} bundled images equal to the plain "
          f"decoder, the prefetcher in order [{smi}]", flush=True)
    launches.update(host_images(dev, smi, report))
    shutil.rmtree(HOST_DIR)
    return launches


def _sha_f32(arr) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()


def host_images(dev, smi, report) -> dict:
    """8g: the files the native decoder refuses, on a machine with no PIL.
    The committed fixtures (JPEG, PNG, BMP, and the KITTI- and TUM-layout
    TIFF folders) decode through the second image library and its plain
    twin to the manifest's SHA-256 of the JAX package's load_gray and
    load_depth; the KITTI JPEG pairs as a Malaga folder through
    iter_malaga_stereo, and the KITTI TIFF pairs through
    iter_kitti_odometry, then adapt_stereo -> track_step on the card (K3,
    K1 and K2 against their plain versions at these frames, K2 within
    TIFF_GN_ATOL on the TIFF pair, the run against the CPU's); the TUM TIFF
    folder (16-bit and float32 depth) through iter_tum_rgbd, then
    adapt_rgbd -> track_step(model="rgbd") (K3 and K1 bit-exact, the run
    against the CPU's); the KITTI TGA folder (RLE) as the TIFF one; the
    later fixtures (CCITT, JPEG and YCbCr TIFF, orientation 6, BigTIFF with
    fill order 2, a block-smoothed progressive JPEG, TGA, DDS, SGI, PCX,
    ICO, QOI, IM, XBM, MSP, lossless and lossy WebP, JPEG 2000 and ZSTD
    TIFF) to the manifest; the KITTI ZSTD folder as the TIFF one and the
    TUM JPEG 2000 folder as the TUM TIFF one, both through the library
    only (LIBRARY_ONLY); the KITTI animated WebP folder as the TIFF one
    (library only) and the BC6H DDS files (unsigned and signed) to the
    manifest; save_gray to .jpg, .tif, .gif, .tga, .sgi, .pcx,
    .dds and .im writes PIL's files; ms per decode.  Returns the runs'
    launches by path."""
    import hashlib
    import shutil

    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets, images, images_plain, native
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig
    from srrg2_proslam_tpu_torch.ops import se3

    with open(os.path.join(IMAGE_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    so = images.build()
    names = sorted(n for n in manifest if not n.startswith("save_gray"))
    for name in names:
        path, want = os.path.join(IMAGE_FIXTURES, name), manifest[name]
        if native.try_decode(path) is not None:
            fail(f"8g: the native decoder reads {name}: it would not test the image library")
        routes = {"library": (datasets.load_gray(path), datasets.load_depth(path))}
        if not name.startswith(LIBRARY_ONLY):
            plain = images_plain.decode(path)
            routes["plain twin"] = (images.gray_f32(plain), images.depth_f32(plain))
        for route, (gray, depth) in routes.items():
            if (_sha_f32(gray), _sha_f32(depth)) != (want["load_gray_sha256"],
                                                     want["load_depth_sha256"]):
                fail(f"8g {name}: the {route}'s load_gray / load_depth differ from the "
                     "manifest's SHA-256 of the JAX package's")
    print(f"8g image library {so.name} built; {len(names)} fixtures ({', '.join(names)}): "
          f"load_gray and load_depth equal to the manifest's SHA-256 of the JAX package's "
          f"through the library and its plain twin (those under {', '.join(LIBRARY_ONLY)} "
          f"through the library) ({time.perf_counter() - t0:.2f} s) [{smi}]", flush=True)

    # the KITTI JPEG pairs in the Malaga layout
    folder = os.path.join(HOST_DIR, "malaga")
    os.makedirs(os.path.join(folder, "Images"))
    for i in (0, 1):
        stamp = f"img_CAMERA1_{1261228749.918590 + 0.05 * i:.6f}"
        for side in ("left", "right"):
            shutil.copy(os.path.join(IMAGE_FIXTURES, f"kitti_{side}_{i}.jpg"),
                        os.path.join(folder, "Images", f"{stamp}_{side}.jpg"))
    frames = list(datasets.iter_malaga_stereo(folder))
    same = len(frames) == 2 and all(
        _sha_f32(getattr(fr, side)) == manifest[f"kitti_{side}_{i}.jpg"]["load_gray_sha256"]
        for i, fr in enumerate(frames) for side in ("left", "right"))
    print(f"8g iter_malaga_stereo over {folder}/Images (2 KITTI JPEG pairs, pair 1 with "
          f"restart markers): {len(frames)} frames, equal to the manifest: {same} [{smi}]",
          flush=True)
    if not same:
        fail("8g: iter_malaga_stereo's JPEG frames differ from the manifest")

    cam = datasets.kitti_camera(*frames[0].left.shape)
    adapt_cfg, track_cfg = StereoAdaptorConfig(), TrackerConfig()
    gpu = [(torch.from_numpy(f.left).to(dev), torch.from_numpy(f.right).to(dev))
           for f in frames]
    errs, _ = check_kernels(main_path_inputs(gpu, cam, adapt_cfg, track_cfg), cam,
                            adapt_cfg.extractor.detector_threshold, "KITTI JPEG frames 0/1")
    for kname, err in errs.items():
        report[kname]["max_abs_err_jpeg"] = err
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], err)
    kernels.reset_launch_counts()
    rows, poses = run_vo(gpu, cam, dev, adapt_cfg, track_cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_rows, cpu_poses = run_vo([(torch.from_numpy(f.left), torch.from_numpy(f.right))
                                  for f in frames], cam, "cpu", adapt_cfg, track_cfg)
    dt, dang = se3.error_t_and_angle(poses[-1], cpu_poses[-1])
    for i, (g, c) in enumerate(zip(rows, cpu_rows)):
        print(f"8g JPEG frame {i}: meas={g['meas']} matches={g['matches']} "
              f"inliers={g['inliers']} map={g['map']} (cpu meas={c['meas']} "
              f"matches={c['matches']} inliers={c['inliers']})", flush=True)
    print(f"8g VO on the JPEG frames: launches {counts}; final pose vs the CPU run |dt| "
          f"{dt.numpy()} angle {float(dang):.3e} [{smi}]", flush=True)
    if counts != {"fast": 2, "brief": 2, "gn_burst": 6}:
        fail(f"8g launches {counts} != fast 2, brief 2, gn_burst 6")
    if any(abs(g[k] - c[k]) > COUNT_TOL for g, c in zip(rows, cpu_rows)
           for k in ("meas", "matches", "inliers")) or not (
            float(dt.max()) <= POSE_TOL_M and float(dang) <= POSE_TOL_RAD):
        fail("8g: VO on the JPEG frames differs between the card and the CPU")

    # save_gray to .jpg, .tif and .gif writes PIL's files
    for key in sorted(k for k in manifest if k.startswith("save_gray")):
        want = manifest[key]
        out = os.path.join(HOST_DIR, "save_gray" + want["extension"])
        datasets.save_gray(out, datasets.load_gray(os.path.join(ROOT, want["source"])))
        with open(out, "rb") as f:
            file_ok = hashlib.sha256(f.read()).hexdigest() == want["pil_file_sha256"]
        read_ok = (_sha_f32(datasets.load_gray(out)) == want["load_gray_sha256"]
                   and _sha_f32(images.gray_f32(images_plain.decode(out)))
                   == want["load_gray_sha256"])
        print(f"8g save_gray({os.path.basename(out)}) of {want['source']}: PIL's file byte "
              f"for byte {file_ok}, decode equal to the manifest (library and twin) "
              f"{read_ok} [{smi}]", flush=True)
        if not (file_ok and read_ok):
            fail(f"8g: save_gray's {want['extension']} file differs from PIL's")

    counts_tiff_vo = kitti_folder_vo(dev, smi, report, manifest, "kitti_tiff", "tiff",
                                     "pair 0 8-bit LZW + predictor 2, pair 1 16-bit")
    counts_tga_vo = kitti_folder_vo(dev, smi, report, manifest, "kitti_tga", "tga",
                                    "run-length-encoded TGA")
    counts_tiff_rgbd = tum_folder_rgbd(dev, smi, report, manifest, "tum_tiff", "tiff",
                                       "depth 16-bit and float32 TIFF")
    counts_zstd_vo = kitti_folder_vo(dev, smi, report, manifest, "kitti_zstd", "zstd",
                                     "pair 0 8-bit Zstandard + predictor 2, pair 1 16-bit")
    counts_jp2_rgbd = tum_folder_rgbd(dev, smi, report, manifest, "tum_jp2", "jp2",
                                      "RGB 9/7 JP2 in three layers, depth 16-bit 5/3 J2K")
    counts_webp_vo = kitti_folder_vo(dev, smi, report, manifest, "kitti_webp_anim", "webp",
                                     "lossless animated WebP, the first of two frames")

    # ms per decode on this machine's host
    for name in ("kitti_left_0.jpg", "icl_rgb_0_progressive_420.jpg",
                 "kitti_tiff/image_0/000000.tif", "kitti_tiff/image_0/000001.tif",
                 "tum_tiff/depth/0.tif", "tum_tiff/depth/1.tif",
                 "kitti_tga/image_0/000000.tga", "icl_dxt1.dds", "kitti_ccitt_g4.tif",
                 "icl_jpeg_ycbcr_420.tif", "icl_progressive_3_scans.jpg",
                 "tum_jp2/rgb/0.jp2", "tum_jp2/depth/0.j2k", "kitti_zstd/image_0/000000.tif",
                 "kitti_webp_anim/image_0/000000.webp", "bc6h_unsigned.dds",
                 "bc6h_signed.dds"):
        path = os.path.join(IMAGE_FIXTURES, name)
        shape = images.decode(path).samples.shape
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            images.decode(path)
        lib_ms = (time.perf_counter() - t0) / DECODE_REPS * 1e3
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            datasets.load_gray(path)
        gray_ms = (time.perf_counter() - t0) / DECODE_REPS * 1e3
        plain = "not run (library only)"
        if not name.startswith(LIBRARY_ONLY):
            t0 = time.perf_counter()
            images_plain.decode(path)
            plain = f"{(time.perf_counter() - t0) * 1e3:.1f} ms (one call)"
        print(f"8g decode {name} {shape[0]}x{shape[1]}x{shape[2]} "
              f"({os.path.getsize(path)} bytes) on the host: images.decode {lib_ms:.3f} ms, "
              f"load_gray {gray_ms:.3f} ms (mean of {DECODE_REPS}), plain twin {plain} "
              f"[{smi}]", flush=True)
    return {"jpeg_vo": counts, "tiff_vo": counts_tiff_vo, "tga_vo": counts_tga_vo,
            "tiff_rgbd": counts_tiff_rgbd, "zstd_vo": counts_zstd_vo,
            "jp2_rgbd": counts_jp2_rgbd, "webp_anim_vo": counts_webp_vo}


def kitti_folder_vo(dev, smi, report, manifest, folder: str, label: str, what: str) -> dict:
    """8g: a KITTI-layout fixture folder (``kitti_tiff``: pair 0 8-bit LZW
    with predictor 2, pair 1 16-bit; ``kitti_zstd``: the same as Zstandard;
    ``kitti_tga``: RLE TGA; ``kitti_webp_anim``: lossless animated WebP,
    read as its first frame) through
    iter_kitti_odometry, then adapt_stereo -> track_step on the card and on
    the CPU; K3 and K1 bit-exact and K2 within TIFF_GN_ATOL at these frames
    (``max_abs_err_<label>`` in the kernels line).  Returns the card run's
    launches."""
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig
    from srrg2_proslam_tpu_torch.ops import se3

    seq = os.path.join(IMAGE_FIXTURES, folder)
    ext = {"tiff": "tif", "zstd": "tif", "tga": "tga", "webp": "webp"}[label]
    name = label.upper()
    frames = list(datasets.iter_kitti_odometry(seq))
    same = len(frames) == 2 and all(
        _sha_f32(getattr(fr, side)) == manifest[f"{folder}/image_{k}/{i:06d}.{ext}"][
            "load_gray_sha256"]
        for i, fr in enumerate(frames) for k, side in ((0, "left"), (1, "right")))
    print(f"8g iter_kitti_odometry over {seq} ({what}): "
          f"{len(frames)} frames, equal to the manifest: {same} [{smi}]", flush=True)
    if not same:
        fail(f"8g: iter_kitti_odometry's {name} frames differ from the manifest")
    cam = datasets.kitti_camera(*frames[0].left.shape)
    adapt_cfg, track_cfg = StereoAdaptorConfig(), TrackerConfig()
    gpu = [(torch.from_numpy(f.left).to(dev), torch.from_numpy(f.right).to(dev))
           for f in frames]
    errs, _ = check_kernels(main_path_inputs(gpu, cam, adapt_cfg, track_cfg), cam,
                            adapt_cfg.extractor.detector_threshold, f"KITTI {name} frames 0/1")
    for kname, err in errs.items():
        report[kname][f"max_abs_err_{label}"] = err
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], err)
    if errs["gn_burst"] > TIFF_GN_ATOL:
        fail(f"8g: K2 at the {name} frames {errs['gn_burst']} > {TIFF_GN_ATOL}")
    kernels.reset_launch_counts()
    rows, poses = run_vo(gpu, cam, dev, adapt_cfg, track_cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_rows, cpu_poses = run_vo([(torch.from_numpy(f.left), torch.from_numpy(f.right))
                                  for f in frames], cam, "cpu", adapt_cfg, track_cfg)
    dt, dang = se3.error_t_and_angle(poses[-1], cpu_poses[-1])
    for i, (g, c) in enumerate(zip(rows, cpu_rows)):
        print(f"8g {name} frame {i}: meas={g['meas']} matches={g['matches']} "
              f"inliers={g['inliers']} map={g['map']} (cpu meas={c['meas']} "
              f"matches={c['matches']} inliers={c['inliers']})", flush=True)
    print(f"8g VO on the {name} frames: launches {counts}; final pose vs the CPU run |dt| "
          f"{dt.numpy()} angle {float(dang):.3e} [{smi}]", flush=True)
    if counts != {"fast": 2, "brief": 2, "gn_burst": 6}:
        fail(f"8g {name} VO launches {counts} != fast 2, brief 2, gn_burst 6")
    if any(g[k] != c[k] for g, c in zip(rows, cpu_rows) for k in ("meas", "matches", "inliers")
           ) or not (float(dt.max()) <= POSE_TOL_M and float(dang) <= POSE_TOL_RAD):
        fail(f"8g: VO on the {name} frames differs between the card and the CPU")
    return counts


def tum_folder_rgbd(dev, smi, report, manifest, folder: str, label: str, what: str) -> dict:
    """8g: a TUM-layout fixture folder of the ICL frames 0 and 1 at 640 x
    480 (``tum_tiff``: gray 8-bit LZW intensity, frame 0's depth 16-bit
    Deflate, frame 1's float32 tiles with the float predictor; ``tum_jp2``:
    RGB 9/7 JP2, 16-bit 5/3 J2K depth) through iter_tum_rgbd, then
    adapt_rgbd -> track_step(model="rgbd") on the card and on the CPU; K3
    and K1 bit-exact at frame 0 (``max_abs_err_<label>_rgbd``).  Returns
    the card run's launches."""
    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models.frontend import DepthAdaptorConfig, adapt_rgbd
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig, initial_state, track_step
    from srrg2_proslam_tpu_torch.ops import se3

    seq = os.path.join(IMAGE_FIXTURES, folder)
    rgb_ext, depth_ext = {"tiff": ("tif", "tif"), "jp2": ("jp2", "j2k")}[label]
    name = label.upper()
    frames = list(datasets.iter_tum_rgbd(seq))
    same = len(frames) == 2 and all(
        _sha_f32(fr.intensity) == manifest[f"{folder}/rgb/{i}.{rgb_ext}"]["load_gray_sha256"]
        and _sha_f32(fr.depth) == manifest[f"{folder}/depth/{i}.{depth_ext}"][
            "load_depth_sha256"]
        for i, fr in enumerate(frames))
    print(f"8g iter_tum_rgbd over {seq} ({what}): {len(frames)} frames, "
          f"equal to the manifest: {same} [{smi}]", flush=True)
    if not same:
        fail(f"8g: iter_tum_rgbd's {name} frames differ from the manifest")
    cam = datasets.icl_camera()
    dcfg, track_cfg = DepthAdaptorConfig(), TrackerConfig()
    gpu = [(torch.from_numpy(f.intensity).to(dev), torch.from_numpy(f.depth).to(dev))
           for f in frames]
    errs = check_frontend(frontend_inputs(gpu[0][0][None], dcfg.extractor),
                          dcfg.extractor.detector_threshold, f"TUM {name} frame 0")
    for kname, err in errs.items():
        report[kname][f"max_abs_err_{label}_rgbd"] = err
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], err)

    def run(pairs, device):
        state = initial_state(4096, track_cfg.landmark_estimator, device=device)
        out, poses = [], []
        for intensity, depth in pairs:
            meas = adapt_rgbd(intensity, depth, dcfg)
            state, stats, _ = track_step(state, meas.points, meas.desc, meas.valid, cam,
                                         track_cfg, "rgbd")
            out.append({"meas": int(stats.num_measurements), "matches": int(stats.num_matches),
                        "inliers": int(stats.num_inliers)})
            poses.append(state.T_lm_robot.detach().cpu())
        return out, poses

    kernels.reset_launch_counts()
    rows, poses = run(gpu, dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_rows, cpu_poses = run([(torch.from_numpy(f.intensity), torch.from_numpy(f.depth))
                               for f in frames], "cpu")
    dt, dang = se3.error_t_and_angle(poses[-1], cpu_poses[-1])
    for i, (g, c) in enumerate(zip(rows, cpu_rows)):
        print(f"8g {name} RGB-D frame {i}: meas={g['meas']} matches={g['matches']} "
              f"inliers={g['inliers']} (cpu meas={c['meas']} matches={c['matches']} "
              f"inliers={c['inliers']})", flush=True)
    print(f"8g RGB-D on the {name} frames: launches {counts}; final pose vs the CPU run |dt| "
          f"{dt.numpy()} angle {float(dang):.3e} [{smi}]", flush=True)
    if counts != {"fast": 2, "brief": 2, "gn_burst": 0}:
        fail(f"8g {name} RGB-D launches {counts} != fast 2, brief 2, gn_burst 0")
    if any(g[k] != c[k] for g, c in zip(rows, cpu_rows) for k in ("meas", "matches", "inliers")
           ) or not (float(dt.max()) <= POSE_TOL_M and float(dang) <= POSE_TOL_RAD):
        fail(f"8g: RGB-D on the {name} frames differs between the card and the CPU")
    return counts


# ---- phase 9: the chunk program (models/chunk.py) ----------------------------
CHUNK_EAGER_TOL = 1e-4       # 9b: graph vs eager on the card, poses (m) and floats
STREAM_CHUNKS = ((4, 1), (5, 1), (16, 1), (4, 2))   # 9c: (chunk_size, chunk_group)
PROFILED_FRAMES = 48         # 9a: the profiler's window, three chunks


def chunk_launches_wanted(slam, before: set, rounds: int = 3):
    """The launches a chunk-program run should have made: one K3 and one K1
    per chunk through the batched adaptor, and ``rounds`` K2 per tracker
    step (0 for RGB-D): the frames of every chunk graph replay, the frames
    stepped eagerly, and the warm-up pass of each chunk graph captured in
    the run (``before``: the captured programs' keys before it).  Returns
    (launches, warm-up frames)."""
    from srrg2_proslam_tpu_torch.utils import graphs

    st = slam.chunk_stats
    warm = sum(key[2][0] for key in graphs.programs()
               if key[0] == "chunk" and key not in before)
    return ({"fast": st["adapted_chunks"], "brief": st["adapted_chunks"],
             "gn_burst": rounds * (st["tracker_steps"] + warm)}, warm)


def print_captures(before: set, tag: str, smi: str):
    """The CUDA graphs captured since ``before``: capture and instantiate
    ms, nodes, launches per replay, replays."""
    from srrg2_proslam_tpu_torch.utils import graphs

    for key, prog in graphs.programs().items():
        if key in before:
            continue
        shape = key[2] if key[0] == "chunk" else key[2:7]
        print(f"  {tag}: captured {key[0]} graph {shape}: capture "
              f"{prog.capture_ms:.1f} ms, instantiate {prog.instantiate_ms:.1f} ms, "
              f"{prog.num_nodes} nodes, launches per replay {prog.launches}, "
              f"{prog.replays} replays [{smi}]", flush=True)


def profiler_launches(fn):
    """(the wrappers' launch counts over ``fn()``, K3/K1/K2 kernel events
    torch.profiler saw on the card over it, graph replays included)."""
    import torch
    from torch.autograd import DeviceType

    from srrg2_proslam_tpu_torch import kernels

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    after = kernels.launch_counts()
    seen = dict.fromkeys(after, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key, kname in zip(("fast", "brief", "gn_burst"), KERNEL_NAMES):
                seen[key] += kname in e.name
    return {k: after[k] - before[k] for k in after}, seen


def chunk_graph_vs_eager(dev, smi, loop, scam, adapt_cfg, config, chunks: int = 3):
    """9b: the loop's first ``chunks`` chunks through the chunk graph and
    through ``chunk_frames`` eagerly from the same state, and every split
    branch of them through its graph and eagerly from the same carry:
    integer packet columns, finish codes, arena masks and counts, split
    heads, database slots and correspondences equal; poses, positions and
    the other floats within CHUNK_EAGER_TOL."""
    import torch

    from srrg2_proslam_tpu_torch.models import chunk
    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo_batch
    from srrg2_proslam_tpu_torch.models.loop_closure import empty_database
    from srrg2_proslam_tpu_torch.models.tracker import initial_state
    from srrg2_proslam_tpu_torch.ops import pgo, se3

    B, sp = config.chunk_size, config.splitting
    args = (scam, config.tracker, "stereo", config.min_track_inliers,
            sp.maximum_translation_m, sp.maximum_rotation_rad)
    exact_cols = [chunk.PKT_INLIERS, chunk.PKT_MATCHES, chunk.PKT_MERGES,
                  chunk.PKT_ADDITIONS, chunk.PKT_STAGE, chunk.PKT_FINISH, chunk.PKT_ACTIVE]

    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    state, fim = initial_state(config.arena_capacity, device=dev), scalar(0)
    graph = pgo.add_pose(pgo.empty_graph(config.max_local_maps, config.max_edges, dev), 0,
                         se3.identity(dev))
    db = empty_database(config.database_capacity, config.max_db_descriptors_per_map, dev)
    ec, cur, nm, nm_h = scalar(0), scalar(0), scalar(1), 1
    worst = {"T": 0.0, "pos": 0.0, "packet": 0.0, "split": 0.0}
    n_splits = n_loops = 0

    def check(ok, what):
        if not ok:
            fail(f"9b: graph and eager runs differ: {what}")

    for c in range(chunks):
        lefts = torch.stack([f.left for f in loop[c * B:(c + 1) * B]])
        rights = torch.stack([f.right for f in loop[c * B:(c + 1) * B]])
        m = adapt_stereo_batch(lefts, rights, adapt_cfg)
        inp = (state, fim, m.points, m.desc, m.valid)
        g_state, g_fim, g = chunk.run_chunk(*inp, 0, B, *args)
        _, e_fim, e = chunk.chunk_frames(*inp, 0, B, *args)
        check(torch.equal(g.packet[:, exact_cols], e.packet[:, exact_cols])
              and int(g_fim) == int(e_fim), f"chunk {c} packet counts")
        check(torch.equal(g.arenas.valid, e.arenas.valid)
              and torch.equal(g.arenas.num_updates, e.arenas.num_updates), f"chunk {c} maps")
        valid = g.arenas.valid
        worst["T"] = max(worst["T"], float((g.T_lm_robot - e.T_lm_robot).abs().max()))
        worst["pos"] = max(worst["pos"], float(
            (g.arenas.pos - e.arenas.pos).abs()[valid].max()))
        worst["packet"] = max(worst["packet"], float((g.packet - e.packet).abs().max()))
        pkt = g.packet.cpu().numpy()
        for i in range(B):
            if pkt[i, chunk.PKT_FINISH] < 0.5:
                continue
            do_loop = nm_h >= 2 and pkt[i, chunk.PKT_FINISH] != chunk.FINISH_LOST
            sin = (graph, ec, db, cur, nm, g.T_lm_robot[i], chunk.take_frame(g.arenas, i))
            sargs = (config.max_db_descriptors_per_map, config.loop, True, do_loop)
            gs = chunk.run_split(*sin, *sargs)
            es = chunk.split_branch(*sin, *sargs)
            check(torch.equal(gs[5].meta[:chunk.SM_CP], es[5].meta[:chunk.SM_CP]),
                  f"split head {gs[5].meta[:chunk.SM_CP].tolist()} vs "
                  f"{es[5].meta[:chunk.SM_CP].tolist()}")
            check(all(torch.equal(a, b) for a, b in zip(gs[2], es[2])), "split database")
            check(torch.equal(gs[5].loop_mask, es[5].loop_mask), "split correspondences")
            worst["split"] = max(worst["split"],
                                 float((gs[5].meta - es[5].meta).abs().max()),
                                 float((gs[0].poses - es[0].poses).abs().max()))
            graph, ec, db, cur, nm = gs[:5]
            nm_h += 1
            n_splits += 1
            n_loops += do_loop
        state, fim = g_state, g_fim
    print(f"9b graph vs eager on the card, {chunks} chunks of {B} and their {n_splits} "
          f"splits ({n_loops} with the loop query): packet counts, finish codes, maps, "
          f"split heads, database slots and correspondences equal; max |dT| "
          f"{worst['T']:.3e}, max |d pos| {worst['pos']:.3e} m, max packet diff "
          f"{worst['packet']:.3e}, max split-row / pose diff {worst['split']:.3e} "
          f"(tolerance {CHUNK_EAGER_TOL}) [{smi}]", flush=True)
    if max(worst.values()) > CHUNK_EAGER_TOL or n_loops == 0:
        fail(f"9b: graph vs eager beyond {CHUNK_EAGER_TOL}, or no split with a loop query")


def measurement_stream(name: str):
    """tests/test_torch_slam.py's measurement streams (a random world of
    400 or 500 points projected into a stereo rig walking along z),
    rebuilt with numpy here (those tests import JAX): "lost" (a frame with
    nothing measured), "closure" (out and back), "relocalize" (a longer
    out-and-back with relocalisations), "eviction" (closure with a two-slot
    ring, as tests/test_torch_sequence.py builds it) and "rollback"
    (relocalize with frames 16 and 17 blanked, tests/test_torch_chunk_reloc.py).
    Returns (camera, frames [(points, desc, valid, timestamp)], config)."""
    import numpy as np

    from srrg2_proslam_tpu_torch.io.datasets import kitti_camera
    from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAMConfig, SplittingConfig

    cam = kitti_camera(rows=400, cols=600)._replace(fx=450.0, fy=450.0, cx=300.0, cy=200.0,
                                                    baseline_px=225.0)
    base = {"eviction": "closure", "rollback": "relocalize"}.get(name, name)
    rng = np.random.RandomState(0)
    n = 400 if base == "lost" else 500
    pts_w = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                      rng.uniform(2, 40, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    kw = dict(arena_capacity=1024, max_local_maps=32, max_edges=64)
    if base == "lost":
        zs = [0.4 * i for i in range(12)]
        kw.update(splitting=SplittingConfig(maximum_translation_m=1.0),
                  enable_loop_closing=False)
    elif base == "closure":
        zs = list(np.arange(0, 3.0, 0.3)) + list(np.arange(3.0, -0.01, -0.3))
        kw.update(splitting=SplittingConfig(maximum_translation_m=1.0),
                  database_capacity=8192,
                  loop=LoopDetectorConfig(minimum_age_difference=2, minimum_matches=25))
    else:
        zs = list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))
        kw.update(splitting=SplittingConfig(maximum_translation_m=0.6),
                  database_capacity=16384, max_device_map_arenas=2,
                  loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25))
    if name == "eviction":
        kw.update(database_capacity=1024, max_db_descriptors_per_map=512)
    blank = {"lost": (6,), "rollback": (16, 17)}.get(name, ())
    frames = []
    for i, z in enumerate(zs):
        # the rig at (0, 0, z): camera coordinates are the world's moved by -z
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -z
        p_c = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
        zc = p_c[:, 2]
        zsafe = np.maximum(zc, 0.5)
        u = cam.fx * p_c[:, 0] / zsafe + cam.cx
        v = cam.fy * p_c[:, 1] / zsafe + cam.cy
        ur = u - cam.baseline_px / zsafe
        ok = ((zc > 0.5) & (u >= 0) & (u < cam.cols) & (v >= 0) & (v < cam.rows)
              & (ur >= 0))
        if i in blank:
            ok[:] = False
        frames.append((np.stack([u, v, ur, v], axis=1).astype(np.float32), desc, ok, 0.1 * i))
    return cam, frames, GraphSLAMConfig(**kw)


def stream_runs(dev, smi):
    """9c: each measurement stream per frame on the card and through the
    chunk program at every STREAM_CHUNKS setting (the rollback stream also
    in chunks of 20), each equal to the per-frame run, and at least one
    relocalisation rollback over them."""
    import dataclasses

    import numpy as np
    import torch

    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    totals = {"runs": 0, "rollbacks": 0, "replays": 0, "relocalisations": 0}
    for name in ("lost", "closure", "relocalize", "eviction", "rollback"):
        cam, frames, config = measurement_stream(name)
        ref = GraphSLAM(cam, config, device=dev)
        ref_rows = []
        for p, d, ok, stamp in frames:
            ref.process(*(torch.from_numpy(a).to(dev) for a in (p, d, ok)), stamp)
            ref_rows.append((ref.status, ref.current_map))
        settings = STREAM_CHUNKS + (((20, 1),) if name == "rollback" else ())
        stacks = [np.stack([f[k] for f in frames]) for k in range(3)]
        for size, group in settings:
            slam = GraphSLAM(cam, dataclasses.replace(config, chunk_size=size,
                                                      chunk_group=group), device=dev)
            statuses = watch_statuses(slam)
            slam.process_meas_sequence(*stacks, [f[3] for f in frames])
            rows = list(zip(statuses, (f.local_map_index for f in slam.frames)))
            tag = f"9c {name} stream, chunk {size} x group {group} vs per frame on the card"
            compare_slam_runs(ref, ref_rows, slam, rows, tag, smi)
            print(f"  {tag}: rollbacks {slam.num_reloc_rollbacks}, replays "
                  f"{slam.num_reloc_replays}, relocalisations {slam.num_relocalizations}, "
                  f"{slam.chunk_stats}", flush=True)
            totals["runs"] += 1
            totals["rollbacks"] += slam.num_reloc_rollbacks
            totals["replays"] += slam.num_reloc_replays
            totals["relocalisations"] += slam.num_relocalizations
    print(f"9c: {totals['runs']} chunked runs equal to their per-frame runs; "
          f"{totals['relocalisations']} relocalisations, {totals['rollbacks']} rollbacks, "
          f"{totals['replays']} replays [{smi}]", flush=True)
    if totals["rollbacks"] < 1:
        fail("9c: no run took the relocalisation rollback")


def phase_chunk(dev, smi, loop, ref_slam, ref_rows, ref_ms, seq_ms, adapt_cfg):
    """Phase 9, the chunk program (process_sequence at chunk_size 16,
    chunk_lag 2): 9a the rendered loop (gate, phase 5's run frame for
    frame, launches predicted and seen by the profiler, graphs, reads,
    ms/frame); 9b graph against eager; 9c the measurement streams; 9d the
    loop as RGB-D.  Returns 9a's launches."""
    import dataclasses

    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import synthetic
    from srrg2_proslam_tpu_torch.models.frontend import DepthAdaptorConfig
    from srrg2_proslam_tpu_torch.utils import graphs, profiling

    scam = synthetic.synthetic_camera()
    frames = [((f.left, f.right), f.timestamp) for f in loop]
    n = len(frames)
    config = dataclasses.replace(slam_config(), speculation_depth=SEQ_DEPTH,
                                 chunk_size=SEQ_CHUNK)
    # ---- 9a
    before = set(graphs.programs())
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam, rows = run_sequence(frames, scam, dev, adapt_cfg, config)
    first_pass = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want, warm = chunk_launches_wanted(slam, before)
    st = slam.chunk_stats
    print_captures(before, "9a", smi)
    consumed = st["packet_reads"] - st["splits"]
    print(f"9a process_sequence (chunk_size {SEQ_CHUNK}, chunk_lag {config.chunk_lag}): {n} "
          f"frames, {slam_counts(slam)}; {st['dispatches']} dispatches ({consumed} consumed), "
          f"{st['graph_replays']} chunk graph replays ({st['graph_replays'] / st['dispatches']:.3f}"
          f" per dispatch), {st['eager_frames']} eager frames, {st['splits']} split branches, "
          f"{st['packet_reads']} packet reads ({st['packet_reads'] / consumed:.3f} per consumed "
          f"chunk), {st['tracker_steps']} tracker steps + {warm} warm-up; relocalisation "
          f"rollbacks {slam.num_reloc_rollbacks}, replays {slam.num_reloc_replays}; launches "
          f"{counts}, predicted {want} [{smi}]", flush=True)
    if counts != want or st["graph_replays"] == 0:
        fail(f"9a launches {counts} != {want}, or no chunk graph replayed")
    loop_gate(slam, [f.gt_pose for f in loop], "chunk-program rendered-loop", smi)
    compare_slam_runs(ref_slam, ref_rows, slam, rows,
                      "9a process_sequence (chunk program) vs phase 5's per-frame GraphSLAM",
                      smi)
    counted, seen = profiler_launches(
        lambda: run_sequence(frames[:PROFILED_FRAMES], scam, dev, adapt_cfg, config))
    print(f"9a profiler window ({PROFILED_FRAMES} frames through process_sequence): wrappers "
          f"counted {counted}, kernel events seen {seen} [{smi}]", flush=True)
    if any(not 0 <= counted[k] - seen[k] <= 1 for k in counted) or seen["gn_burst"] == 0:
        fail(f"9a: the profiler saw {seen}, the counts say {counted} (at most one event "
             "per kernel may drop)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sequence(frames, scam, dev, adapt_cfg, config)
    steady = (time.perf_counter() - t0) / n * 1e3
    print(f"chunk program ms/frame: {steady:.3f} (second pass, process_sequence), first pass "
          f"{first_pass / n * 1e3:.3f}; phase 5 per-frame {ref_ms:.3f}, phase 7 speculative "
          f"{seq_ms:.3f} in this call [{smi}]", flush=True)
    # a third pass under profile_time, each scope synchronized: where it goes
    profiling.reset()
    profiling.enable()
    try:
        run_sequence(frames, scam, dev, adapt_cfg, config)
    finally:
        profiling.enable(False)
    for stage, stat in profiling.stats().items():
        print(f"  9a stage {stage}: {stat['calls']} calls, mean {stat['mean_ms']:.3f} ms, "
              f"total {stat['total_s'] * 1e3:.3f} ms (third pass, profile_time, synchronized) "
              f"[{smi}]", flush=True)
    # ---- 9b
    chunk_graph_vs_eager(dev, smi, loop, scam, adapt_cfg, config)
    # ---- 9c
    t9c = time.perf_counter()
    stream_runs(dev, smi)
    print(f"9c: {time.perf_counter() - t9c:.1f} s [{smi}]", flush=True)
    chunk_ref = (slam, rows, steady)
    # ---- 9d
    dcfg = DepthAdaptorConfig()
    rgbd = list(synthetic.iter_rendered_loop_rgbd(side_a=10.0, side_b=6.0, step_m=0.4,
                                                  turn_frames=10, device=dev))
    rframes = [((f.intensity, f.depth), f.timestamp) for f in rgbd]
    ref_rgbd, ref_rgbd_rows = run_slam(rframes, scam, dev, dcfg, model="rgbd")
    before = set(graphs.programs())
    kernels.reset_launch_counts()
    rslam, rrows = run_sequence(rframes, scam, dev, dcfg, config, model="rgbd")
    rcounts = kernels.launch_counts()
    rwant, _ = chunk_launches_wanted(rslam, before, rounds=0)
    print_captures(before, "9d", smi)
    print(f"9d the loop as RGB-D (local BA off) through process_sequence: "
          f"{slam_counts(rslam)}, {rslam.chunk_stats}, launches {rcounts}, predicted {rwant} "
          f"[{smi}]", flush=True)
    if rcounts != rwant or rslam.chunk_stats["graph_replays"] == 0:
        fail(f"9d launches {rcounts} != {rwant}, or no chunk graph replayed")
    compare_slam_runs(ref_rgbd, ref_rgbd_rows, rslam, rrows,
                      "9d RGB-D process_sequence vs per-frame RGB-D GraphSLAM", smi)
    return counts, chunk_ref


# ---- phase 10: the multi-GPU slice (parallel/, GraphSLAM(mesh=...)) -------
MESH_WORLD = 2               # 10b/10c: ranks sharing the card
MESH_POSE_TOL_M = 1e-4       # 10b/10c: meshed vs unmeshed on the card (the CPU tests' bound)


def session_report(slam, rows) -> dict:
    """A GraphSLAM run of this process in parallel/checks.py::slam_run's
    report layout (what checks.compare_slam compares)."""
    import numpy as np

    from srrg2_proslam_tpu_torch.parallel import checks

    return dict(rows=rows, counters={k: getattr(slam, k) for k in checks.COUNTERS},
                events=[tuple(e) for e in slam.closure_events],
                trajectory=np.stack(slam.trajectory()),
                recovery=(slam.num_reloc_rollbacks, slam.num_reloc_replays))


def report_gate(rep, gt, tag: str, smi: str):
    """Phase 5's gates on a rank's report."""
    import types

    view = types.SimpleNamespace(trajectory=lambda: list(rep["trajectory"]),
                                 **{k: rep["counters"][k] for k in
                                    ("num_maps", "num_closures", "num_relocalizations")})
    loop_gate(view, gt, tag, smi)


def print_collectives(tag: str, collectives: dict, smi: str):
    for stage, (calls, nbytes) in sorted(collectives.items()):
        print(f"  {tag} collectives, stage {stage}: {calls} calls, {nbytes} bytes "
              f"({nbytes / 2**20:.3f} MiB) per pass per rank [{smi}]", flush=True)


def phase_mesh(dev, smi, loop, ref_slam, ref_rows, ref_ms, chunk_ref):
    """Phase 10: 10a the dry runs at 1 (NCCL) and 2 (gloo) ranks; 10b the
    loop through the meshed chunk program at world size 2 against phase
    9a; 10c the loop per frame at world size 2 against phase 5.  A failing
    rank raises out of parallel/launch.py and fails the script.  Returns
    rank 0's launches of 10b and 10c."""
    import dataclasses

    from srrg2_proslam_tpu_torch.entry import dryrun_multichip
    from srrg2_proslam_tpu_torch.parallel import checks, launch

    # ---- 10a
    for n, backend in ((1, "nccl"), (MESH_WORLD, "gloo")):
        t0 = time.perf_counter()
        reports = dryrun_multichip(n)
        worst = [checks.check_stages(r) for r in reports]
        if any(r["backend"] != backend for r in reports):
            fail(f"10a dryrun_multichip({n}) ran over {reports[0]['backend']}, not {backend}")
        print(f"10a dryrun_multichip({n}) over {backend} on {reports[0]['device']}: "
              f"{time.perf_counter() - t0:.1f} s; largest float difference to the single-rank "
              f"call by stage {dict((k, max(w[k] for w in worst)) for k in worst[0])} (tolerance "
              f"{checks.FLOAT_TOL} relative, chi {checks.CHI_RTOL}; keys, matches and counts bit "
              f"for bit) [{smi}]",
              flush=True)
        print_collectives(f"10a world {n} stages", reports[0]["collectives"], smi)
    # ---- 10b and 10c on the same two ranks
    chunk_slam, chunk_rows, chunk_ms = chunk_ref
    loop_kw = dict(side_a=10.0, side_b=6.0, step_m=0.4, turn_frames=10)
    n = len(loop)
    seq_cfg = dataclasses.replace(slam_config(), speculation_depth=SEQ_DEPTH, chunk_size=SEQ_CHUNK)
    specs = [dict(config=seq_cfg, mode="sequence", frames=("loop", loop_kw),
                  passes=2, profile_frames=PROFILED_FRAMES),
             dict(config=slam_config(), mode="frame", frames=("loop", loop_kw))]
    t0 = time.perf_counter()
    ranks = launch.run(checks.slam_runs, MESH_WORLD, specs)
    print(f"10b/10c: {MESH_WORLD} ranks on the card over {ranks[0][0]['backend']}: "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    gt = [f.gt_pose for f in loop]
    refs = (("10b process_sequence", session_report(chunk_slam, chunk_rows), "9a", chunk_ms),
            ("10c process + flush", session_report(ref_slam, ref_rows), "5", ref_ms))
    for k, (tag, ref, ref_phase, ms) in enumerate(refs):
        for rank in ranks:
            rep = rank[k]
            if len(rep["rows"]) != n:
                fail(f"{tag} rank {rep['rank']}: {len(rep['rows'])} frames, not {n}")
            report_gate(rep, gt, f"{tag} rank {rep['rank']}", smi)
            try:
                diff = checks.compare_slam(rep, ref, MESH_POSE_TOL_M)
            except AssertionError as err:
                fail(f"{tag} rank {rep['rank']} vs phase {ref_phase}'s unmeshed run: {err}")
            st = rep["chunk_stats"]
            if k == 0:
                want = {"fast": st["adapted_chunks"], "brief": st["adapted_chunks"],
                        "gn_burst": 3 * (st["tracker_steps"] + rep["warm_frames"])}
            else:
                want = {"fast": n, "brief": n, "gn_burst": 3 * n}
            print(f"{tag} world {MESH_WORLD} rank {rep['rank']}: {rep['counters']}, "
                  f"rollbacks/replays {rep['recovery']}; equal to phase {ref_phase}'s unmeshed "
                  f"run frame for frame, max |pose diff| {diff:.3e} (tolerance "
                  f"{MESH_POSE_TOL_M}); launches {rep['launches']}, predicted {want}"
                  + (f" ({st['graph_replays']} chunk graph replays, {st['splits']} split "
                     f"branches run eagerly)" if k == 0 else "") + f" [{smi}]", flush=True)
            if rep["launches"] != want or (k == 0 and st["graph_replays"] == 0):
                fail(f"{tag} rank {rep['rank']}: launches {rep['launches']} != {want}")
        r0 = ranks[0][k]
        passes = ", ".join(f"{m:.3f}" for m in r0["ms_per_frame"])
        print(f"{tag} ms/frame at world {MESH_WORLD}, rank 0, by pass: {passes}"
              + (" (the first synchronizes each split branch)" if k == 0 else "")
              + f"; phase {ref_phase} unmeshed {ms:.3f} in this call [{smi}]", flush=True)
        print_collectives(tag, r0["collectives"], smi)
        if r0["split_ms"]:
            sm = r0["split_ms"]
            print(f"  {tag} split branches run eagerly (first pass, synchronized): {len(sm)} "
                  f"calls, mean {sum(sm) / len(sm):.3f} ms, max {max(sm):.3f} ms [{smi}]",
                  flush=True)
    prof = ranks[0][0]["profiled"]
    counted, seen = prof["counted"], prof["seen"]
    print(f"10b profiler window on rank 0 ({prof['frames']} frames): wrappers counted "
          f"{counted}, kernel events seen {seen} [{smi}]", flush=True)
    if any(not 0 <= counted[k] - seen[k] <= 1 for k in counted) or seen["gn_burst"] == 0:
        fail(f"10b: the profiler saw {seen}, the counts say {counted}")
    return ranks[0][0]["launches"], ranks[0][1]["launches"]


# ---- phase 11: the examples and tools (apps/example_*, scripts/*_torch.py) ----
TOOLS_DIR = os.path.join(ROOT, "srrg2_proslam_tpu_torch", "build", "tools")   # removed at the end
# the CPU twins, two child processes beside the card's run, and their torch threads;
# they run on the card's renders (RENDERS_PATH), as phase 5's CPU run does
TOOLS_CPU_THREADS = {"examples": 4, "ab": 3}
RENDERS_PATH = os.path.join(TOOLS_DIR, "card_renders.pt")
E2E_CPU_FRAMES = 40          # 11c: rendered_e2e frames run on the card and the CPU
# 11d: the seeded A/B's and the motion loop's first frames run on the card and the
# CPU (the seeded A/B's contrast-crushed frames 24-29 and the loop's first 15 deg
# turns, frames 22-27, included)
AB_CPU_FRAMES = 30
E2E_POSE_TOL_M = 1e-3        # 11c, 11d: every frame's pose, card vs CPU
# each example's flags and predicted launches (FAST, BRIEF, GN burst)
EXAMPLES = {
    "example_tracking": ([], (5, 5, 15)),
    "example_triangulate_stereo": ([], (1, 1, 0)),
    "example_feature_matching": ([], (2, 2, 0)),
    "example_feature_extractor": (["--seeded"], (21, 0, 0)),
    "example_loop_closure": ([], (0, 0, 0)),
    "example_unproject_rgbd": ([], (0, 0, 0)),
    "example_search_patterns": (["--out", os.path.join(TOOLS_DIR, "patterns.pgm")], (0, 0, 0)),
}
# the JAX scripts' output on the CPU (JAX_PLATFORMS=cpu; scripts/tools_jax_reference.py):
# scripts/rendered_e2e.py's counts and verdict
JAX_E2E = ("maps=23 closures=1 relocalizations=1 evictions=0", "KITTI-gates: PASS")
# scripts/ab_local_ba.py: local BA off / on -> (maps, closures, backstop rejections),
# ATE and per-axis t-RMSE (m)
JAX_LOCAL_BA = {False: ((26, 2, 0), 0.3764, (0.2997, 0.0151, 0.2271)),
                True: ((26, 2, 0), 0.3752, (0.2987, 0.0161, 0.2265))}
# scripts/ab_seeded_detection.py: dense / seeded -> (frames, stereo matches, VO inliers)
# summed over the 60 frames, and the 1 px recall it prints
JAX_SEEDED = {False: ((60, 51223, 5345), 0.994), True: ((60, 51238, 5344), 0.994)}
# scripts/ab_motion_envelopes.py --fast -> (maps, closures, relocalizations,
# backstop rejections), ATE and per-axis t-RMSE (m)
JAX_MOTION_FAST = {"baseline": ((22, 0, 0, 0), 1.8414, (1.3805, 0.0584, 1.2173)),
                   "idw": ((22, 0, 0, 0), 1.8681, (1.4030, 0.0549, 1.2323)),
                   "smoother": ((25, 3, 3, 0), 0.5096, (0.3282, 0.0154, 0.3896)),
                   "idw+smoother": ((25, 3, 3, 0), 0.3233, (0.2189, 0.0209, 0.2369))}
# scripts/diag_rendered.py --part 1
JAX_DIAG_PART1 = ["frame 0: n_feat=779 inlier@1px=0.994 median_err=0.058px p90=0.23px",
                  "frame 60: n_feat=1005 inlier@1px=0.998 median_err=0.063px p90=0.27px",
                  "frame 75: n_feat=987 inlier@1px=0.997 median_err=0.082px p90=0.26px"]
# Against JAX's numbers each package renders its own images, and the renderers
# may pick the other plane on an ulp at a seam (<= 0.5 % of pixels,
# tests/test_torch_slam.py), which moves a FAST keypoint; on the JAX renderer's
# images the port's counts equal JAX's frame for frame (tests/test_torch_tools_ab.py),
# and on the same images the card's equal the CPU's (11d's CPU twin).  So the
# card's renders are held to JAX's numbers within the renderers' gaps:
# the frontend's tallies (the seeded A/B's matches and VO inliers, diag_rendered's
# keypoints) relatively: the card 0.016-0.018 % and 0.20 %, the port's CPU 0.02 %
# and 0.11 % off JAX (PERF.md)
RENDER_REL_TOL = 0.005
# and each full A/B run's ATE and per-axis t-RMSE, about twice the largest gap:
# the card's renders up to 1.2e-3 m (ATE) and 9.4e-3 m (t-RMSE, motion idw, y)
# off JAX, the port's CPU renders ~5e-3 m (t-RMSE, motion idw, y) (PERF.md)
RENDER_POSE_TOL_M = 0.02


def _script(name: str) -> dict:
    return runpy.run_path(os.path.join(ROOT, "scripts", f"{name}_torch.py"))


@contextlib.contextmanager
def recorded_renders(synthetic):
    """The port's render_stereo (``synthetic`` is the port's io.synthetic)
    for the block, each call's images (left, right, depth) also copied to
    the host into the list the block gets."""
    render, images = synthetic.render_stereo, []

    def recording(cam, T_wc, planes, supersample: int = 2):
        out = render(cam, T_wc, planes, supersample)
        images.append(tuple(x.cpu() for x in out))
        return out

    synthetic.render_stereo = recording
    try:
        yield images
    finally:
        synthetic.render_stereo = render


@contextlib.contextmanager
def replayed_renders(synthetic, images: list):
    """The port's render_stereo for the block hands back ``images`` in
    order, on the pose's device, instead of rendering; fails unless the
    block takes them all."""
    render, queue = synthetic.render_stereo, iter(images)

    def replay(cam, T_wc, planes, supersample: int = 2):
        return tuple(x.to(T_wc.device) for x in next(queue))

    synthetic.render_stereo = replay
    try:
        yield
        left = sum(1 for _ in queue)
        if left:
            fail(f"{left} of {len(images)} recorded renders were not replayed")
    finally:
        synthetic.render_stereo = render


@contextlib.contextmanager
def cut_loops(synthetic, frames: int):
    """The port's loop_trajectory, so every rendered loop, cut to its first
    ``frames`` poses."""
    full = synthetic.loop_trajectory
    synthetic.loop_trajectory = lambda *a, **k: full(*a, **k)[:frames]
    try:
        yield
    finally:
        synthetic.loop_trajectory = full


def ab_twins(device) -> dict:
    """11d's runs that the card and the CPU make on the same images, on
    ``device``: the seeded A/B over its first AB_CPU_FRAMES frames (per
    variant its sums and, per frame, stereo matches and VO inliers),
    diag_rendered's part 1 rows, and the idw+smoother motion loop
    (sub-pixel on) over its first AB_CPU_FRAMES frames (counts,
    trajectory) -> a dict as JSON gives it back."""
    import io

    import numpy as np

    from srrg2_proslam_tpu_torch.io import synthetic

    seeded = _script("ab_seeded_detection")["run"]
    rows, track_step = [], seeded.__globals__["track_step"]

    def counted(state, pts, desc, valid, *args, **kw):
        out = track_step(state, pts, desc, valid, *args, **kw)
        rows.append((int(valid.sum()), int(out[1].num_inliers)))
        return out

    # the script's own namespace (run_path hands back a copy of it)
    seeded.__globals__.update(track_step=counted, FRAMES=AB_CPU_FRAMES)
    stats = seeded(device)
    res = {"seeded": {name: dict(stats[s], per_frame=rows[int(s)::2])   # dense, seeded per frame
                      for name, s in (("dense", False), ("seeded", True))}}
    with contextlib.redirect_stdout(io.StringIO()):
        res["diag"] = _script("diag_rendered")["part1_stereo_quality"](device=device)
    motion = _script("ab_motion_envelopes")
    with cut_loops(synthetic, AB_CPU_FRAMES):
        _, slam = motion["run"](motion["SCENARIOS"]["turn15deg"],
                                motion["VARIANTS"]["idw+smoother"], device)
    res["motion"] = dict(counts=(slam.num_maps, slam.num_closures, slam.num_relocalizations,
                                 slam.num_backstop_rejections),
                         trajectory=np.stack(slam.trajectory()).tolist())
    return json.loads(json.dumps(res))


def tools_cpu_twins(part: str, out_path: str):
    """Phase 11's CPU runs, in child processes while the card runs the
    phase -> a JSON file.  "examples": each example with --device cpu, and
    rendered_e2e's first E2E_CPU_FRAMES frames; "ab": ab_twins on the CPU.
    The rendered runs take the card's images (RENDERS_PATH)."""
    import numpy as np
    import torch

    from srrg2_proslam_tpu_torch.io import synthetic

    torch.set_num_threads(TOOLS_CPU_THREADS[part])
    t0 = time.perf_counter()
    renders = torch.load(RENDERS_PATH)
    if part == "ab":
        with replayed_renders(synthetic, renders["ab"]):
            res = ab_twins(torch.device("cpu"))
    else:
        printout = runpy.run_path(os.path.join(ROOT, "tests", "torch_printout.py"))
        res = {}
        for name, (argv, _) in EXAMPLES.items():
            argv = [a.replace("patterns.pgm", "patterns_cpu.pgm") for a in argv]
            t1 = time.perf_counter()
            code, lines = printout["run_as_main"](f"srrg2_proslam_tpu_torch.apps.{name}",
                                                  argv + ["--device", "cpu"])
            res[name] = dict(code=code, lines=lines, seconds=time.perf_counter() - t1)
            print(f"{name}: {res[name]['seconds']:.1f} s", flush=True)
        t1 = time.perf_counter()
        with replayed_renders(synthetic, renders["rendered_e2e"]):
            (slam, _), lines = printout["captured"](_script("rendered_e2e")["main"],
                                                    ["--frames", str(E2E_CPU_FRAMES),
                                                     "--device", "cpu"])
        res["rendered_e2e"] = dict(lines=lines, maps=slam.num_maps,
                                   trajectory=np.stack(slam.trajectory()).tolist(),
                                   seconds=time.perf_counter() - t1)
    res["seconds"] = time.perf_counter() - t0
    print(f"CPU twins {part}: {res['seconds']:.1f} s", flush=True)
    with open(out_path, "w") as f:
        json.dump(res, f)


def trajectory_gap(card_traj, cpu_traj, tag: str) -> float:
    """Max |dt| (m) of two runs' poses frame for frame; fails on a length
    mismatch or a gap over E2E_POSE_TOL_M."""
    import numpy as np

    card_traj, cpu_traj = np.asarray(card_traj), np.asarray(cpu_traj)
    if card_traj.shape != cpu_traj.shape:
        fail(f"{tag}: {len(card_traj)} poses on the card, {len(cpu_traj)} on the CPU")
    dt = float(np.abs(card_traj[:, :3, 3] - cpu_traj[:, :3, 3]).max())
    if dt > E2E_POSE_TOL_M:
        fail(f"{tag}: the card's poses are {dt:.3e} m from the CPU's (tolerance "
             f"{E2E_POSE_TOL_M})")
    return dt


def check_render_poses(err, ate: float, t_rmse, tag: str) -> float:
    """A full A/B run's ATE and per-axis t-RMSE against JAX's within
    RENDER_POSE_TOL_M; returns the largest gap."""
    import numpy as np

    gap = max(abs(float(err.ate_rmse) - ate),
              float(np.abs(np.asarray(err.mean_translation_rmse) - np.asarray(t_rmse)).max()))
    if gap > RENDER_POSE_TOL_M:
        fail(f"{tag}: ATE {err.ate_rmse:.4f} m, t-RMSE {np.round(err.mean_translation_rmse, 4)}"
             f" m against JAX's {ate} m, {t_rmse} m ({gap:.4f} apart, tolerance "
             f"{RENDER_POSE_TOL_M})")
    return gap


def check_busiest_bursts(bursts, runs: int, tag: str) -> float:
    """K2 against its plain burst on the busiest burst (most active rows)
    of each of ``runs`` equal runs' recorded bursts; returns max_abs_err."""
    per_run = len(bursts) // runs
    errs = []
    for r in range(runs):
        span = bursts[r * per_run:(r + 1) * per_run]
        i = max(range(per_run), key=lambda j: int(span[j][0][4].sum()))
        args, kw = span[i]
        errs.append(check_gn(args, kw, args[5], f"11d {tag} run {r} (burst {i % 3} of frame "
                                                f"{i // 3})")[0])
    return max(errs)


def phase_tools(dev, smi, report):
    """Phase 11, the repo's examples and tools on the card: 11c's default
    253-frame loop first (timed with nothing else running), then the runs
    the CPU twins repeat (the loop's first frames, ab_twins) with their
    renders kept for them; then, while two child processes run the CPU
    twins on those renders, 11a the seven examples (against their --device
    cpu runs) and export_viewer, 11b the smoke scripts, 11d the A/B
    scripts and diag_rendered's part 1 against the JAX scripts' recorded
    output, K3 and K1 at their 320x416 images and K2 at their busiest
    bursts against the plain versions (into ``report`` as
    max_abs_err_tools); last, the card's cut runs against the CPU twins'.
    Returns the launches of each example and tool."""
    import importlib.util
    import re
    import shutil

    import torch

    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets, synthetic
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig

    printout = runpy.run_path(os.path.join(ROOT, "tests", "torch_printout.py"))
    captured, run_as_main = printout["captured"], printout["run_as_main"]
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    ex_counts, tool_counts, card, kernel_errs = {}, {}, {}, {}

    def launches(want, tag):
        counts = kernels.launch_counts()
        got = (counts["fast"], counts["brief"], counts["gn_burst"])
        if want is not None and got != want:
            fail(f"{tag}: launches (FAST, BRIEF, GN) {got}, predicted {want}")
        return counts

    def show(tag, lines, limit=12):
        for line in lines[:limit]:
            print(f"  [{tag}] {line}", flush=True)
        if len(lines) > limit:
            print(f"  [{tag}] ... ({len(lines) - limit} more lines)", flush=True)

    def stage(tag, t0):
        print(f"  ({tag} done at {time.perf_counter() - t0:.1f} s into phase 11)", flush=True)

    t_phase = time.perf_counter()
    # ---- 11c: rendered_e2e's default loop, before the CPU twins start ----
    e2e = _script("rendered_e2e")["main"]
    kernels.reset_launch_counts()
    (slam, err), lines = captured(e2e, [])
    tool_counts["rendered_e2e"] = launches((253, 253, 759), "11c rendered_e2e")
    show("11c rendered_e2e", lines)
    if tuple(ln for ln in lines if ln.startswith(("maps=", "KITTI-gates"))) != JAX_E2E:
        fail(f"11c rendered_e2e: counts or verdict differ from the JAX script's {JAX_E2E}")
    print(f"11c rendered_e2e: 253 frames, {JAX_E2E[0]} and {JAX_E2E[1]} as the JAX "
          f"script's CPU run; ATE {err.ate_rmse:.4f} m (JAX 0.122); timed with no other "
          f"process running [{smi}]", flush=True)
    traj_path = os.path.join(TOOLS_DIR, "e2e_kitti.txt")
    datasets.write_kitti_trajectory(traj_path, slam.trajectory())

    # ---- 11c/11d: the runs the CPU twins repeat, their renders kept for them ----
    renders = {}
    with recorded_renders(synthetic) as renders["rendered_e2e"]:
        (slam40, _), _ = captured(e2e, ["--frames", str(E2E_CPU_FRAMES)])
    with recorded_renders(synthetic) as renders["ab"]:
        card_ab = ab_twins(dev)
    torch.save(renders, RENDERS_PATH)
    del renders
    stage("the CPU twins' renders", t_phase)

    twin_paths = {part: os.path.join(TOOLS_DIR, f"cpu_twins_{part}")
                  for part in TOOLS_CPU_THREADS}
    children = {}

    def stop_children():
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()

    with contextlib.ExitStack() as stack:
        for part, path in twin_paths.items():
            log = stack.enter_context(open(path + ".log", "w"))
            children[part] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tools-cpu-twins", part,
                 path + ".json"],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        stack.callback(stop_children)

        # ---- 11a: the examples on the card ----
        for name, (argv, want) in EXAMPLES.items():
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            code, lines = run_as_main(f"srrg2_proslam_tpu_torch.apps.{name}", argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if code != 0:
                fail(f"11a {name} exited with {code}")
            ex_counts[name] = launches(want, f"11a {name}")
            card[name] = lines
            show(f"11a {name}", lines)
            print(f"11a {name}: {secs:.2f} s on the card, launches {ex_counts[name]} "
                  f"(predicted {want}) [{smi}]", flush=True)

        # ---- 11b: the smoke scripts ----
        for name, want in (("smoke_vo", (5, 5, 15)), ("smoke_slam", (5, 5, 15)),
                           ("smoke_rgbd", (2, 2, 0))):
            kernels.reset_launch_counts()
            _, lines = captured(_script(name)["main"], [])
            tool_counts[name] = launches(want, f"11b {name}")
            show(f"11b {name}", lines[-3:])
            if lines[-1] != "PASS":
                fail(f"11b {name}: {lines[-1]}")
            print(f"11b {name}: PASS, launches {tool_counts[name]} [{smi}]", flush=True)

        stage("11a, 11b", t_phase)

        # ---- export_viewer: renders where matplotlib imports, else raises ----
        png = os.path.join(TOOLS_DIR, "viewer.png")
        viewer = ["--trajectory", traj_path, "--output", png]
        if importlib.util.find_spec("matplotlib") is None:
            try:
                run_as_main("srrg2_proslam_tpu_torch.apps.export_viewer", viewer)
            except ImportError as e:
                print(f"11a export_viewer: raised ImportError ({e}): no matplotlib on "
                      f"this machine, as expected", flush=True)
            else:
                fail("11a export_viewer ran without matplotlib")
        else:
            code, lines = run_as_main("srrg2_proslam_tpu_torch.apps.export_viewer", viewer)
            if code != 0 or not os.path.exists(png):
                fail(f"11a export_viewer: exit {code}, {png} not written")
            print(f"11a export_viewer: {lines[-1]}", flush=True)

        # ---- 11d: the A/B scripts and diag_rendered part 1 on the card's
        # renders, against the JAX scripts' CPU runs ----
        kernels.reset_launch_counts()
        with recorded(kernels.gn, "gn_burst_stereo") as bursts:
            runs, lines = captured(_script("ab_local_ba")["main"], [])
        tool_counts["ab_local_ba"] = launches((254, 254, 762), "11d ab_local_ba")
        show("11d ab_local_ba", lines)
        for enabled, (err, s) in runs.items():
            got = (s.num_maps, s.num_closures, s.num_backstop_rejections)
            want, ate, t_rmse = JAX_LOCAL_BA[enabled]
            if got != want:
                fail(f"11d ab_local_ba local_ba={enabled}: (maps, closures, backstop "
                     f"rejections) {got}, the JAX script's {want}")
            gap = check_render_poses(err, ate, t_rmse, f"11d ab_local_ba local_ba={enabled}")
            print(f"11d ab_local_ba local_ba={enabled}: {got} as the JAX script's; ATE "
                  f"{err.ate_rmse:.4f} m, JAX {ate} m; ATE and t-RMSE {gap:.4f} m from JAX's "
                  f"(tolerance {RENDER_POSE_TOL_M}) [{smi}]", flush=True)
        kernel_errs["gn_burst"] = [check_busiest_bursts(bursts, 2, "ab_local_ba")]

        kernels.reset_launch_counts()
        seeded = _script("ab_seeded_detection")
        # K3 launches 4 per frame (dense left, dense right, seeded left, seeded
        # right): keep the first crushed frame's dense right image
        crushed = seeded["CRUSHED"][0] * 4 + 1
        with recorded(kernels.fast, "fast_scores_kernel", keep=crushed.__eq__) as crushed_k3:
            stats, lines = captured(seeded["main"], [])
        tool_counts["ab_seeded_detection"] = launches((240, 240, 360),
                                                      "11d ab_seeded_detection")
        show("11d ab_seeded_detection", lines)
        for is_seeded, (want, recall) in JAX_SEEDED.items():
            s = stats[is_seeded]
            got = (s["frames"], s["matches"], s["inliers"])
            rel = max(abs(g - w) / w for g, w in zip(got, want))
            if got[0] != want[0] or rel > RENDER_REL_TOL:
                fail(f"11d ab_seeded_detection seeded={is_seeded}: (frames, matches, VO "
                     f"inliers) {got}, the JAX script's {want} (relative tolerance "
                     f"{RENDER_REL_TOL})")
            print(f"11d ab_seeded_detection seeded={is_seeded}: (frames, matches, VO inliers) "
                  f"{got}, the JAX script's {want}, {rel:.5f} apart (tolerance "
                  f"{RENDER_REL_TOL}); 1 px recall {s['correct'] / s['matches']:.4f}, JAX "
                  f"{recall} [{smi}]", flush=True)

        kernels.reset_launch_counts()
        with recorded(kernels.fast, "fast_scores_kernel", keep=(0).__eq__) as motion_k3, \
                recorded(kernels.gn, "gn_burst_stereo") as bursts:
            runs, lines = captured(_script("ab_motion_envelopes")["main"], ["--fast"])
        tool_counts["ab_motion_envelopes_fast"] = launches(
            (476, 476, 1428), "11d ab_motion_envelopes --fast")
        show("11d ab_motion_envelopes --fast", lines)
        for (sname, vname), (err, s) in runs.items():
            got = (s.num_maps, s.num_closures, s.num_relocalizations,
                   s.num_backstop_rejections)
            want, ate, t_rmse = JAX_MOTION_FAST[vname]
            if got != want:
                fail(f"11d ab_motion_envelopes {sname} {vname}: (maps, closures, relocs, "
                     f"rejections) {got}, the JAX script's {want}")
            gap = check_render_poses(err, ate, t_rmse, f"11d ab_motion_envelopes {vname}")
            print(f"11d ab_motion_envelopes {sname} {vname}: {got} as the JAX script's; "
                  f"ATE {err.ate_rmse:.4f} m, JAX {ate} m; ATE and t-RMSE {gap:.4f} m from "
                  f"JAX's (tolerance {RENDER_POSE_TOL_M}) [{smi}]", flush=True)
        kernel_errs["gn_burst"].append(check_busiest_bursts(bursts, len(runs),
                                                            "ab_motion_envelopes --fast"))

        kernels.reset_launch_counts()
        _, lines = captured(_script("diag_rendered")["main"], ["--part", "1"])
        tool_counts["diag_rendered_part1"] = launches((3, 3, 0), "11d diag_rendered")
        show("11d diag_rendered --part 1", lines)
        # keypoints within RENDER_REL_TOL, the rest within one printed unit
        n_feat = re.compile(r"n_feat=(\d+)")
        got, want = ([int(n_feat.search(ln).group(1)) for ln in ls]
                     for ls in (lines, JAX_DIAG_PART1))
        rel = max(abs(g - w) / w for g, w in zip(got, want))
        diff = printout["printout_diff"](*([n_feat.sub("n_feat=#", ln) for ln in ls]
                                           for ls in (lines, JAX_DIAG_PART1)))
        if len(got) != len(want) or rel > RENDER_REL_TOL or diff:
            fail(f"11d diag_rendered part 1 vs the JAX script's: keypoints {got} vs "
                 f"{want} ({rel:.5f} apart, tolerance {RENDER_REL_TOL}); " + "; ".join(diff))
        print(f"11d diag_rendered part 1: keypoints {got}, the JAX script's {want}, "
              f"{rel:.5f} apart (tolerance {RENDER_REL_TOL}); the rest within one "
              f"printed unit [{smi}]", flush=True)

        # ---- 11d: K3 and K1 at the A/B loops' 320x416 images (the motion
        # loop's first pair, the seeded A/B's crushed right image), bit-exact ----
        ext = StereoAdaptorConfig().extractor
        for tag, calls in (("motion loop pair 0", motion_k3),
                           (f"seeded A/B frame {seeded['CRUSHED'][0]} right (crushed)",
                            crushed_k3)):
            (images, threshold), _ = calls[0]
            for kname, e in check_frontend(frontend_inputs(images, ext), threshold,
                                           f"11d {tag}").items():
                kernel_errs.setdefault(kname, []).append(e)
        stage("11d", t_phase)

        # ---- the CPU twins ----
        t0 = time.perf_counter()
        for part, child in children.items():
            child.wait(timeout=600)
        print(f"CPU twins done {time.perf_counter() - t0:.1f} s after the card's runs",
              flush=True)
    for part, child in children.items():
        if child.returncode != 0:
            with open(twin_paths[part] + ".log") as f:
                print(f.read()[-4000:], flush=True)
            fail(f"the CPU twins ({part}) exited with {child.returncode}")
    twins = {}
    for part, path in twin_paths.items():
        with open(path + ".json") as f:
            twins[part] = json.load(f)
        print(f"CPU twins {part}: {twins[part]['seconds']:.1f} s", flush=True)

    for name in EXAMPLES:
        cpu = twins["examples"][name]
        cpu_lines = [ln.replace("patterns_cpu.pgm", "patterns.pgm") for ln in cpu["lines"]]
        diff = printout["printout_diff"](card[name], cpu_lines, skip=("duration",))
        if cpu["code"] != 0 or diff:
            fail(f"11a {name}: the card's printout differs from --device cpu's: "
                 + "; ".join(diff[:5]))
        print(f"11a {name}: {len(card[name])} lines equal to --device cpu's (CPU "
              f"{cpu['seconds']:.1f} s)", flush=True)
    # the card's runs against the CPU twins' on the same images: 11c's first
    # frames and 11d's cut runs (the frontend exactly, VO inliers per frame
    # within COUNT_TOL, every count exactly, every pose within E2E_POSE_TOL_M)
    cpu = twins["examples"]["rendered_e2e"]
    tag = f"11c rendered_e2e --frames {E2E_CPU_FRAMES}"
    if slam40.num_maps != cpu["maps"]:
        fail(f"{tag}: {slam40.num_maps} maps on the card, {cpu['maps']} on the CPU")
    dt = trajectory_gap(slam40.trajectory(), cpu["trajectory"], tag)
    print(f"{tag}, the card vs the CPU on the card's renders: frame for frame, "
          f"{slam40.num_maps} maps, max |dt| {dt:.3e} m (tolerance {E2E_POSE_TOL_M}; CPU "
          f"{cpu['seconds']:.1f} s) [{smi}]", flush=True)
    cpu = twins["ab"]
    for variant, c in cpu["seeded"].items():
        g = card_ab["seeded"][variant]
        tag = f"11d ab_seeded_detection {variant}, first {AB_CPU_FRAMES} frames"
        sums = [(x["frames"], x["matches"], x["correct"]) for x in (g, c)]
        matches = [[row[0] for row in x["per_frame"]] for x in (g, c)]
        inliers = max(abs(a[1] - b[1]) for a, b in zip(g["per_frame"], c["per_frame"]))
        if sums[0] != sums[1] or matches[0] != matches[1] or inliers > COUNT_TOL:
            fail(f"{tag}: (frames, matches, 1 px correct) {sums[0]} on the card, {sums[1]} on "
                 f"the CPU; per-frame matches equal {matches[0] == matches[1]}; VO inliers "
                 f"up to {inliers} apart (tolerance {COUNT_TOL})")
        print(f"{tag}: (frames, matches, 1 px correct) {sums[0]} as the CPU's, every frame's "
              f"matches equal, VO inliers {g['inliers']} / {c['inliers']} (per frame at most "
              f"{inliers} apart, tolerance {COUNT_TOL}) [{smi}]", flush=True)
    if card_ab["diag"] != cpu["diag"]:
        fail(f"11d diag_rendered part 1: the card's rows {card_ab['diag']}, the CPU's "
             f"{cpu['diag']}")
    print(f"11d diag_rendered part 1: rows (frame, keypoints, share, median, p90) equal to "
          f"the CPU's: {card_ab['diag']} [{smi}]", flush=True)
    g, c = card_ab["motion"], cpu["motion"]
    tag = f"11d ab_motion_envelopes turn15deg idw+smoother, first {AB_CPU_FRAMES} frames"
    if g["counts"] != c["counts"]:
        fail(f"{tag}: (maps, closures, relocs, rejections) {g['counts']} on the card, "
             f"{c['counts']} on the CPU")
    dt = trajectory_gap(g["trajectory"], c["trajectory"], tag)
    print(f"{tag}: (maps, closures, relocs, rejections) {tuple(g['counts'])} as the CPU's, "
          f"frame for frame max |dt| {dt:.3e} m (tolerance {E2E_POSE_TOL_M}) [{smi}]",
          flush=True)

    for kname, errs in kernel_errs.items():
        report[kname]["max_abs_err_tools"] = max(errs)
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], max(errs))
    shutil.rmtree(TOOLS_DIR)
    return ({k: {name: c[k] for name, c in ex_counts.items()} for k in kernels.KERNELS},
            {k: {name: c[k] for name, c in tool_counts.items()} for k in kernels.KERNELS})


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from srrg2_proslam_tpu_torch import kernels
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.kernels import _build
    from srrg2_proslam_tpu_torch.kernels.brief import brief_descriptors, brief_descriptors_plain
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain
    from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo, gn_burst_stereo_plain
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig, initial_state, track_step
    from srrg2_proslam_tpu_torch.ops import se3

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
    # every pixel a candidate); K1 at its keypoints; K2 on frame 1's round 0
    noise = torch.randint(0, 256, images.shape, generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32).to(dev, torch.float32)
    errs, (active, iterations) = check_kernels(inp, cam, thr, "KITTI frames 0/1")
    check_fast(noise, thr, "uniform noise")
    kb, nb = fast_bound(images, thr), fast_bound(noise, thr)
    report["fast"] = {
        "max_abs_err": errs["fast"],
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
    report["brief"] = {
        "max_abs_err": errs["brief"],
        "ms": device_ms(lambda: brief_descriptors(smooth, y, x, valid),
                        kernel="brief_descriptors_kernel"),
        "plain_ms": device_ms(lambda: brief_descriptors_plain(smooth, y, x, valid)),
        "event_ms": cuda_ms(lambda: brief_descriptors(smooth, y, x, valid)),
        **dict(zip(("bound_ms", "bound_by"), brief_bound(smooth, y, x, valid)))}

    args, gn_kw = inp["gn_args"], inp["gn_kw"]
    pts = args[1]
    # bytes: X0, the mask, the active rows' point, measurement and weight,
    # the 19-word output; ops: the accumulation of the iterations this
    # run's data needs (the 6x6 solves add ~0.3 kflop each)
    report["gn_burst"] = {
        "max_abs_err": errs["gn_burst"],
        "ms": device_ms(lambda: gn_burst_stereo(*args, **gn_kw), kernel="gn_burst_stereo_kernel"),
        "plain_ms": device_ms(lambda: gn_burst_stereo_plain(*args, **gn_kw)),
        "event_ms": cuda_ms(lambda: gn_burst_stereo(*args, **gn_kw)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(64 + pts.shape[0] + active * 28 + 19 * 4,
                         GN_FLOPS_PER_TERM * active * iterations)))}
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

    vo_counts = counts

    # ---- 5. GraphSLAM over the rendered closed loop ------------------------
    from srrg2_proslam_tpu_torch.io import synthetic
    from srrg2_proslam_tpu_torch.models import loop_closure
    from srrg2_proslam_tpu_torch.utils import profiling

    scam = synthetic.synthetic_camera()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = list(synthetic.iter_rendered_loop(side_a=10.0, side_b=6.0, step_m=0.4,
                                             turn_frames=10, device=dev))
    torch.cuda.synchronize()
    n = len(loop)
    print(f"rendered loop: {n} frames {tuple(loop[0].left.shape)} on the card in "
          f"{time.perf_counter() - t0:.2f} s [{smi}]", flush=True)
    gpu_frames = [((f.left, f.right), f.timestamp) for f in loop]

    # the first pass: launches, the gate, and the inputs of every GN burst
    # of the run, captured through the kernel module
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded(kernels.gn, "gn_burst_stereo") as bursts:
        slam, rows = run_slam(gpu_frames, scam, dev, adapt_cfg)
    first_pass = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"GraphSLAM: {n} frames, {slam_counts(slam)}, closure events "
          f"{slam.closure_events}; launches {counts} [{smi}]", flush=True)
    if counts != {"fast": n, "brief": n, "gn_burst": 3 * n}:
        fail(f"GraphSLAM launch counts {counts} != fast {n}, brief {n}, gn_burst {3 * n}")
    loop_gate(slam, [f.gt_pose for f in loop], "rendered-loop", smi)

    # the kernels at this path's inputs: K3 and K1 on the first rendered
    # pair, K2 on every burst of the run (the busiest one printed)
    if len(bursts) != 3 * n:
        fail(f"captured {len(bursts)} GN bursts, not {3 * n}")
    active = [int(args[4].sum()) for args, _ in bursts]
    busiest = max(range(len(bursts)), key=active.__getitem__)
    loop_inp = frontend_inputs(torch.stack(gpu_frames[0][0]), adapt_cfg.extractor)
    loop_inp["gn_args"], loop_inp["gn_kw"] = bursts[busiest]
    loop_errs, _ = check_kernels(
        loop_inp, scam, thr, f"rendered loop (pair 0; GN burst {busiest % 3} of frame "
        f"{busiest // 3})")
    gn_errs = [check_gn(args, kw, scam, f"rendered loop burst {i}", quiet=True)[0]
               for i, (args, kw) in enumerate(bursts)]
    loop_errs["gn_burst"] = max(gn_errs)
    print(f"K2 gn    rendered loop, all {len(bursts)} bursts of the run: max_abs_err(X) "
          f"{max(gn_errs):.3e} (tolerance {GN_ATOL}), active rows {min(active)}-"
          f"{max(active)}, {sum(a == 0 for a in active)} empty", flush=True)
    for kname, e in loop_errs.items():
        report[kname]["max_abs_err_loop"] = e
        report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"], e)

    cpu_frames = [((f.left.cpu(), f.right.cpu()), f.timestamp) for f in loop]
    t0 = time.perf_counter()
    cpu_slam, cpu_rows = run_slam(cpu_frames, scam, "cpu", adapt_cfg,
                                  budget_s=CPU_BUDGET_S, min_maps=4)
    cpu_s = time.perf_counter() - t0
    m = len(cpu_rows)
    if m < n:
        print(f"CPU run stopped after {m} of {n} frames ({cpu_s:.1f} s, "
              f"{cpu_slam.num_maps} maps): comparing that prefix with a GPU run of it "
              f"[{smi}]", flush=True)
        ref_slam, ref_rows = run_slam(gpu_frames[:m], scam, dev, adapt_cfg)
    else:
        print(f"CPU run (plain versions) over all {n} frames: {cpu_s:.1f} s [{smi}]",
              flush=True)
        ref_slam, ref_rows = slam, rows
    compare_slam_runs(ref_slam, ref_rows, cpu_slam, cpu_rows,
                      "rendered loop, GPU vs CPU GraphSLAM", smi)

    # the second pass, timing off: GraphSLAM ms/frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam2, _ = run_slam(gpu_frames, scam, dev, adapt_cfg)
    slam_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"GraphSLAM ms/frame: {slam_ms:.3f} (second pass, adapt_stereo + process, "
          f"{slam2.num_maps} maps, no stage timing), first pass {first_pass / n * 1e3:.3f} "
          f"[{smi}]", flush=True)

    # the third pass: the stages under profile_time, each synchronized, and
    # the loop query's peak memory (reset before each split's query)
    query_peak, last_query = [0], {}
    real_detect = loop_closure.detect_and_validate

    def measured_detect(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out = real_detect(*args, **kw)
        torch.cuda.synchronize()
        query_peak[0] = max(query_peak[0], torch.cuda.max_memory_allocated(dev))
        last_query["desc"], last_query["valid"] = args[0], args[1]
        return out

    profiling.reset()
    profiling.enable()
    loop_closure.detect_and_validate = measured_detect
    try:
        run_slam(gpu_frames, scam, dev, adapt_cfg)
    finally:
        loop_closure.detect_and_validate = real_detect
        profiling.enable(False)
    for stage, st in profiling.stats().items():
        print(f"  stage {stage}: {st['calls']} calls, mean {st['mean_ms']:.3f} ms, total "
              f"{st['total_s'] * 1e3:.3f} ms (third pass, profile_time, synchronized) "
              f"[{smi}]", flush=True)
    print(f"  loop query peak allocated {query_peak[0] / 2**30:.3f} GiB (whole process, "
          f"torch.cuda.max_memory_allocated over detect_and_validate; {slam.db.num_slots} "
          f"slots x {slam.db.budget}) [{smi}]", flush=True)
    query_memory(dev, smi, last_query["desc"], last_query["valid"])

    # ---- 6. RGB-D GraphSLAM, the estimators and the motion prior -----------
    t6 = time.perf_counter()
    rgbd_counts = phase_rgbd(dev, smi, report, thr)
    phase_estimators(dev, smi, report, frames_np, frames_gpu, cam, adapt_cfg)
    print(f"phase 6: {time.perf_counter() - t6:.1f} s [{smi}]", flush=True)

    # ---- 7. the shipped configurations and the sequence API ---------------
    t7 = time.perf_counter()
    phase_adaptor_configs(dev, smi, frames_np, frames_gpu)
    seq_counts, seq_ms = phase_sequence(dev, smi, report, thr, loop, slam, rows, slam_ms,
                                        adapt_cfg)
    phase_shipped(dev, smi, frames_np, frames_gpu)
    print(f"phase 7: {time.perf_counter() - t7:.1f} s [{smi}]", flush=True)

    # ---- 8. the host surface: apps, checkpoints, trace, entry(), decoder ---
    t8 = time.perf_counter()
    app_counts = phase_host(dev, smi, report, frames_np, loop, slam, rows, slam_ms,
                            adapt_cfg)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s [{smi}]", flush=True)

    # ---- 9. the chunk program ------------------------------------------------
    t9 = time.perf_counter()
    chunk_counts, chunk_ref = phase_chunk(dev, smi, loop, slam, rows, slam_ms, seq_ms,
                                          adapt_cfg)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s [{smi}]", flush=True)

    # ---- 10. the multi-GPU slice ----------------------------------------------
    t10 = time.perf_counter()
    mesh_counts, mesh_frame_counts = phase_mesh(dev, smi, loop, slam, rows, slam_ms, chunk_ref)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s [{smi}]", flush=True)

    # ---- 11. the examples and tools ----------------------------------------------
    t11 = time.perf_counter()
    example_counts, tool_counts = phase_tools(dev, smi, report)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s [{smi}]", flush=True)

    sources = {"fast": ("srrg2_proslam_tpu_torch/csrc/fast.cu",
                        "srrg2_proslam_tpu/ops/fast_pallas.py:86"),
               "brief": ("srrg2_proslam_tpu_torch/csrc/brief.cu",
                         "srrg2_proslam_tpu/ops/brief_pallas.py:103"),
               "gn_burst": ("srrg2_proslam_tpu_torch/csrc/gn_burst.cu",
                            "srrg2_proslam_tpu/ops/gn_pallas.py:255")}
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[kname], "launches_per_frame": counts[kname] / n,
         "launches_vo": vo_counts[kname], "launches_vo_per_frame": vo_counts[kname] / len(frames_gpu),
         "launches_rgbd": rgbd_counts[kname],
         "launches_sequence": seq_counts[kname],
         "launches_chunk": chunk_counts[kname],
         "launches_mesh_per_rank": mesh_counts[kname],
         "launches_mesh_frame_per_rank": mesh_frame_counts[kname],
         **{f"launches_{path}": c[kname] for path, c in app_counts.items()},
         "launches_examples": example_counts[kname], "launches_tools": tool_counts[kname],
         "library_ms": None, **report[kname]}
        for kname, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tools-cpu-twins"]:
        tools_cpu_twins(sys.argv[2], sys.argv[3])
    else:
        main()
