#!/usr/bin/env python3
"""GPU benchmark of the PyTorch + CUDA port: the whole GraphSLAM loop over
the rendered closed-loop sequence of bench.py, on one CUDA card.

Usage (needs a CUDA card; builds the kernels from csrc/ on first use):

    python3 bench_torch.py

Prints ONE JSON line on stdout: {"metric": "mean_frame_hz", "value",
"unit", "vs_baseline", "mean_frame_hz", "card", ...}; diagnostics go to
stderr.

The metric is bench.py's: frames divided by the wall time of whole passes
that include the adaptor, the tracker, splits, loop closure,
relocalisation and PGO (reference app_benchmark.cpp:350-366).  The frames
are bench.py's sequence (its ``_render_sequence``: the 253-frame loop of
``loop_trajectory()`` in a 22 x 32 m room, 480x640, rendered on the card
before timing) and the GraphSLAM config is bench.py's ``_slam_config``.

Headline: ``process_sequence`` with ``chunk_size`` 16, the chunk program
(models/chunk.py: the batched adaptor and one CUDA graph replay of the
chunk's tracker steps per chunk, chunk_lag 2), the median of 3 passes
after a warm-up pass (which builds the kernels and captures the graphs).  Diagnostics: the per-frame ``adapt_stereo -> process``
loop at speculation depth 12 and synchronously, one pass each after the
headline.  Each pass ends in a synchronize, so its wall time holds all
its device work.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_FRAME_HZ = 100.0   # bench.py's reference-class anchor
N_FRAMES = 253               # bench.py's sequence: the whole loop
CHUNK = 16                   # chunk_size of the headline, as the shipped configs
SPEC_DEPTH = 12              # speculation depth of bench.py's per-frame diagnostic


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def render_sequence(n_frames: int, device):
    """bench.py's ``_render_sequence`` with the port's renderer: the
    images stay on the card."""
    import torch

    from srrg2_proslam_tpu_torch.io import synthetic as syn

    cam = syn.synthetic_camera()
    planes = syn.make_room(size_x=22.0, size_z=32.0, device=device)
    poses = syn.loop_trajectory()[:n_frames]
    images = [syn.render_stereo(cam, torch.as_tensor(T, device=device), planes)[:2]
              for T in poses]
    torch.cuda.synchronize()
    return cam, images


def slam_config(speculation_depth: int = 0, chunk_size: int = 0):
    """bench.py's ``_slam_config``."""
    from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAMConfig, SplittingConfig
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig

    return GraphSLAMConfig(
        tracker=TrackerConfig(gn_epsilon=1e-5),
        splitting=SplittingConfig(maximum_translation_m=5.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=2048, database_capacity=16384, max_db_descriptors_per_map=512,
        max_local_maps=128, max_edges=512,
        speculation_depth=speculation_depth, chunk_size=chunk_size)


def run_sequence(cam, left_all, right_all, acfg, chunk_size, device):
    """One pass through ``process_sequence``; returns (seconds, slam)."""
    import torch

    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    slam = GraphSLAM(cam, slam_config(chunk_size=chunk_size), device=device)
    n = int(left_all.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.process_sequence(left_all, right_all, [0.1 * i for i in range(n)], acfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, slam


def run_per_frame(cam, images, acfg, depth, device):
    """One pass of ``adapt_stereo -> process`` per frame, then ``flush``."""
    import torch

    from srrg2_proslam_tpu_torch.models.frontend import adapt_stereo
    from srrg2_proslam_tpu_torch.models.slam import GraphSLAM

    slam = GraphSLAM(cam, slam_config(speculation_depth=depth), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(images):
        meas = adapt_stereo(left, right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, 0.1 * i)
    slam.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, slam


def describe(slam) -> str:
    return (f"{slam.num_maps} maps, {slam.num_closures} closures, "
            f"{slam.num_relocalizations} relocalisations, {slam.num_replayed_frames} "
            f"frames replayed; chunk program {slam.chunk_stats}")


def main():
    import torch

    if not torch.cuda.is_available():
        _err("bench_torch.py needs a CUDA card")
        raise SystemExit(1)
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    acfg = StereoAdaptorConfig()

    t0 = time.perf_counter()
    cam, images = render_sequence(N_FRAMES, dev)
    left_all = torch.stack([im[0] for im in images])
    right_all = torch.stack([im[1] for im in images])
    _err(f"rendered {N_FRAMES} frames on the card in {time.perf_counter() - t0:.2f} s "
         f"[{card}]")

    warm, _ = run_sequence(cam, left_all, right_all, acfg, CHUNK, dev)  # builds the kernels
    times = []
    for _ in range(3):
        dt, slam_c = run_sequence(cam, left_all, right_all, acfg, CHUNK, dev)
        times.append(dt)
    hz = N_FRAMES / float(np.median(times))
    _err(f"process_sequence (chunk_size {CHUNK}): {hz:.2f} frames/s, passes "
         f"{[round(t, 3) for t in times]} s (warm-up {warm:.3f} s); {describe(slam_c)} "
         f"[{card}]")

    dt_spec, slam_p = run_per_frame(cam, images, acfg, SPEC_DEPTH, dev)
    _err(f"per-frame speculative (depth {SPEC_DEPTH}): {N_FRAMES / dt_spec:.2f} frames/s "
         f"({dt_spec:.3f} s); {describe(slam_p)} [{card}]")
    dt_sync, slam_s = run_per_frame(cam, images, acfg, 0, dev)
    _err(f"per-frame synchronous (depth 0): {N_FRAMES / dt_sync:.2f} frames/s "
         f"({dt_sync:.3f} s); {describe(slam_s)} [{card}]")

    print(json.dumps({
        "metric": "mean_frame_hz",
        "value": round(hz, 2),
        "unit": "frames/s",
        "vs_baseline": round(hz / REFERENCE_FRAME_HZ, 3),
        "mean_frame_hz": hz,
        "card": card,
        "frames": N_FRAMES,
        "sequence_pass_s": times,
        "speculative_frame_hz": N_FRAMES / dt_spec,
        "synchronous_frame_hz": N_FRAMES / dt_sync,
        "maps": slam_c.num_maps, "closures": slam_c.num_closures,
        "relocalisations": slam_c.num_relocalizations,
    }), flush=True)


if __name__ == "__main__":
    main()
