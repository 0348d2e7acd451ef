"""Didactic example: binned + selective (seeded) feature extraction.

The port's twin of apps/example_feature_extractor.py (the reference's
example_feature_extractor): detect keypoints on a "moving" image with the
binned extractor (per-grid-region top-K), then — seeding mode — re-detect
on a "fixed" image restricted to masks around the moving keypoints'
projections, over 20 iterations with a shrinking detection radius
round(100 / (i + 1)) as the reference's loop does, printing extracted
counts and timings per iteration.  Each timing ends in a synchronize of
the card, so it times the device work and not its enqueue.  Same flags and
printed lines as the JAX app, plus ``--device`` (default ``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_feature_extractor \\
        [--moving M.png] [--fixed F.png] [-n 100] [--seeded] [--device cuda|cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from ..io import datasets
from ..ops import features as F
from ..utils.profiling import sync

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "test_data")


def radius_mask(rows, cols, uv, valid, radius):
    """Binary detection mask [rows, cols]: True within ``radius`` px of a
    valid seed (the selective extractor's projection masks,
    intensity_feature_extractor_selective.cpp:66-67), on ``uv``'s device."""
    r = torch.arange(rows, dtype=torch.float32, device=uv.device)[:, None].expand(rows, cols)
    c = torch.arange(cols, dtype=torch.float32, device=uv.device)[None, :].expand(rows, cols)
    u = torch.where(valid, uv[:, 0], -1e9)
    v = torch.where(valid, uv[:, 1], -1e9)
    d2 = (r[:, :, None] - v[None, None, :]) ** 2 + (c[:, :, None] - u[None, None, :]) ** 2
    return d2.amin(dim=-1) <= radius * radius


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--moving", default=os.path.join(ROOT, "scene_flow", "image_left.png"))
    ap.add_argument("--fixed", default=None,
                    help="measurement image (default: same as --moving)")
    ap.add_argument("-n", "--keypoints", type=int, default=100)
    ap.add_argument("--threshold", type=float, default=10.0)
    ap.add_argument("--seeded", action="store_true",
                    help="selective mode: mask detection around the moving "
                         "image's keypoints (reference -es flag)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    moving = torch.as_tensor(datasets.load_gray(args.moving), device=device)
    fixed = torch.as_tensor(datasets.load_gray(args.fixed or args.moving), device=device)
    H, W = moving.shape
    cfg = F.FeatureExtractorConfig(max_keypoints=args.keypoints,
                                   detector_threshold=args.threshold)

    sync(device)
    t0 = time.perf_counter()
    uv, _, valid = F.detect_keypoints(moving, cfg)
    n = int(valid.sum())
    sync(device)
    dt = time.perf_counter() - t0
    print(f"MOVING image (seeding): {args.moving}")
    print(f"  # target keypoints: {args.keypoints}")
    print(f"  # extracted features: {n}")
    print(f"  extraction duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")

    if not args.seeded:
        # binned mode: the detector grid IS the binning; report the
        # per-region distribution
        gr, gc = cfg.grid_rows, cfg.grid_cols
        counts = np.zeros((gr, gc), int)
        for (u, v), ok in zip(uv.cpu().numpy(), valid.cpu().numpy()):
            if ok:
                counts[min(int(v) * gr // H, gr - 1), min(int(u) * gc // W, gc - 1)] += 1
        print(f"  per-region counts ({gr}x{gc} grid):")
        for row in counts:
            print("   ", " ".join(f"{c:3d}" for c in row))
        return

    # selective/tracking mode: shrinking detection radius, reference loop
    for i in range(20):
        radius = round(100.0 / (i + 1))
        sync(device)
        t0 = time.perf_counter()
        mask = radius_mask(H, W, uv, valid, radius)
        _, _, valid2 = F.detect_keypoints(fixed, cfg, mask=mask)
        n2 = int(valid2.sum())
        sync(device)
        dt = time.perf_counter() - t0
        print("-" * 67)
        print(f"iteration: {i}")
        print(f"  detection radius (px): {radius}")
        print(f"  # extracted features: {n2}")
        print(f"  extraction duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")


if __name__ == "__main__":
    main()
