"""Didactic example: dense 3-D unprojection of one RGB-D image pair.

The port's twin of apps/example_unproject_rgbd.py (the reference's
example_unproject_rgbd): load an intensity + depth image, unproject EVERY
valid depth pixel through the pinhole model (u, v, z) -> ((u-cx)z/fx,
(v-cy)z/fy, z) with the range gates range_min/range_max, and print the
unprojected count and timing (a warm-up call first, then one timed call
that ends in a synchronize of the card).  The reference's viewer thread
becomes an optional .npz cloud export (``--cloud``) for the offline
viewer.  Same flags and printed lines as the JAX app, plus ``--device``
(default ``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_unproject_rgbd \\
        [-i rgb.png -d depth.pgm] [--depth-scale 1e-3] [--cloud out.npz] \\
        [--device cuda|cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from ..io import datasets
from ..utils.profiling import sync

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "test_data")


def unproject_dense(depth_m: torch.Tensor, fx, fy, cx, cy, range_min=0.1, range_max=10.0):
    """[H, W] depth (meters) -> ([H*W, 3] camera-frame points, [H*W] valid)."""
    H, W = depth_m.shape
    v = torch.arange(H, dtype=torch.float32, device=depth_m.device)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=depth_m.device)[None, :].expand(H, W)
    z = depth_m
    pts = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], dim=-1)
    ok = (z >= range_min) & (z <= range_max)
    return pts.reshape(-1, 3), ok.reshape(-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image-rgb", default=os.path.join(ROOT, "xtion", "image_rgb.png"))
    ap.add_argument("-d", "--image-depth",
                    default=os.path.join(ROOT, "xtion", "image_depth.pgm"))
    ap.add_argument("--depth-scale", type=float, default=1e-3,
                    help="raw depth units -> meters (bundled PGMs are mm)")
    ap.add_argument("--fx", type=float, default=269.853)
    ap.add_argument("--fy", type=float, default=269.733)
    ap.add_argument("--cx", type=float, default=157.051)
    ap.add_argument("--cy", type=float, default=113.118)
    ap.add_argument("--range-min", type=float, default=0.1)
    ap.add_argument("--range-max", type=float, default=10.0)
    ap.add_argument("--cloud", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    gray = datasets.load_gray(args.image_rgb)
    depth = torch.as_tensor(datasets.load_depth(args.image_depth) * args.depth_scale,
                            device=device)
    print(f"image: {gray.shape}, depth: {tuple(depth.shape)} (scale {args.depth_scale})")

    def fn(d):
        return unproject_dense(d, args.fx, args.fy, args.cx, args.cy,
                               args.range_min, args.range_max)

    fn(depth)                                    # warm-up
    sync(device)
    t0 = time.perf_counter()
    pts, ok = fn(depth)
    n = int(ok.sum())                            # consume = honest timing
    dt = time.perf_counter() - t0
    print(f"# unprojected points: {n}")
    print(f"unprojection duration (s): {dt:.4f} (Hz): {1 / dt:.1f}")
    pts_np, ok_np = pts.cpu().numpy(), ok.cpu().numpy()
    z = pts_np[:, 2][ok_np]
    print(f"depth median (m): {np.median(z):.3f} range [{z.min():.3f}, {z.max():.3f}]")

    if args.cloud:
        np.savez(args.cloud, points=pts_np, valid=ok_np, intensity=gray.reshape(-1))
        print(f"cloud written: {args.cloud} (render with apps/export_viewer.py)")


if __name__ == "__main__":
    main()
