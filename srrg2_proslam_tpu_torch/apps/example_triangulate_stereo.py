"""Didactic example: stereo adaptation + rigid rectified triangulation.

The port's twin of apps/example_triangulate_stereo.py (the reference's
example_triangulate_rigid_stereo): run the stereo measurement adaptor on
one image pair, triangulate the 4-D measurements (z = baseline_px /
disparity, midpoint v), print the triangulated/total counts, and
optionally export the stereo-match visualization (``--render``, drawn
with matplotlib where it imports, else a gray canvas) and the 3-D cloud
(``--cloud``) for the offline viewer.  Same flags and printed lines as the
JAX app, plus ``--device`` (default ``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_triangulate_stereo \\
        [--left L.png --right R.png] [--fx FX --baseline-px B] \\
        [--render matches.png] [--cloud cloud.npz] [--device cuda|cpu]
"""
import argparse
import os

import numpy as np
import torch

from ..io import datasets
from ..models.frontend import StereoAdaptorConfig, adapt_stereo
from ..ops.triangulation import triangulate_rectified

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "test_data")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", default=os.path.join(ROOT, "kitti", "city", "image_left_0.png"))
    ap.add_argument("--right", default=os.path.join(ROOT, "kitti", "city", "image_right_0.png"))
    ap.add_argument("--fx", type=float, default=None,
                    help="focal length (default: bundled-KITTI calibration)")
    ap.add_argument("--baseline-px", type=float, default=None)
    ap.add_argument("--render", default=None,
                    help="write a stereo-match visualization PNG")
    ap.add_argument("--cloud", default=None,
                    help="write the triangulated cloud as .npz (points, valid)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    L = datasets.load_gray(args.left)
    R = datasets.load_gray(args.right)
    cam = datasets.kitti_camera(*L.shape)
    if args.fx is not None:
        cam = cam._replace(fx=args.fx, fy=args.fx)
    if args.baseline_px is not None:
        cam = cam._replace(baseline_px=args.baseline_px)

    meas = adapt_stereo(torch.as_tensor(L, device=device), torch.as_tensor(R, device=device),
                        StereoAdaptorConfig())
    n_meas = int(meas.valid.sum())
    pts, ok = triangulate_rectified(cam, meas.points, meas.valid)
    n_tri = int(ok.sum())
    print(f"# stereo measurements: {n_meas}/{meas.points.shape[0]}")
    print(f"# triangulated points: {n_tri}/{n_meas}")
    pts_np, ok_np = pts.cpu().numpy(), ok.cpu().numpy()
    z = pts_np[:, 2][ok_np]
    print(f"depth range (m): [{z.min():.2f}, {z.max():.2f}], "
          f"median {np.median(z):.2f}")

    if args.render:
        # top: left image with left keypoints; bottom: right image with the
        # matched right keypoints (the reference's vconcat + green lines)
        canvas = np.concatenate([L, R], axis=0)
        canvas = np.stack([canvas] * 3, axis=-1).astype(np.uint8)
        H = L.shape[0]
        p = meas.points.cpu().numpy()
        for (uL, vL, uR, vR), good in zip(p, ok_np):
            if not good:
                continue
            canvas[int(vL), int(uL)] = (0, 255, 0)
            canvas[int(vR) + H, int(uR)] = (0, 255, 0)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(10, 7))
            ax.imshow(canvas)
            for (uL, vL, uR, vR), good in zip(p[::7], ok_np[::7]):
                if good:
                    ax.plot([uL, uR], [vL, vR + H], "g-", lw=0.3)
            ax.set_title("stereo matches (top: left, bottom: right)")
            fig.savefig(args.render, dpi=110)
            print(f"match visualization written: {args.render}")
        except Exception as e:  # matplotlib-free fallback: raw canvas
            datasets.save_gray(args.render, canvas.mean(-1))
            print(f"matplotlib unavailable ({e}); wrote gray canvas")

    if args.cloud:
        np.savez(args.cloud, points=pts_np, valid=ok_np)
        print(f"triangulated cloud written: {args.cloud} "
              "(render with apps/export_viewer.py)")


if __name__ == "__main__":
    main()
