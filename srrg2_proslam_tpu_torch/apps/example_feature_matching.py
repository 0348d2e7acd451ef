"""Didactic example: feature extraction + stereo matching on one image pair.

The port's twin of apps/example_feature_matching.py (the reference's
example_feature_extraction / example_feature_matcher_bruteforce /
example_sparse_stereo_matching): prints stage-by-stage statistics and
optionally renders a match visualization (``--render``, needs
matplotlib).  Same flags and printed lines as the JAX app, plus
``--device`` (default ``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_feature_matching \\
        [--left L.png --right R.png] [--render out.png] [--device cuda|cpu]
"""
import argparse
import os

import numpy as np
import torch

from ..io import datasets
from ..ops.features import FeatureExtractorConfig, extract_features
from ..ops.matching import (
    BruteforceMatcherConfig, EpipolarMatcherConfig, match_bruteforce, match_epipolar,
)
from ..ops.triangulation import triangulate_rectified

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "test_data")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", default=os.path.join(ROOT, "scene_flow", "image_left.png"))
    ap.add_argument("--right", default=os.path.join(ROOT, "scene_flow", "image_right.png"))
    ap.add_argument("--render", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    L = torch.as_tensor(datasets.load_gray(args.left), device=device)
    R = torch.as_tensor(datasets.load_gray(args.right), device=device)
    cfg = FeatureExtractorConfig()

    fl = extract_features(L, cfg)
    fr = extract_features(R, cfg)
    print(f"keypoints: left={int(fl.valid.sum())} right={int(fr.valid.sum())} "
          f"(capacity {cfg.max_keypoints}, grid {cfg.grid_rows}x{cfg.grid_cols})")

    bf = match_bruteforce(fl.desc, fl.valid, fr.desc, fr.valid, BruteforceMatcherConfig())
    print(f"brute-force matches (bijective + Lowe): {int(bf.count)}")

    ep = match_epipolar(fl.uv, fl.desc, fl.valid, fr.uv, fr.desc, fr.valid,
                        EpipolarMatcherConfig())
    print(f"epipolar stereo matches: {int(ep.count)}")

    idx = torch.clamp_min(ep.idx, 0).long()
    pts4 = torch.stack([fl.uv[:, 0], fl.uv[:, 1], fr.uv[idx, 0], fr.uv[idx, 1]], dim=-1)
    cam = datasets.kitti_camera(*L.shape)
    pts3, ok = triangulate_rectified(cam, pts4, ep.mask)
    z = pts3[:, 2].cpu().numpy()[ok.cpu().numpy()]
    if z.size:
        print(f"triangulated: {z.size} points, depth 10/50/90%: "
              f"{np.percentile(z, [10, 50, 90]).round(1)} m")

    if args.render:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(12, 5))
        ax.imshow(L.cpu().numpy(), cmap="gray")
        mask = ep.mask.cpu().numpy()
        uv = fl.uv.cpu().numpy()[mask]
        uvr = fr.uv.cpu().numpy()[idx.cpu().numpy()][mask]
        ax.scatter(uv[:, 0], uv[:, 1], s=6, c="lime")
        for (u0, v0), (u1, _) in zip(uv, uvr):
            ax.plot([u0, u1], [v0, v0], "r-", lw=0.5)
        ax.set_title("left keypoints + disparity vectors")
        fig.savefig(args.render, dpi=120, bbox_inches="tight")
        print(f"wrote {args.render}")


if __name__ == "__main__":
    main()
