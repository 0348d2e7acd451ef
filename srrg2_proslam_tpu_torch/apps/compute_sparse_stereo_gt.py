"""Sparse stereo ground truth from a dense disparity image.  The port's
twin of apps/compute_sparse_stereo_gt.py.

FAST keypoints of the left image (``ops/features.py::detect_keypoints``,
on ``--device``: the FAST kernel on the card) are looked up in a dense
left-to-right disparity image, and the valid stereo matches are written
as ``gt_stereo_matching_threshold-<t>.txt`` lines

    row col_left  row col_right  disparity      (col_right = col_left - d)

sorted by row, the format of the bundled ``test_data/scene_flow``
fixtures.  Disparity inputs: SceneFlow ``.pfm``, ``.npy``/``.npz``, or a
16-bit PNG/PGM scaled by ``--disparity-scale``.

    python -m srrg2_proslam_tpu_torch.apps.compute_sparse_stereo_gt \\
        -l left.png -r right.png -d disparity.pfm [-t 10] [-o out_dir] [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

from ..io import datasets
from ..ops import features as F


def load_disparity(path: str, scale: float) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        return datasets.read_pfm(path)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".npz":
        z = np.load(path)
        return z[list(z.files)[0]].astype(np.float32)
    return datasets.load_depth(path).astype(np.float32) * scale


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m srrg2_proslam_tpu_torch.apps.compute_sparse_stereo_gt")
    ap.add_argument("-l", "--image-left", required=True)
    ap.add_argument("-r", "--image-right", required=True)
    ap.add_argument("-d", "--image-disparity", required=True)
    ap.add_argument("-t", "--detector-threshold", type=int, default=10)
    ap.add_argument("--disparity-scale", type=float, default=1.0,
                    help="raw units -> pixels for integer disparity images")
    ap.add_argument("-n", "--keypoints", type=int, default=2000)
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--device", default="cuda", help="torch device of the detector")
    args = ap.parse_args(argv)

    L = datasets.load_gray(args.image_left)
    R = datasets.load_gray(args.image_right)
    disp = load_disparity(args.image_disparity, args.disparity_scale)
    if L.shape != R.shape:
        sys.exit("ERROR: image right has inconsistent dimension w.r.t. left")
    if L.shape != disp.shape:
        sys.exit("ERROR: disparity image has inconsistent dimension "
                 f"w.r.t. left ({disp.shape} vs {L.shape})")

    cfg = F.FeatureExtractorConfig(max_keypoints=args.keypoints,
                                   detector_threshold=float(args.detector_threshold))
    uv, _, valid = F.detect_keypoints(torch.from_numpy(L).to(args.device), cfg)
    uv, valid = uv.cpu().numpy(), valid.cpu().numpy()
    print(f" # detected keypoints (LEFT): {int(valid.sum())}")

    rows = []
    for (u, v), ok in zip(uv, valid):
        if not ok:
            continue
        c, r = int(round(u)), int(round(v))
        d = float(disp[r, c])
        if d <= 0:                    # invalid disparity
            continue
        c_right = c - d
        if c_right < 0:               # outside the right image
            continue
        rows.append((r, c, r, c_right, d))
    rows.sort()

    out = os.path.join(args.out_dir,
                       f"gt_stereo_matching_threshold-{args.detector_threshold}.txt")
    with open(out, "w") as f:
        for r, c, r2, cr, d in rows:
            f.write(f"{r} {c} {r2} {cr:.6g} {d:.6g}\n")
    print(f" # validated stereo matches: {len(rows)}")
    print(f"ground truth written: {out}")


if __name__ == "__main__":
    main()
