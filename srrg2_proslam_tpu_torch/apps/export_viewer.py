"""Trajectory visualization export (offline), the port's copy of
apps/export_viewer.py.

The reference renders live through its GL viewport; a headless machine
has no GL, so this tool renders the equivalent artifact offline with
matplotlib: the top-down trajectory against ground truth.  It holds no
tensor code; matplotlib is imported when ``main`` runs, and where it is
not installed that ``ImportError`` reaches the caller.

    python -m srrg2_proslam_tpu_torch.apps.export_viewer --trajectory traj_kitti.txt \\
        [--gt 00_gt.txt] [--output viewer.png]
"""
import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trajectory", required=True,
                    help="KITTI-format trajectory (rows of 3x4)")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--output", default="viewer.png")
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.loadtxt(args.trajectory).reshape(-1, 3, 4)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(est[:, 0, 3], est[:, 2, 3], "-", lw=1.5, label="estimate")
    if args.gt:
        gt = np.loadtxt(args.gt).reshape(-1, 3, 4)[: est.shape[0]]
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(os.path.basename(args.trajectory))
    fig.savefig(args.output, dpi=130, bbox_inches="tight")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
