"""Didactic example: the projective matcher's search-region patterns.

The port's twin of apps/example_search_patterns.py (the reference's
example_projective_search_patterns): rasterizes the square / circle /
rhombus candidate regions of the projective correspondence finders onto a
500x500 canvas with the SAME predicate the matcher evaluates —
``_geometric_distance(dx, dy, norm) <= radius`` over a dense pixel grid
(ops/matching.py) — at the reference's sample positions and radii, and
writes the canvas as a PGM next to an ASCII thumbnail.  Same flags and
printed lines as the JAX app, plus ``--device`` (default ``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_search_patterns \\
        [--out patterns.pgm] [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from ..io.datasets import save_gray
from ..ops.matching import _geometric_distance

#: (radius, row, col) samples of the reference example (rows 60-76)
SAMPLES = [(100, 150, 150), (50, 325, 325), (10, 410, 410), (5, 450, 450)]
#: norm -> painted intensity (reference uses 75 / 150 / 255)
PATTERNS = [("square", 75), ("circle", 150), ("rhombus", 255)]


def paint(canvas: np.ndarray, norm: str, color: int, device=torch.device("cuda")):
    """Paint ``norm``'s region of every sample onto ``canvas`` (uint8
    [H, W], in place) with ``color``; the predicate runs on ``device``."""
    H, W = canvas.shape
    r = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    c = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    for radius, row, col in SAMPLES:
        inside = _geometric_distance((c - col).expand(H, W), (r - row).expand(H, W),
                                     norm) <= radius
        canvas[inside.cpu().numpy()] = color
    return canvas


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="patterns.pgm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    canvas = np.zeros((500, 500), np.uint8)
    for norm, color in PATTERNS:
        canvas = paint(canvas, norm, color, device)
        area = int((canvas == color).sum())
        print(f"{norm:8s} regions painted at {len(SAMPLES)} scales "
              f"(intensity {color}, {area} px visible)")

    save_gray(args.out, canvas.astype(np.float32))
    print(f"canvas written: {args.out} "
          "(square | circle | rhombus, like the reference window)")

    # ASCII thumbnail (a headless machine has no display)
    th = canvas[::12, ::6]
    chars = np.array([" ", ".", "o", "#"])
    idx = np.searchsorted([1, 100, 200], th)
    for line in chars[idx]:
        print("".join(line))


if __name__ == "__main__":
    main()
