"""K3: FAST-9/16 corner score (csrc/fast.cu) and its plain version.

Replaces srrg2_proslam_tpu/ops/fast_pallas.py::fast_scores_pallas.  Like
that kernel, the ring reads zeros outside the image; features.fast_scores
wraps around instead, and the two agree away from the 3-px edge, which the
detector's BORDER mask hides.

The kernel first runs a compass test on every pixel (4 min/max, 4
subtractions, 4 comparisons): a polarity without two adjacent compass
differences beyond the threshold cannot score above it.  Only the set
polarities of the pixels that pass (about a fifth of the pixels on KITTI,
seven eighths on uniform noise) are compacted into a list and scored, each
with 57 min/max over its 16 ring values and 1 subtraction.  Its bound is
then its bytes on camera images (one float read and one written per pixel)
and min/max on the ALU pipe on noise; what it reaches is set by the latency
of its phases (PERF.md).  The early reject is exact: the output equals the
plain version bit for bit, which forms all 16 differences and both
polarities' arcs for every pixel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ..ops.features import fast_scores

launches = 0


def fast_scores_plain(images: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST score of [B, H, W] with a zero-padded ring (the kernel's edge rule).

    On the 3-px zero frame the rolled ring of ``fast_scores`` never wraps
    for the image's own pixels.
    """
    padded = F.pad(images, (3, 3, 3, 3))
    return fast_scores(padded, threshold)[..., 3:-3, 3:-3].contiguous()


def fast_scores_kernel(images: torch.Tensor, threshold: float) -> torch.Tensor:
    """[B, H, W] float32 -> [B, H, W] float32 FAST scores (0 below threshold)."""
    global launches
    if images.dim() != 3 or images.dtype != torch.float32:
        raise ValueError(f"fast: need [B, H, W] float32, got "
                         f"{tuple(images.shape)} {images.dtype}")
    if not images.is_cuda:
        return fast_scores_plain(images, threshold)
    if not images.is_contiguous():
        raise ValueError("fast: input must be contiguous")
    B, H, W = images.shape
    out = torch.empty_like(images)
    lib = _build.library()
    err = lib.fast_scores_launch(
        images.data_ptr(), out.data_ptr(), B, H, W, float(threshold),
        torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "fast_scores_launch")
    launches += 1
    return out
