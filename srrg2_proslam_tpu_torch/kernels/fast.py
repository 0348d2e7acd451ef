"""K3: FAST-9/16 corner score (csrc/fast.cu) and its plain version.

Replaces srrg2_proslam_tpu/ops/fast_pallas.py::fast_scores_pallas.  Like
that kernel, the ring reads zeros outside the image; features.fast_scores
wraps around instead, and the two agree away from the 3-px edge, which the
detector's BORDER mask hides.

On the card the kernel is bound by memory traffic (one float read and one
written per pixel, the ring read from a shared-memory tile with a 3-px
halo); the plain version materialises 16 shifted copies and ~100 full-image
min/max passes.
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
