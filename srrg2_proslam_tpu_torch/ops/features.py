"""FAST-9/16 + upright BRIEF-256 feature frontend over whole images.

Port of srrg2_proslam_tpu/ops/features.py (upright path).  Detection is
dense: FAST score for every pixel, 3x3 non-maximum suppression by max
pooling, per-grid-region top-k quotas with a validity mask, and a parabola
fit on the FAST score for sub-pixel keypoints.  Descriptors are BRIEF-256
on a box-smoothed image.

On a CUDA batch the FAST score comes from the hand-written kernel K3
(kernels/fast.py) and the descriptors from the per-keypoint kernel K1
(kernels/brief.py); on the CPU the same functions as the JAX package's
CPU path run (``fast_scores`` and the per-keypoint gather of
``compute_descriptors``), so the two packages agree bit for bit there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# FAST Bresenham circle of radius 3, 16 offsets in clockwise order (dy, dx).
_FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

_ARC_LENGTH = 9  # FAST-9

# BRIEF-256 sampling pattern: pairs drawn from N(0, (patch/2.2)^2), clipped
# to the 31x31 patch, frozen with the JAX package's seed and recipe.
_PATCH_RADIUS = 15
_rng = np.random.RandomState(0xB51EF)
_BRIEF_PAIRS = np.clip(
    np.round(_rng.normal(0.0, _PATCH_RADIUS / 2.2, size=(256, 2, 2))),
    -_PATCH_RADIUS,
    _PATCH_RADIUS,
).astype(np.int32)  # [256, {p,q}, {dy,dx}]
del _rng

BORDER = _PATCH_RADIUS + 3  # keypoints keep both FAST circle and BRIEF patch inside


@dataclass(frozen=True)
class FeatureExtractorConfig:
    """Same fields and defaults as the JAX package's config.

    ``use_pallas_fast`` forces the FAST kernel's wrapper on the CPU too;
    ``approx_top_k`` selects exact top-k in the port (what JAX computes on
    the CPU).  ``dense_brief`` is kept for parity and has no effect: a CUDA
    batch always takes the K1 kernel, a CPU batch its per-keypoint gather.
    """

    detector_threshold: float = 15.0
    grid_rows: int = 3
    grid_cols: int = 3
    max_keypoints: int = 1152
    enable_nms: bool = True
    nms_window: int = 3
    smoothing_window: int = 5
    use_pallas_fast: bool = False
    approx_top_k: bool = True
    oriented: bool = False
    dense_brief: bool = True


class Features(NamedTuple):
    """Fixed-capacity keypoint sets (leading batch dims pass through)."""

    uv: torch.Tensor        # [..., N, 2] float32 (u=col, v=row)
    response: torch.Tensor  # [..., N] float32 FAST score
    desc: torch.Tensor      # [..., N, 256] int8 in {-1, +1}
    valid: torch.Tensor     # [..., N] bool


def fast_scores(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 score [..., H, W] (0 where not a corner).

    The 16 ring samples wrap around the image edge (``torch.roll``), as
    the JAX package's ``fast_scores`` does; the detector's BORDER mask
    hides the difference from zero padding.
    """
    shifted = torch.stack(
        [torch.roll(image, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
         for dy, dx in _FAST_OFFSETS],
        dim=0,
    )
    bright = shifted - image[None]
    dark = image[None] - shifted

    def arc_score(diff):
        # max over the 16 cyclic 9-arcs of the arc minimum, with the
        # min9 = min(min3(r), min3(r+3), min3(r+6)) tree
        d2 = torch.cat([diff, diff[: _ARC_LENGTH - 1]], dim=0)
        m3 = torch.minimum(torch.minimum(d2[0:22], d2[1:23]), d2[2:24])
        mins = [torch.minimum(torch.minimum(m3[r], m3[r + 3]), m3[r + 6])
                for r in range(16)]
        return torch.stack(mins, dim=0).amax(dim=0)

    score = torch.maximum(arc_score(bright), arc_score(dark))
    return torch.where(score > threshold, score, 0.0)


def _same_pad(window: int):
    lo = (window - 1) // 2
    return lo, window - 1 - lo


def _maxpool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max pool over the last two dims, SAME padding with -inf."""
    lo, hi = _same_pad(window)
    shape = x.shape
    x4 = x.reshape((-1, 1) + shape[-2:])
    x4 = F.pad(x4, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x4, window, stride=1).reshape(shape)


def _boxfilter(x: torch.Tensor, window: int) -> torch.Tensor:
    """Box mean over the last two dims, SAME padding with zeros.

    Two separable sums, rows then columns, each in window order, then one
    divide by window^2: the JAX package's order of float operations.
    """
    lo, hi = _same_pad(window)
    H, W = x.shape[-2:]
    p = F.pad(x, (0, 0, lo, hi))
    s = p[..., 0:H, :]
    for k in range(1, window):
        s = s + p[..., k:k + H, :]
    p = F.pad(s, (lo, hi))
    s = p[..., 0:W]
    for k in range(1, window):
        s = s + p[..., k:k + W]
    return s / float(window * window)


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k along dim 1; ties go to the lowest index, as jax.lax.top_k."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def detect_keypoints_batch(images: torch.Tensor, config: FeatureExtractorConfig):
    """FAST detection with NMS and per-grid-region quotas on [B, H, W].

    Returns (uv [B,N,2], response [B,N], valid [B,N]) with
    N = config.max_keypoints.  A CUDA batch takes the FAST kernel.
    """
    B, H, W = images.shape
    if config.use_pallas_fast or images.is_cuda:
        from ..kernels.fast import fast_scores_kernel

        score_raw = fast_scores_kernel(images, config.detector_threshold)
    else:
        score_raw = fast_scores(images, config.detector_threshold)
    score = score_raw
    if config.enable_nms:
        pooled = _maxpool2d(score, config.nms_window)
        score = torch.where(score >= pooled, score, 0.0)
    dev = images.device
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    in_border = (row >= BORDER) & (row < H - BORDER) & (col >= BORDER) & (col < W - BORDER)
    score = torch.where(in_border[None], score, 0.0)

    gr, gc = config.grid_rows, config.grid_cols
    n_regions = gr * gc
    k_region = config.max_keypoints // n_regions
    Hp = -(-H // gr) * gr
    Wp = -(-W // gc) * gc
    score_p = F.pad(score, (0, Wp - W, 0, Hp - H))
    rh, cw = Hp // gr, Wp // gc
    regions = score_p.reshape(B, gr, rh, gc, cw) \
                     .permute(0, 1, 3, 2, 4) \
                     .reshape(B * n_regions, rh * cw)
    top_scores, top_idx = _top_k(regions, k_region)
    top_scores = top_scores.reshape(B, n_regions, k_region)
    top_idx = top_idx.reshape(B, n_regions, k_region)
    rr = top_idx // cw
    cc = top_idx % cw
    region = torch.arange(n_regions, device=dev)[None, :, None]
    rows = (region // gc * rh + rr).reshape(B, -1)
    cols = (region % gc * cw + cc).reshape(B, -1)
    response = top_scores.reshape(B, -1)
    valid = response > 0.0
    # sub-pixel refinement: 1-D parabola fits on the raw FAST score surface
    rc = rows.clamp(1, H - 2)
    cc = cols.clamp(1, W - 2)
    flat = score_raw.reshape(B, H * W)
    lin = rc * W + cc

    def at(off):
        return torch.gather(flat, 1, lin + off)

    s0 = at(0)
    sl = at(-1)
    sr = at(1)
    su = at(-W)
    sd = at(W)

    def parabola(minus, center, plus):
        denom = minus - 2.0 * center + plus
        off = 0.5 * (minus - plus) / torch.where(denom.abs() < 1e-6, 1e-6, denom)
        return off.clamp(-0.5, 0.5)

    du = parabola(sl, s0, sr)
    dv = parabola(su, s0, sd)
    uv = torch.stack([cols.to(torch.float32) + du, rows.to(torch.float32) + dv],
                     dim=-1)
    pad = config.max_keypoints - uv.shape[1]
    if pad > 0:
        uv = F.pad(uv, (0, 0, 0, pad))
        response = F.pad(response, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, response, valid


def _keypoint_rows_cols(uv: torch.Tensor, H: int, W: int):
    y = uv[..., 1].to(torch.int32).clamp(BORDER, H - BORDER - 1).long()
    x = uv[..., 0].to(torch.int32).clamp(BORDER, W - BORDER - 1).long()
    return y, x


def extract_features_batch(images: torch.Tensor,
                           config: FeatureExtractorConfig) -> Features:
    """Batched frontend for [B, H, W] images -> Features with leading B.

    Descriptors are upright BRIEF-256 at the BORDER-clipped integer keypoint
    locations of the box-smoothed images (kernels/brief.py: the K1 kernel on
    a CUDA batch, its per-keypoint gather on a CPU batch); invalid keypoints
    get all -1.
    """
    if config.oriented:
        raise NotImplementedError("oriented BRIEF is not ported yet")
    from ..kernels.brief import brief_descriptors

    uv, response, valid = detect_keypoints_batch(images, config)
    smooth = _boxfilter(images, config.smoothing_window)
    y, x = _keypoint_rows_cols(uv, images.shape[1], images.shape[2])
    desc = brief_descriptors(smooth, y, x, valid)
    return Features(uv=uv, response=response, desc=desc, valid=valid)
