"""FAST-9/16 + BRIEF-256 feature frontend over whole images.

Port of srrg2_proslam_tpu/ops/features.py.  Detection is dense: FAST score
for every pixel, an optional detection mask, 3x3 non-maximum suppression by
max pooling, per-grid-region top-k quotas with a validity mask, and a
parabola fit on the FAST score for sub-pixel keypoints.  Descriptors are
BRIEF-256 on a box-smoothed image: upright, or with ``oriented`` rotated
per keypoint by the intensity-centroid angle and read by bilinear samples
(ORB-256's steering).

On a CUDA batch the FAST score comes from the hand-written kernel K3
(kernels/fast.py) and upright descriptors from the per-keypoint kernel K1
(kernels/brief.py); on the CPU the same functions as the JAX package's
CPU path run (``fast_scores`` and the per-keypoint gather of
``compute_descriptors``), so the two packages agree bit for bit there.
Oriented descriptors never take K1 (its pairs are upright), as the JAX
package's oriented path never takes its BRIEF kernel: they are plain
torch on both devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import config as cfg

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


@cfg.register
@dataclass(frozen=True)
class FeatureExtractorConfig:
    """Same fields and defaults as the JAX package's config.

    ``use_pallas_fast`` forces the FAST kernel's wrapper on the CPU too;
    ``approx_top_k`` selects exact top-k in the port (what JAX computes on
    the CPU).  ``dense_brief`` is kept for parity and has no effect: an
    upright CUDA batch always takes the K1 kernel, a CPU batch its
    per-keypoint gather; ``oriented`` takes the plain rotated sampling.
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


def detect_keypoints_batch(images: torch.Tensor, config: FeatureExtractorConfig,
                           mask: torch.Tensor = None):
    """FAST detection with NMS and per-grid-region quotas on [B, H, W].

    Returns (uv [B,N,2], response [B,N], valid [B,N]) with
    N = config.max_keypoints.  A CUDA batch takes the FAST kernel.
    ``mask`` ([B, H, W] or [H, W] bool) restricts detection to its True
    pixels (the reference's seeded, selective detection).
    """
    B, H, W = images.shape
    if config.use_pallas_fast or images.is_cuda:
        from ..kernels.fast import fast_scores_kernel

        score_raw = fast_scores_kernel(images, config.detector_threshold)
    else:
        score_raw = fast_scores(images, config.detector_threshold)
    score = score_raw
    if mask is not None:
        score = torch.where(mask.expand(score.shape), score, 0.0)
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


def detect_keypoints(image: torch.Tensor, config: FeatureExtractorConfig,
                     mask: torch.Tensor = None):
    """Single-image ``detect_keypoints_batch``: [H, W] -> (uv [N, 2],
    response [N], valid [N])."""
    if mask is not None:
        mask = mask[None]
    uv, response, valid = detect_keypoints_batch(image[None], config, mask)
    return uv[0], response[0], valid[0]


def _keypoint_rows_cols(uv: torch.Tensor, H: int, W: int):
    y = uv[..., 1].to(torch.int32).clamp(BORDER, H - BORDER - 1).long()
    x = uv[..., 0].to(torch.int32).clamp(BORDER, W - BORDER - 1).long()
    return y, x


def _centroid_angles(image: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per pixel of [..., H, W]: atan2(m01,
    m10) of the radius-15 disc moments, as two dense 31x31 convolutions
    with zero padding."""
    r = _PATCH_RADIUS
    d = np.arange(-r, r + 1, dtype=np.float32)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    disc = (yy * yy + xx * xx <= r * r).astype(np.float32)
    kern = torch.from_numpy(np.stack([xx * disc, yy * disc])[:, None]).to(image.device)
    shape = image.shape
    m = F.conv2d(image.reshape((-1, 1) + shape[-2:]), kern, padding=r)
    return torch.atan2(m[:, 1], m[:, 0]).reshape(shape)


def _oriented_descriptors(smooth: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 of smoothed images [B, H, W] at keypoints y/x
    [B, N]: the pair pattern turned by each keypoint's centroid angle and
    read by bilinear samples -> [B, N, 256] int8 (all -1 where invalid)."""
    B, H, W = smooth.shape
    batch = torch.arange(B, device=smooth.device)[:, None]
    theta = _centroid_angles(smooth)[batch, y, x]                  # [B, N]
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    pairs = torch.from_numpy(_BRIEF_PAIRS).to(smooth.device, torch.float32)
    yf, xf = y.to(torch.float32)[..., None], x.to(torch.float32)[..., None]
    flat = smooth.reshape(B, H * W)

    def rotated_sample(off):                                       # [256, 2] (dy, dx)
        dy, dx = off[:, 0], off[:, 1]
        ry = (yf + dx * s + dy * c).clamp(0.0, H - 1.001)          # [B, N, 256]
        rx = (xf + dx * c - dy * s).clamp(0.0, W - 1.001)
        y0 = ry.to(torch.int32)
        x0 = rx.to(torch.int32)
        fy = ry - y0
        fx = rx - x0
        lin = (y0 * W + x0).long().reshape(B, -1)

        def at(off_lin):
            return torch.gather(flat, 1, lin + off_lin).reshape(ry.shape)

        return ((1 - fy) * ((1 - fx) * at(0) + fx * at(1))
                + fy * ((1 - fx) * at(W) + fx * at(W + 1)))

    signed = torch.where(rotated_sample(pairs[:, 0]) < rotated_sample(pairs[:, 1]), 1, -1)
    return torch.where(valid[..., None], signed, -1).to(torch.int8)


def _describe(smooth: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
              config: FeatureExtractorConfig) -> torch.Tensor:
    """Descriptors [B, N, 256] of smoothed images [B, H, W] at keypoints uv
    [B, N, 2]: K1 (its plain version on the CPU) upright, the plain rotated
    sampling with ``oriented``."""
    from ..kernels.brief import brief_descriptors

    y, x = _keypoint_rows_cols(uv, smooth.shape[1], smooth.shape[2])
    if config.oriented:
        return _oriented_descriptors(smooth, y, x, valid)
    return brief_descriptors(smooth, y, x, valid)


def compute_descriptors(image: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                        config: FeatureExtractorConfig) -> torch.Tensor:
    """BRIEF-256 of one image [H, W] at keypoints uv [N, 2] -> [N, 256] int8
    (upright or, with ``oriented``, rotation-aware); invalid rows all -1."""
    smooth = _boxfilter(image, config.smoothing_window)
    return _describe(smooth[None], uv[None], valid[None], config)[0]


def extract_features(image: torch.Tensor, config: FeatureExtractorConfig,
                     mask: torch.Tensor = None) -> Features:
    """Full frontend for one image [H, W] float32 (0..255)."""
    uv, response, valid = detect_keypoints(image, config, mask)
    desc = compute_descriptors(image, uv, valid, config)
    return Features(uv=uv, response=response, desc=desc, valid=valid)


def extract_features_batch(images: torch.Tensor,
                           config: FeatureExtractorConfig) -> Features:
    """Batched frontend for [B, H, W] images -> Features with leading B.

    Descriptors are BRIEF-256 at the BORDER-clipped integer keypoint
    locations of the box-smoothed images: upright through kernels/brief.py
    (the K1 kernel on a CUDA batch, its per-keypoint gather on a CPU
    batch), or rotated by the plain oriented sampling; invalid keypoints
    get all -1.  Each image's result does not depend on the batch.
    """
    uv, response, valid = detect_keypoints_batch(images, config)
    smooth = _boxfilter(images, config.smoothing_window)
    desc = _describe(smooth, uv, valid, config)
    return Features(uv=uv, response=response, desc=desc, valid=valid)


def stripe_mask(rows: int, cols: int, seed_v: torch.Tensor, seed_valid: torch.Tensor,
                thickness: float = 2.0) -> torch.Tensor:
    """[rows, cols] bool: True on every image row within ``thickness`` px of
    some valid seed keypoint's v (the reference's full-row stripe mode for
    seeded right-camera detection)."""
    v = torch.arange(rows, dtype=torch.float32, device=seed_v.device)[:, None]
    dist = (v - torch.where(seed_valid, seed_v, -1e9)[None, :]).abs()
    hit = dist.amin(dim=1, keepdim=True) <= thickness
    return hit.expand(rows, cols)
