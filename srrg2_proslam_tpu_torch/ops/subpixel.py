"""Sub-pixel refinement of stereo disparities by a parabola on patch SSDs.

Port of srrg2_proslam_tpu/ops/subpixel.py.  For each stereo match the mean
squared difference between the 7x7 left patch and the right patch at
u_R - 1, u_R and u_R + 1 is fitted with a parabola; its vertex corrects
u_R by at most half a pixel, and only where the centre cost is a local
minimum.  Patches are gathered as contiguous row runs of the flattened
images, one gather per image batch.

The mean over a patch's 49 squared differences is summed in sample order
and multiplied by 1/49, as ``jnp.mean`` computes it op by op on the CPU,
so that ``refine_disparity_batch`` is bit-exact with the JAX function
(``torch.mean`` sums in another order).  Under jit XLA fuses the
arithmetic in its own way: the JAX package's jitted adaptor moves u_R by
one ulp on at most a match or two per KITTI frame, which the tests bound
(2.5e-4 px).
"""
from __future__ import annotations

import torch

_PATCH = 3  # half-size of the SSD patch (7x7)


def _gather_rows(images: torch.Tensor, y: torch.Tensor, x0: torch.Tensor,
                 width: int) -> torch.Tensor:
    """[B, N, 7, width] runs of the flattened images [B, H, W]: rows y - 3 ..
    y + 3, columns x0 .. x0 + width - 1, for y/x0 [B, N]."""
    B, H, W = images.shape
    N = y.shape[1]
    dy = torch.arange(-_PATCH, _PATCH + 1, device=images.device)
    start = (y[:, :, None] + dy) * W + x0[:, :, None]
    lin = start[..., None] + torch.arange(width, device=images.device)   # [B, N, 7, w]
    out = torch.gather(images.reshape(B, H * W), 1, lin.reshape(B, -1))
    return out.reshape(B, N, 2 * _PATCH + 1, width)


def _patch_centres(uv: torch.Tensor, H: int, W: int):
    y = uv[..., 1].to(torch.int32).clamp(_PATCH + 1, H - _PATCH - 2).long()
    x = uv[..., 0].to(torch.int32).clamp(_PATCH + 1, W - _PATCH - 2).long()
    return y, x


def _gather_patches(images: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(2P+1)^2 patches at the integer centres of uv [B, N, 2] -> [B, N, 49]."""
    B, H, W = images.shape
    y, x = _patch_centres(uv, H, W)
    K = 2 * _PATCH + 1
    return _gather_rows(images, y, x - _PATCH, K).reshape(B, uv.shape[1], -1)


def refine_disparity_batch(images_left: torch.Tensor, images_right: torch.Tensor,
                           uv_left: torch.Tensor, uv_right: torch.Tensor) -> torch.Tensor:
    """Sub-pixel u_R [B, N] for matches uv_left/uv_right [B, N, 2] of image
    pairs [B, H, W]."""
    pl = _gather_patches(images_left, uv_left)
    # one 7x9 right gather; the three shifted 7x7 windows are slices of it
    B, H, W = images_right.shape
    y, x = _patch_centres(uv_right, H, W)
    wide = _gather_rows(images_right, y, x - _PATCH - 1, 9)
    n = uv_right.shape[1]
    K = 2 * _PATCH + 1
    sq = torch.stack([(pl - wide[..., s:s + K].reshape(B, n, -1)) ** 2
                      for s in (0, 1, 2)])                       # [3, B, N, 49]
    total = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        total = total + sq[..., k]
    c_m, c_0, c_p = total * (1.0 / sq.shape[-1])
    denom = c_m - 2.0 * c_0 + c_p
    offset = 0.5 * (c_m - c_p) / torch.where(denom.abs() < 1e-6, 1e-6, denom)
    # only trust the parabola where the centre is a local minimum
    offset = torch.where((c_0 <= c_m) & (c_0 <= c_p), offset.clamp(-0.5, 0.5), 0.0)
    return uv_right[..., 0] + offset


def refine_disparity(image_left: torch.Tensor, image_right: torch.Tensor,
                     uv_left: torch.Tensor, uv_right: torch.Tensor) -> torch.Tensor:
    """Sub-pixel u_R [N] for one pair's matches (``refine_disparity_batch``
    on a batch of one)."""
    return refine_disparity_batch(image_left[None], image_right[None], uv_left[None],
                                  uv_right[None])[0]
