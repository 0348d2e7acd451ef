"""K1: BRIEF-256 descriptors at the keypoints (csrc/brief.cu), its plain
version, and the dense bitplane form it replaces.

Replaces srrg2_proslam_tpu/ops/brief_pallas.py::brief_bitplanes with its
consumer descriptors_from_planes, as the JAX frontend composes them:
entry [b, n, k] is +1 where ``smooth[y + p_k] < smooth[y + q_k]`` over the
256 frozen ``_BRIEF_PAIRS`` at keypoint (y[b, n], x[b, n]), else -1, and
all -1 where ``valid`` is false.  Samples outside the image read zeros, as
on the TPU kernel's zero-padded canvas.

The TPU kernel computes the bits at every pixel (30 MB of bitplanes per
KITTI pair) because scalar gathers are slow on a TPU; the frontend reads
0.25 % of them.  On the card the kernel gathers only at the keypoints, one
warp per keypoint.  ``brief_bitplanes_plain`` and ``descriptors_from_planes``
keep the dense form as plain code, so that the tests can hold the per-keypoint
descriptors to the JAX kernel's bitplanes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ..ops.features import _BRIEF_PAIRS, _PATCH_RADIUS

launches = 0
_WORDS = 8
_pairs_by_device: dict = {}  # device -> [256, 2, 2] int32 copy of _BRIEF_PAIRS


def _pairs(device: torch.device) -> torch.Tensor:
    pairs = _pairs_by_device.get(device)
    if pairs is None:
        pairs = torch.as_tensor(_BRIEF_PAIRS, device=device).contiguous()
        _pairs_by_device[device] = pairs
    return pairs


def brief_descriptors_plain(smooth: torch.Tensor, y: torch.Tensor,
                            x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-keypoint gather: smooth [B, H, W], y/x [B, N], valid [B, N] ->
    [B, N, 256] int8 in {-1, +1}, with zero samples outside the image."""
    B, H, W = smooth.shape
    pairs = _pairs(smooth.device).long()
    flat = smooth.reshape(B, H * W)

    def sample(off):                                      # off [256, 2] (dy, dx)
        yy = y[..., None] + off[:, 0]
        xx = x[..., None] + off[:, 1]                     # [B, N, 256]
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        lin = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        vals = torch.gather(flat, 1, lin.reshape(B, -1)).reshape(lin.shape)
        return torch.where(inside, vals, 0.0)

    signed = torch.where(sample(pairs[:, 0]) < sample(pairs[:, 1]), 1, -1)
    return torch.where(valid[..., None], signed, -1).to(torch.int8)


def brief_descriptors(smooth: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """BRIEF-256 of smoothed images [B, H, W] float32 at keypoints y/x
    [B, N] int64 -> [B, N, 256] int8 (all -1 where ``valid`` [B, N] is false)."""
    global launches
    if smooth.dim() != 3 or smooth.dtype != torch.float32:
        raise ValueError(f"brief: smooth must be [B, H, W] float32, got "
                         f"{tuple(smooth.shape)} {smooth.dtype}")
    B, H, W = smooth.shape
    for name, t, dtype in (("y", y, torch.int64), ("x", x, torch.int64),
                           ("valid", valid, torch.bool)):
        if t.dim() != 2 or t.shape[0] != B or t.shape != y.shape or t.dtype != dtype:
            raise ValueError(f"brief: {name} must be [{B}, N] {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not smooth.is_cuda:
        return brief_descriptors_plain(smooth, y, x, valid)
    for name, t in (("smooth", smooth), ("y", y), ("x", x), ("valid", valid)):
        if t.device != smooth.device or not t.is_contiguous():
            raise ValueError(f"brief: {name} must be contiguous on {smooth.device}")
    N = y.shape[1]
    out = torch.empty((B, N, 256), dtype=torch.int8, device=smooth.device)
    lib = _build.library()
    err = lib.brief_descriptors_launch(
        smooth.data_ptr(), _pairs(smooth.device).data_ptr(), y.data_ptr(),
        x.data_ptr(), valid.data_ptr(), out.data_ptr(), B, N, H, W,
        torch.cuda.current_stream(smooth.device).cuda_stream)
    _build.check(err, "brief_descriptors_launch")
    launches += 1
    return out


def brief_bitplanes_plain(smooth: torch.Tensor) -> torch.Tensor:
    """Dense form: [B, H, W] float32 -> [B, 8, H, W] int32 with zero padding.

    Bit k of pixel (y, x) is the comparison of pair k, packed LSB-first
    (pair k -> word k//32, bit k%32), as JAX ``brief_bitplanes`` packs it.
    """
    B, H, W = smooth.shape
    r = _PATCH_RADIUS
    padded = F.pad(smooth, (r, r, r, r))

    def at(dy, dx):
        return padded[:, r + dy:r + dy + H, r + dx:r + dx + W]

    words = []
    for w in range(_WORDS):
        acc = torch.zeros((B, H, W), dtype=torch.int32, device=smooth.device)
        for j in range(32):
            (pdy, pdx), (qdy, qdx) = _BRIEF_PAIRS[w * 32 + j].tolist()
            bit = (at(pdy, pdx) < at(qdy, qdx)).to(torch.int32)
            acc = acc | (bit << j)
        words.append(acc)
    return torch.stack(words, dim=1)


def descriptors_from_planes(planes: torch.Tensor, y: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """Gather the packed words at keypoints and unpack to signed int8.

    planes [B, 8, H, W], y/x [B, N] -> [B, N, 256] (and [8, H, W], [N] ->
    [N, 256]).
    """
    if planes.dim() == 3:
        return descriptors_from_planes(planes[None], y[None], x[None])[0]
    B = planes.shape[0]
    batch = torch.arange(B, device=planes.device)[:, None]
    words = planes.permute(0, 2, 3, 1)[batch, y.long(), x.long()]  # [B, N, 8]
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = (words[..., None] >> shifts) & 1                         # [B, N, 8, 32]
    bits = bits.reshape(B, words.shape[1], 256)
    return torch.where(bits > 0, 1, -1).to(torch.int8)
