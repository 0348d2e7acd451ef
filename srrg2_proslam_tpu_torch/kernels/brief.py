"""K1: dense BRIEF-256 bitplanes (csrc/brief.cu) and its plain version.

Replaces srrg2_proslam_tpu/ops/brief_pallas.py::brief_bitplanes.  Bit k of
pixel (y, x) is ``smooth[y + p_k] < smooth[y + q_k]`` over the 256 frozen
``_BRIEF_PAIRS``, packed LSB-first into 8 int32 words (pair k -> word k//32,
bit k%32).  Samples outside the image read zeros, as on the TPU kernel's
zero-padded canvas.

On the card the kernel is bound by shared-memory loads (512 per pixel from
a tile with a 15-px halo) rather than device memory (4 bytes in, 32 out per
pixel).  Only the <= 1152 keypoints per image are ever read, so a sparse
per-keypoint kernel is the later speed option; the dense form is kept so
that it compares one to one with the JAX kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ..ops.features import _BRIEF_PAIRS, _PATCH_RADIUS

launches = 0
_WORDS = 8
_pairs_by_device: dict = {}  # device -> [256, 2, 2] int32 copy of _BRIEF_PAIRS


def brief_bitplanes_plain(smooth: torch.Tensor) -> torch.Tensor:
    """[B, H, W] float32 -> [B, 8, H, W] int32 with zero padding."""
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


def brief_bitplanes(smooth: torch.Tensor) -> torch.Tensor:
    """Smoothed images [B, H, W] float32 -> packed bitplanes [B, 8, H, W] int32."""
    global launches
    if smooth.dim() != 3 or smooth.dtype != torch.float32:
        raise ValueError(f"brief: need [B, H, W] float32, got "
                         f"{tuple(smooth.shape)} {smooth.dtype}")
    if not smooth.is_cuda:
        return brief_bitplanes_plain(smooth)
    if not smooth.is_contiguous():
        raise ValueError("brief: input must be contiguous")
    B, H, W = smooth.shape
    pairs = _pairs_by_device.get(smooth.device)
    if pairs is None:
        pairs = torch.as_tensor(_BRIEF_PAIRS, device=smooth.device).contiguous()
        _pairs_by_device[smooth.device] = pairs
    out = torch.empty((B, _WORDS, H, W), dtype=torch.int32, device=smooth.device)
    lib = _build.library()
    err = lib.brief_bitplanes_launch(
        smooth.data_ptr(), pairs.data_ptr(), out.data_ptr(), B, H, W,
        torch.cuda.current_stream(smooth.device).cuda_stream)
    _build.check(err, "brief_bitplanes_launch")
    launches += 1
    return out


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
