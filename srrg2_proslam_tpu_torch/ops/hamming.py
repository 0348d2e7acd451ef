"""Hamming distances of signed ±1 descriptors as one float32 product.

Port of srrg2_proslam_tpu/ops/hamming.py: for s in {-1, +1}^256,
dot(a, b) = 256 - 2 * hamming(a, b).  The product runs in float32 on every
device: |dot| <= 256 is exact in float32 whatever the summation order, as
long as TF32 is off (the package turns it off at import).  An int8 ``@`` is
not used: on the CPU it returns int8 and wraps past 127.
"""
from __future__ import annotations

import torch

DESCRIPTOR_BITS = 256
DESCRIPTOR_WORDS = DESCRIPTOR_BITS // 32


def bits_to_signed(bits: torch.Tensor) -> torch.Tensor:
    """{0, 1} bits [..., 256] -> {-1, +1} int8."""
    return (bits.to(torch.int8) * 2 - 1).to(torch.int8)


def signed_to_bits(signed: torch.Tensor) -> torch.Tensor:
    return (signed > 0).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0, 1} bits [..., 256] -> packed uint32 words [..., 8], bit k of word
    w = bit 32 w + k."""
    b = bits.reshape(bits.shape[:-1] + (DESCRIPTOR_WORDS, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(-1).to(torch.uint32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Packed uint32 words [..., 8] -> {0, 1} uint8 bits [..., 256]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (DESCRIPTOR_BITS,)).to(torch.uint8)


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """int32 Hamming distances [..., N, M] from signed descriptors
    [..., N, 256], [..., M, 256].

    All-zero (invalid) rows yield 128; callers mask with their validity.
    """
    dot = torch.matmul(desc_a.to(torch.float32), desc_b.to(torch.float32).mT)
    return (DESCRIPTOR_BITS - dot.to(torch.int32)) // 2


def pairwise_distance(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-wise Hamming distances of two aligned sets [N, 256] -> [N] int32."""
    dot = (desc_a.to(torch.int32) * desc_b.to(torch.int32)).sum(-1, dtype=torch.int32)
    return (DESCRIPTOR_BITS - dot) // 2
