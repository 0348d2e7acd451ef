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


def distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """int32 Hamming distances [N, M] from signed descriptors [N,256], [M,256].

    All-zero (invalid) rows yield 128; callers mask with their validity.
    """
    dot = torch.matmul(desc_a.to(torch.float32), desc_b.to(torch.float32).T)
    return (DESCRIPTOR_BITS - dot.to(torch.int32)) // 2
