"""Fixed-capacity landmark arena (the local map's landmarks on the device).

Port of srrg2_proslam_tpu/models/landmarks.py (arena and insertion).
Insertion scatters into free slots, deletion clears the mask, and the
scene handed to matching and alignment is the whole arena with its
validity mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

DESC_BITS = 256


class LandmarkArena(NamedTuple):
    """All landmarks of one local map, in the local-map frame."""

    pos: torch.Tensor           # [M, 3] float32
    cov: torch.Tensor           # [M, 3, 3] float32
    desc: torch.Tensor          # [M, 256] int8 signed bits
    num_updates: torch.Tensor   # [M] int32 times merged
    valid: torch.Tensor         # [M] bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum()

    def to(self, device) -> "LandmarkArena":
        return LandmarkArena(*(t.to(device) for t in self))


def empty_arena(capacity: int, device=torch.device("cuda")) -> LandmarkArena:
    return LandmarkArena(
        pos=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        cov=torch.zeros((capacity, 3, 3), dtype=torch.float32, device=device),
        desc=torch.full((capacity, DESC_BITS), -1, dtype=torch.int8, device=device),
        num_updates=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _scatter_rows(base: torch.Tensor, dest: torch.Tensor, rows) -> torch.Tensor:
    """base with one extra sink row, rows written at dest, sink dropped.

    Untaken candidates all target the sink row M, the only duplicate target.
    """
    padded = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
    padded[dest] = rows
    return padded[:-1]


def insert(arena: LandmarkArena, pos, cov, desc, want: torch.Tensor,
           max_insertions: int) -> LandmarkArena:
    """Scatter up to ``max_insertions`` candidates into free slots.

    pos/cov/desc: [N, ...] candidates ranked by the caller; ``want`` [N]
    selects them, and the r-th taken candidate goes to the r-th free slot
    in index order.  Candidates beyond the free capacity are dropped.
    """
    M = arena.capacity
    dev = arena.pos.device
    free = ~arena.valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    free_order = torch.full((M + 1,), M, dtype=torch.int64, device=dev)
    free_order[torch.where(free, free_rank, M)] = torch.arange(M, device=dev)
    free_order = free_order[:M]
    num_free = M - arena.valid.sum()
    cand_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    take = want & (cand_rank < max_insertions) & (cand_rank < num_free)
    dest = free_order[cand_rank.clamp(0, M - 1)]
    dest = torch.where(take, dest, M)
    return LandmarkArena(
        pos=_scatter_rows(arena.pos, dest, pos),
        cov=_scatter_rows(arena.cov, dest, cov),
        desc=_scatter_rows(arena.desc, dest, desc),
        num_updates=_scatter_rows(arena.num_updates, dest, 1),
        valid=_scatter_rows(arena.valid, dest, True),
    )
