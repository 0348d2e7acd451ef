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
    if torch.is_tensor(rows):
        padded[dest] = rows
    else:   # a fill: assigning a Python scalar syncs on the card
        padded.index_fill_(0, dest, rows)
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


def merge_closure(ref_arena: LandmarkArena, query_arena: LandmarkArena,
                  T_query_in_ref: torch.Tensor, match_row: torch.Tensor,
                  match_mask: torch.Tensor, max_insertions: int) -> LandmarkArena:
    """Merge a query map's landmarks into a reloaded reference map's arena.

    Matched pairs combine by update-count-weighted mean and the ref
    descriptor refreshes to the query's; unmatched query landmarks insert
    into free slots, most mature first, at most ``max_insertions``.
    T_query_in_ref [4, 4] maps the query frame into the ref frame;
    match_row [Q] is the ref row per query row (-1), match_mask [Q] bool.

    Several query rows may match one ref row: their weighted sums add
    (``index_add``), and the descriptor of the LAST such query row wins —
    what the JAX package's ``.at[row].set`` gives on the CPU, made explicit
    here because a CUDA scatter of duplicates keeps an arbitrary one.
    """
    M = ref_arena.capacity
    dev = ref_arena.pos.device
    q = transform(query_arena, T_query_in_ref)
    w_q = torch.clamp_min(query_arena.num_updates, 1).to(torch.float32)
    ok = match_mask & query_arena.valid & (match_row >= 0)
    row = torch.where(ok, match_row.long(), M)   # unmatched rows: sink row M
    w_ok = torch.where(ok, w_q, 0.0)
    sum_pos = torch.zeros((M + 1, 3), dtype=torch.float32, device=dev).index_add(
        0, row, w_ok[:, None] * q.pos)[:M]
    sum_w = torch.zeros((M + 1,), dtype=torch.float32, device=dev).index_add(
        0, row, w_ok)[:M]
    w_ref = ref_arena.num_updates.to(torch.float32)
    touched = (sum_w > 0) & ref_arena.valid
    new_pos = torch.where(
        touched[:, None],
        (ref_arena.pos * w_ref[:, None] + sum_pos)
        / torch.clamp_min(w_ref + sum_w, 1.0)[:, None],
        ref_arena.pos)
    Q = query_arena.capacity
    last = torch.full((M + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, row, torch.arange(Q, device=dev), reduce="amax")[:M]
    new_desc = torch.where(touched[:, None], q.desc[last.clamp_min(0)], ref_arena.desc)
    merged = ref_arena._replace(
        pos=new_pos,
        desc=new_desc,
        num_updates=ref_arena.num_updates
        + torch.where(ref_arena.valid, sum_w.to(torch.int32), 0),
    )
    unmatched = query_arena.valid & ~ok
    order = torch.argsort(torch.where(unmatched, -query_arena.num_updates, 1 << 30),
                          stable=True)
    return insert(merged, q.pos[order], q.cov[order], q.desc[order],
                  unmatched[order], max_insertions)


def transform(arena: LandmarkArena, T: torch.Tensor) -> LandmarkArena:
    """Rigidly move all landmarks (and covariances) by T (4x4)."""
    R = T[:3, :3]
    new_pos = arena.pos @ R.T + T[:3, 3]
    new_cov = torch.einsum("ij,mjk,lk->mil", R, arena.cov, R)
    return arena._replace(pos=new_pos, cov=new_cov)
