"""Loop-closure detection: a slotted Hamming descriptor database + SE3 validation.

Port of srrg2_proslam_tpu/models/loop_closure.py.  The database is a ring
of S slots, one finalized local map per slot ([S, budget, 256] signed
descriptors).  A query matches every stored map at once with one float32
Hamming product; per (query row, slot) the best and second-best match gate
a vote by distance, within-map Lowe ratio and map age; the top-K voted maps
become candidates, each validated by a point-to-point SE3 Gauss-Newton
alignment, all K in one batch.

Nothing here reads a value back to the host: ``detect_and_validate``
returns a [K, 22] packet that the orchestrator reads once per split.
Every function returns new tensors and leaves its inputs unchanged.

On a mesh (``mesh``: parallel/spmd.py) each rank holds a stripe of the
budget axis, [S, budget / n, ...] of ``desc``, ``points``, ``arena_row``
and ``valid``; ``map_id`` and ``next`` are replicated.  ``add_local_map``
writes the rank's stripe of the slot; a query's per-slot two-best keys
carry the global flat row, two MIN all-reduces merge them across the
stripes, and the votes follow from the merged distances (a sum of
per-stripe votes would not be the same vote); the matched rows and points
are gathered by owner.  The merged keys equal the single-device keys bit
for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..ops.features import _top_k
from ..ops.gn import gn_iterate_batch, point3_system
from ..ops.hamming import distance_matrix
from ..utils import config as cfg
from .landmarks import DESC_BITS, LandmarkArena

# per-map best-match key = distance * _ROW_SHIFT + flat db row, in int32:
# distance <= 256 (sentinel 300), rows < 2^22, keys < 300 * 2^22 + 2^22
_ROW_SHIFT = 1 << 22
_DIST_SENTINEL = 300
_KEY_SENTINEL = torch.iinfo(torch.int32).max


@cfg.register
@dataclass(frozen=True)
class LoopDetectorConfig:
    """Same fields and defaults as the JAX package's LoopDetectorConfig."""

    maximum_descriptor_distance: float = 25.0
    minimum_age_difference: int = 10
    minimum_matches: int = 25
    lowe_ratio: float = 0.8
    max_candidates: int = 4
    aligner_iterations: int = 30
    chi_threshold: float = 3.0
    damping: float = 1.0
    relocalize_min_inliers: int = 25
    relocalize_max_chi_inliers: float = 2.0
    relocalize_min_inliers_ratio: float = 0.5
    # closure backstop (PGO residual bound, candidate agreement); <= 0 off
    backstop_max_edge_residual: float = 0.5
    backstop_agreement_tolerance: float = 1.0
    # 0 = one pass over the whole ring; > 0 = max(1, query_tile // budget)
    # slots at a time (same results, bounded memory)
    query_tile: int = 0


class DescriptorDatabase(NamedTuple):
    """Slotted ring of local-map descriptor sets."""

    desc: torch.Tensor       # [S, budget, 256] int8 signed bits
    points: torch.Tensor     # [S, budget, 3] landmark pos in its map frame
    arena_row: torch.Tensor  # [S, budget] int32 row in the owning map's arena
    valid: torch.Tensor      # [S, budget] bool
    map_id: torch.Tensor     # [S] int32 owning local map (-1 = free slot)
    next: torch.Tensor       # [] int32 ring cursor (total inserts ever)

    @property
    def num_slots(self) -> int:
        return self.map_id.shape[0]

    @property
    def budget(self) -> int:
        return self.desc.shape[1]

    @property
    def capacity(self) -> int:
        return self.num_slots * self.budget


def empty_database(capacity: int, budget: int = None,
                   device=torch.device("cuda")) -> DescriptorDatabase:
    """Ring database holding ``capacity // budget`` local maps (budget
    defaults to capacity / 4 clamped to [1, 1024])."""
    if budget is None:
        budget = max(1, min(1024, capacity // 4))
    budget = max(1, min(budget, capacity))
    S = max(1, capacity // budget)
    return DescriptorDatabase(
        desc=torch.full((S, budget, DESC_BITS), -1, dtype=torch.int8, device=device),
        points=torch.zeros((S, budget, 3), dtype=torch.float32, device=device),
        arena_row=torch.zeros((S, budget), dtype=torch.int32, device=device),
        valid=torch.zeros((S, budget), dtype=torch.bool, device=device),
        map_id=torch.full((S,), -1, dtype=torch.int32, device=device),
        next=torch.zeros((), dtype=torch.int32, device=device),
    )


def database_from_numpy(d: dict, device=torch.device("cuda")) -> DescriptorDatabase:
    """A DescriptorDatabase from numpy arrays keyed by the JAX fields."""
    dtypes = {"desc": torch.int8, "points": torch.float32, "arena_row": torch.int32,
              "valid": torch.bool, "map_id": torch.int32, "next": torch.int32}
    return DescriptorDatabase(**{
        k: torch.tensor(np.asarray(d[k]), device=device).to(dt)
        for k, dt in dtypes.items()})


def _stripe(mesh):
    """(ranks, this rank) of the budget axis: (1, 0) off a mesh."""
    return (1, 0) if mesh is None else (mesh.size, mesh.rank)


def add_local_map(db: DescriptorDatabase, desc, points, valid, map_id,
                  rows=None, mesh=None) -> DescriptorDatabase:
    """Write one local map's landmarks into the next ring slot.

    The first ``budget`` valid rows win (callers pre-select by maturity);
    a full ring overwrites its oldest map.  ``rows`` [M] are the inputs'
    arena rows (default: arange).  The slot is chosen on the device.  On a
    mesh the inputs are replicated and the rank writes its stripe.
    """
    n, r = _stripe(mesh)
    S, stripe = db.num_slots, db.budget
    budget = stripe * n
    M = desc.shape[0]
    dev = desc.device
    if rows is None:
        rows = torch.arange(M, dtype=torch.int32, device=dev)
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    take = valid & (rank < budget)
    dest = torch.where(take, rank, budget)   # overflow sink row

    def compact(a, fill):
        out = torch.full((budget + 1,) + a.shape[1:], fill, dtype=a.dtype, device=dev)
        out[dest] = a      # only the sink row repeats
        return out[r * stripe:(r + 1) * stripe]

    slot = torch.remainder(db.next, S).long()

    def put(field, value):
        out = field.clone()
        out.index_copy_(0, slot.reshape(1), value.unsqueeze(0))
        return out

    return DescriptorDatabase(
        desc=put(db.desc, compact(desc, -1)),
        points=put(db.points, compact(points, 0)),
        arena_row=put(db.arena_row, compact(rows.to(torch.int32), 0)),
        valid=put(db.valid, compact(torch.ones((M,), dtype=torch.bool, device=dev), False)),
        map_id=put(db.map_id, torch.as_tensor(map_id, dtype=torch.int32, device=dev)),
        next=db.next + 1,
    )


class LoopQueryResult(NamedTuple):
    """Top-K candidate maps (by decreasing votes; -1 = inactive) and their
    per-candidate correspondences."""

    candidate_maps: torch.Tensor  # [K] int32
    votes: torch.Tensor           # [K] int32
    match_idx: torch.Tensor       # [K, Q] int32 flat db row per query row (-1)
    match_row: torch.Tensor       # [K, Q] int32 arena row in the ref map (-1)
    match_mask: torch.Tensor      # [K, Q] bool
    match_points: torch.Tensor    # [K, Q, 3] matched landmark in its map frame


def _slot_two_best(query_desc, query_valid, query_map_id, desc, valid, map_id,
                   slot_base: int, config: LoopDetectorConfig, mesh=None):
    """Per-(query, slot) encoded two-best over a [ts, budget] slot group.

    Returns (votes [ts] int32, best key [Q, ts] int32, vote_ok [Q, ts]).
    The Hamming distances are int32 (exact float32 products), so the key
    arithmetic is the JAX package's, bit for bit.  On a mesh ``desc`` and
    ``valid`` are the rank's stripe [ts, budget / n]: its keys carry the
    global flat row (the stripe starts at ``rank * budget / n``), and the
    merge takes the best of the stripes' bests and, as the second, the
    least of every stripe's second and the other stripes' bests.
    """
    n, r = _stripe(mesh)
    ts, stripe = desc.shape[0], desc.shape[1]
    budget = stripe * n
    Q = query_desc.shape[0]
    dev = query_desc.device
    cost = distance_matrix(query_desc, desc.reshape(ts * stripe, -1)).reshape(Q, ts, stripe)
    age_ok = ((query_map_id - map_id) >= config.minimum_age_difference) & (map_id >= 0)
    feasible = query_valid[:, None, None] & valid[None] & age_ok[None, :, None]
    flat_row = ((slot_base + torch.arange(ts, dtype=torch.int32, device=dev))[:, None]
                * budget + r * stripe
                + torch.arange(stripe, dtype=torch.int32, device=dev)[None, :])
    key = torch.where(feasible, cost, _DIST_SENTINEL) * _ROW_SHIFT + flat_row[None]
    best = key.min(dim=2).values                                        # [Q, ts]
    second = torch.where(key == best[:, :, None], _KEY_SENTINEL, key).min(dim=2).values
    if mesh is not None:
        merged = mesh.all_min(best, "ring")
        # keys are unique: the stripe holding the global best offers its
        # second, every other stripe its best
        second = mesh.all_min(torch.where(best == merged, second, best), "ring")
        best = merged
    d1 = (best // _ROW_SHIFT).to(torch.float32)
    d2 = torch.clamp_max(second // _ROW_SHIFT, _DIST_SENTINEL).to(torch.float32)
    vote_ok = (query_valid[:, None]
               & (d1 <= config.maximum_descriptor_distance)
               & (d1 <= config.lowe_ratio * d2))
    return vote_ok.sum(0).to(torch.int32), best, vote_ok


def query_terms(query_desc, query_valid, query_map_id, db: DescriptorDatabase,
                config: LoopDetectorConfig, mesh=None):
    """Per-(query, slot) best match + vote histogram over the whole ring:
    (votes [S], per_slot_key [Q, S], vote_ok [Q, S])."""
    return _slot_two_best(query_desc, query_valid, query_map_id, db.desc,
                          db.valid, db.map_id, 0, config, mesh)


def query_terms_tiled(query_desc, query_valid, query_map_id, db: DescriptorDatabase,
                      config: LoopDetectorConfig, tile_slots: int, mesh=None):
    """``query_terms`` over ``tile_slots`` slots at a time: slot groups are
    disjoint maps, so the per-tile results concatenate to the same values,
    with intermediates of [Q, tile_slots * budget] instead of [Q, S * budget]."""
    S = db.num_slots
    if S % tile_slots != 0:
        raise ValueError(f"tile of {tile_slots} slots must divide num_slots {S}")
    parts = [
        _slot_two_best(query_desc, query_valid, query_map_id,
                       db.desc[s:s + tile_slots], db.valid[s:s + tile_slots],
                       db.map_id[s:s + tile_slots], s, config, mesh)
        for s in range(0, S, tile_slots)]
    votes, best, vote_ok = zip(*parts)
    return torch.cat(votes), torch.cat(best, dim=1), torch.cat(vote_ok, dim=1)


def query(query_desc, query_valid, query_map_id, db: DescriptorDatabase,
          config: LoopDetectorConfig, num_maps: int = None, mesh=None) -> LoopQueryResult:
    """Match a local map against the whole database; top-K candidates.

    ``num_maps`` only bounds K for callers that know few maps exist.  On a
    mesh the result is replicated.
    """
    n, r = _stripe(mesh)
    S = db.num_slots
    if config.query_tile > 0:
        votes, per_slot_key, vote_ok = query_terms_tiled(
            query_desc, query_valid, query_map_id, db, config,
            max(1, config.query_tile // (db.budget * n)), mesh)
    else:
        votes, per_slot_key, vote_ok = query_terms(
            query_desc, query_valid, query_map_id, db, config, mesh)
    K = min(config.max_candidates, S)
    if num_maps is not None:
        K = min(K, num_maps)
    # stable descending sort: ties to the lowest slot, as jax.lax.top_k
    top_votes, top_slots = _top_k(votes[None], K)
    top_votes, top_slots = top_votes[0], top_slots[0]
    found = top_votes >= config.minimum_matches
    cands = torch.where(found, db.map_id[top_slots], -1).to(torch.int32)
    keys = per_slot_key[:, top_slots].T                                # [K, Q]
    idx = keys % _ROW_SHIFT
    mask = found[:, None] & vote_ok[:, top_slots].T
    if mesh is None:
        idx_c = idx.clamp(0, db.capacity - 1).long()
        rows = db.arena_row.reshape(-1)[idx_c]
        points = db.points.reshape(-1, 3)[idx_c]
    else:
        # the row's owner reads it from its stripe; a SUM gathers them
        stripe = db.budget
        col = idx % (stripe * n)
        owned = col // stripe == r
        local = ((idx // (stripe * n)) * stripe + col % stripe).clamp(0, db.capacity - 1).long()
        rows = mesh.gather_by_owner(db.arena_row.reshape(-1)[local], owned, "ring")
        points = mesh.gather_by_owner(db.points.reshape(-1, 3)[local], owned, "ring")
    return LoopQueryResult(
        candidate_maps=cands,
        votes=top_votes,
        match_idx=torch.where(mask, idx, -1).to(torch.int32),
        match_row=torch.where(mask, rows, -1).to(torch.int32),
        match_mask=mask,
        match_points=points,
    )


class ClosureResult(NamedTuple):
    """Per-candidate validation outputs (leading axis K)."""

    T_query_in_ref: torch.Tensor  # [K, 4, 4] query map frame -> ref frame
    num_inliers: torch.Tensor     # [K] int32
    chi_per_inlier: torch.Tensor  # [K]
    inlier_ratio: torch.Tensor    # [K] inliers / correspondences
    accepted: torch.Tensor        # [K] bool, all gates passed


def validate_batch(query_points, result: LoopQueryResult, T_init,
                   config: LoopDetectorConfig) -> ClosureResult:
    """Point-to-point SE3 validation of all K candidates at once.

    query_points [Q, 3] (query-map frame); T_init [K, 4, 4].  Each
    candidate runs up to ``aligner_iterations`` clamp-robustified GN steps
    and stops on its own (``gn_iterate_batch``), then faces the gates:
    inliers, chi per inlier and inlier ratio.
    """
    mask = result.match_mask
    weights = torch.ones(mask.shape, dtype=torch.float32, device=mask.device)
    system = lambda X: point3_system(X, query_points, result.match_points, weights,
                                     mask, chi_threshold=config.chi_threshold)
    X, stats = gn_iterate_batch(system, T_init, config.aligner_iterations,
                                damping=config.damping,
                                min_inliers=config.relocalize_min_inliers)
    n_corr = torch.clamp_min(mask.sum(-1), 1)
    chi_per_inlier = stats.chi_total / torch.clamp_min(stats.num_inliers, 1)
    ratio = stats.num_inliers / n_corr
    accepted = ((stats.num_inliers >= config.relocalize_min_inliers)
                & (chi_per_inlier <= config.relocalize_max_chi_inliers)
                & (ratio >= config.relocalize_min_inliers_ratio))
    return ClosureResult(X, stats.num_inliers, chi_per_inlier, ratio, accepted)


def validate(query_points, match_points, match_mask, T_init,
             config: LoopDetectorConfig) -> ClosureResult:
    """Validation of one candidate: match_points [Q, 3], match_mask [Q],
    T_init [4, 4]; returns a ClosureResult without the K axis."""
    one = LoopQueryResult(None, None, None, None, match_mask[None], match_points[None])
    out = validate_batch(query_points, one, T_init[None], config)
    return ClosureResult(*(t[0] for t in out))


def select_db_rows(arena_desc, arena_pos, arena_valid, arena_num_updates,
                   budget: int = 1024):
    """The per-map database budget: the most mature valid landmarks, ties by
    arena row (stable sort).  Returns (desc [B,256], points [B,3],
    rows [B] int32, valid [B], n [] int32)."""
    key = torch.where(arena_valid, -arena_num_updates, 1 << 30)
    order = torch.argsort(key, stable=True)[:budget]
    sel_valid = arena_valid[order]
    return (arena_desc[order], arena_pos[order], order.to(torch.int32), sel_valid,
            sel_valid.sum().to(torch.int32))


def compact_arena(arena: LandmarkArena, budget: int):
    """Budget-compacted arena (the rows the database holds) + its rows and
    count: (LandmarkArena [budget], rows [budget] int32, n [])."""
    desc_b, pts_b, rows_b, valid_b, n_b = select_db_rows(
        arena.desc, arena.pos, arena.valid, arena.num_updates, budget=budget)
    rows = rows_b.long()
    compact = LandmarkArena(pos=pts_b, cov=arena.cov[rows], desc=desc_b,
                            num_updates=arena.num_updates[rows], valid=valid_b)
    return compact, rows_b, n_b


# packet columns: candidate id, accepted, num_inliers, chi_per_inlier,
# inlier_ratio, votes, T_query_in_ref row-major (16)
PACKET_WIDTH = 22


def detect_and_validate(query_desc, query_valid, query_pos, query_map_id,
                        db: DescriptorDatabase, poses, config: LoopDetectorConfig,
                        num_maps: int, mesh=None):
    """Split-time loop detection: query + batched validation + one packet.

    query_pos [Q, 3] (query-map frame); poses [N, 4, 4] the graph's current
    estimates, which seed each candidate's alignment; ``query_map_id`` an
    int or a 0-dim integer tensor on the device (the chunk program's map
    counter: indexing with it reads nothing back).  Returns (result,
    closures, packet [K, 22] float32); on a mesh (a striped ``db``) all
    three are replicated.
    """
    result = query(query_desc, query_valid, query_map_id, db, config, num_maps, mesh)
    cand = result.candidate_maps.clamp_min(0).long()
    q = torch.as_tensor(query_map_id, device=poses.device).reshape(1).long()
    T_init = se3.inverse(poses[cand]) @ poses.index_select(0, q)
    closures = validate_batch(query_pos, result, T_init, config)
    active = result.candidate_maps >= 0
    packet = torch.cat([
        torch.stack([
            result.candidate_maps.to(torch.float32),
            (closures.accepted & active).to(torch.float32),
            closures.num_inliers.to(torch.float32),
            closures.chi_per_inlier,
            closures.inlier_ratio,
            result.votes.to(torch.float32),
        ], dim=1),
        closures.T_query_in_ref.reshape(-1, 16),
    ], dim=1)
    return result, closures, packet
