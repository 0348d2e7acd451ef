"""Chunked SLAM stepping: B frames per device program, one packet read per chunk.

Port of srrg2_proslam_tpu/models/chunk.py.  The JAX package fuses a chunk's
batched adaptor, its B tracker steps with the status machine, and the
split pipeline of every frame that finished a local map into one jitted
program whose one flat packet the host reads.  On the card the port runs:

* the batched adaptor (models/frontend.py) eagerly, once per chunk: one
  FAST (K3) and one BRIEF (K1) launch for the chunk's frames, written
  into the chunk graph's static inputs;
* the chunk's B tracker steps and the per-frame status machine
  (``frame_body``: Initializing while the map has no frame, Lost below
  ``min_track_inliers``, a split past the viewpoint thresholds; on a
  finish a fresh tracker state that keeps the velocity on a split and
  zeroes it on a loss) as one CUDA graph, replayed once per chunk
  (utils/graphs.py).  Its outputs are the [B, PACKET_SIZE] packet rows
  and the pre-reset arena and pose of every frame.  The
  host copies the packet to pinned memory behind a CUDA event and reads
  it once, ``chunk_lag`` chunks later;
* the split branch (``split_branch``: the makeNewMap pose and odometry
  factor, the budget selection, the ring insert with its eviction report,
  the loop query and the K-candidate validation, the split-meta row) as a
  second CUDA graph, replayed once per finished frame with the map
  counters as device scalars.  Its split-meta row is read back (one read
  per split) because the closure decision that follows (candidate
  agreement, the geometric backstop, PGO) runs only on an accepted
  closure: the orchestrator runs it eagerly then, as the per-frame path
  does, instead of capturing a dense PGO that almost never runs.  A chunk
  costs 1 + (its splits) packet reads, where the JAX program costs 1.

A window shorter than B (the padded last chunk, the rewind from ``lo``
after a relocalisation) runs the same frame body eagerly, frame by frame,
as the JAX program's ``lax.cond`` skips inactive frames;
on the CPU everything runs eagerly: the eager body is the graph's plain
version.  A capture or replay that fails raises.

Relocalisation stays host-arbitrated as in the JAX package: the decision
rides the split-meta rows, and the orchestrator (models/slam.py) either
undoes later finishes of the chunk (``undo_graph_entries``,
``db_write_slot``) or replays its split branches up to the finish, then
runs ``reloc_op``.

On a mesh (``mesh``: parallel/spmd.py; GraphSLAM(mesh=...)) the tracker
half stays replicated, so each rank captures and replays its own chunk
graph; the split branch, whose ring insert and loop query hold
collectives, runs eagerly (a collective cannot be captured in a graph on
gloo).  The ring is striped along its budget axis and the graph's edges
sharded: a write to an edge slot or a ring slot touches only the owner's
rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import pgo, se3
from ..ops.pinhole import Camera
from ..utils import graphs
from . import landmarks as lm
from . import loop_closure
from .tracker import TrackerConfig, TrackerState, initial_state, track_step

# ---------------------------------------------------------------------------
# per-frame packet layout ([PACKET_SIZE] float32, one row per frame)
# ---------------------------------------------------------------------------
PKT_INLIERS = 0
PKT_TRANS = 1
PKT_ROT = 2
PKT_MATCHES = 3
PKT_MERGES = 4
PKT_ADDITIONS = 5
PKT_CHI = 6
PKT_STAGE = 7
PKT_FINISH = 8        # 0 = none, 1 = split, 2 = lost
PKT_ACTIVE = 9        # 0 = frame outside the [lo, hi) active window
PKT_T = 10            # 10..21: pre-reset T_lm_robot[:3, :] row-major
PKT_VEL = 22          # 22..27: post-frame velocity twist
PACKET_SIZE = 28

FINISH_NONE = 0.0
FINISH_SPLIT = 1.0
FINISH_LOST = 2.0

# ---------------------------------------------------------------------------
# per-split meta layout ([SM_CP + 22K] float32)
# ---------------------------------------------------------------------------
SM_DID = 0        # 1.0 when this frame finished a local map
SM_PREV = 1       # id of the finished map
SM_NEW = 2        # id of the map opened after it
SM_ODO = 3        # edge slot of the odometry factor prev -> new
SM_EDGES = 4      # edge count AFTER this split (odometry + closure factors)
SM_DBN = 5        # budget-selected descriptor rows of the finished map
SM_INS = 6        # 1.0 when those rows were inserted into the database
SM_EVICTED = 7    # map id the ring insertion overwrote (-1: none)
SM_DBNEXT = 8     # ring cursor after this split
SM_CP = 9         # then K rows of 22 (loop_closure.detect_and_validate)


def split_meta_size(max_candidates: int) -> int:
    return SM_CP + 22 * max_candidates


class ChunkCarry(NamedTuple):
    """SLAM state threaded through the chunk program, on the device.

    ``state`` and ``frames_in_map`` advance when a chunk is dispatched; the
    map half (graph, edge count, database, map counters) when its splits
    run, as the chunk is consumed."""

    state: TrackerState
    frames_in_map: torch.Tensor   # [] int32
    graph: pgo.PoseGraph
    edge_count: torch.Tensor      # [] int32
    db: loop_closure.DescriptorDatabase
    current_map: torch.Tensor     # [] int32
    num_maps: torch.Tensor        # [] int32


class ChunkYs(NamedTuple):
    """A chunk's tracker outputs; ``packet`` is what the host reads."""

    packet: torch.Tensor          # [B, PACKET_SIZE] float32
    arenas: lm.LandmarkArena      # [B, ...] post-update (pre-reset) arenas
    T_lm_robot: torch.Tensor      # [B, 4, 4] post-frame (pre-reset) poses


class SplitYs(NamedTuple):
    """One finished frame's split outputs (the JAX ChunkYs' split rows)."""

    meta: torch.Tensor            # [split_meta_size(K)] float32
    desc: torch.Tensor            # [budget, 256] int8 database rows of the map
    pos: torch.Tensor             # [budget, 3]
    rows: torch.Tensor            # [budget] int32 arena rows
    loop_row: torch.Tensor        # [K, Q] int32 closure correspondences
    loop_mask: torch.Tensor       # [K, Q] bool
    loop_T: torch.Tensor          # [K, 4, 4] validated closure transforms


def take_frame(tree, i: int):
    """Row ``i`` of every tensor of a nest, as copies that do not keep the
    whole chunk output alive."""
    return graphs.tree_map(lambda x: x[i].clone(), tree)


def _select(pred, a, b):
    """``a`` where the 0-dim bool ``pred`` holds, else ``b``, leaf by leaf."""
    leaves_a, spec = graphs.flatten(a)
    leaves_b, _ = graphs.flatten(b)
    return graphs.unflatten(spec, [torch.where(pred, x, y) for x, y in zip(leaves_a, leaves_b)])


def _fresh_state(state: TrackerState, estimator: str, device) -> TrackerState:
    slots = 8 if state.meas_buf is None else state.meas_buf.point_in_image.shape[1]
    return initial_state(state.arena.capacity, estimator, slots, device=device)


def frame_body(state: TrackerState, frames_in_map, pts, desc, valid, cam: Camera,
               tcfg: TrackerConfig, model: str, min_track_inliers: int,
               max_translation: float, max_rotation: float):
    """One frame of the chunk: the tracker step and the status machine.

    Returns (next_state, next_frames_in_map, packet [PACKET_SIZE], the
    post-update arena and pose: the finished map's on a finish).  Every
    decision is a device select: nothing is read back.
    """
    dev = pts.device
    new_state, stats, _ = track_step(state, pts, desc, valid, cam, tcfg, model)
    initializing = frames_in_map == 0
    lost = ~initializing & (stats.num_inliers < min_track_inliers)
    split = (~initializing & ~lost & ((stats.trans_in_map > max_translation)
                                      | (stats.rot_in_map > max_rotation)))
    finish = lost | split
    # a finish starts a fresh map: empty arena, identity pose; a split
    # keeps the velocity, a loss zeroes it
    vel = torch.where(lost, torch.zeros_like(new_state.velocity), new_state.velocity)
    reset = _fresh_state(state, tcfg.landmark_estimator, dev)._replace(velocity=vel)
    next_state = _select(finish, reset, new_state)
    next_fim = torch.where(finish, 0, frames_in_map + 1)
    # 1 on a split, 2 on a loss, 0 otherwise
    finish_code = finish.to(torch.float32) * (1.0 + lost.to(torch.float32))
    packet = torch.cat([stats.host_packet[:8],
                        torch.stack([finish_code, torch.ones_like(finish_code)]),
                        stats.host_packet[8:20], new_state.velocity])
    return next_state, next_fim, packet, new_state.arena, new_state.T_lm_robot


def chunk_frames(state: TrackerState, frames_in_map, pts, desc, valid, lo: int, hi: int,
                 cam: Camera, tcfg: TrackerConfig, model: str, min_track_inliers: int,
                 max_translation: float, max_rotation: float):
    """The chunk's frames through ``frame_body``, eagerly; frames outside
    [lo, hi) are skipped: their packet row is zero (PKT_ACTIVE 0), their
    arena the carried one.  Returns (state, frames_in_map, ChunkYs)."""
    rows = []
    for b in range(pts.shape[0]):
        if lo <= b < hi:
            state, frames_in_map, packet, arena, T = frame_body(
                state, frames_in_map, pts[b], desc[b], valid[b], cam, tcfg, model,
                min_track_inliers, max_translation, max_rotation)
        else:
            packet = torch.zeros((PACKET_SIZE,), dtype=torch.float32, device=pts.device)
            arena, T = state.arena, state.T_lm_robot
        rows.append((packet, arena, T))
    packets, arenas, Ts = zip(*rows)
    ys = ChunkYs(packet=torch.stack(packets),
                 arenas=lm.LandmarkArena(*(torch.stack(f) for f in zip(*arenas))),
                 T_lm_robot=torch.stack(Ts))
    return state, frames_in_map, ys


def run_chunk(state: TrackerState, frames_in_map, pts, desc, valid, lo: int, hi: int,
              cam: Camera, tcfg: TrackerConfig, model: str, min_track_inliers: int,
              max_translation: float, max_rotation: float):
    """One chunk of B = pts.shape[0] frames, active in [lo, hi): a full
    window of CUDA tensors replays the chunk's CUDA graph (captured on
    first use per model, B, configuration and capacities), anything else
    runs ``chunk_frames`` eagerly.  Returns (state, frames_in_map, ChunkYs)."""
    B = pts.shape[0]
    args = (cam, tcfg, model, min_track_inliers, max_translation, max_rotation)
    if not (pts.is_cuda and lo == 0 and hi == B):
        return chunk_frames(state, frames_in_map, pts, desc, valid, lo, hi, *args)

    def full(st, fim, p, d, v):
        return chunk_frames(st, fim, p, d, v, 0, B, *args)

    inputs = (state, frames_in_map, pts, desc, valid)
    key = ("chunk", pts.device, tuple(pts.shape), tuple(desc.shape), state.arena.capacity,
           state.meas_buf is not None) + args
    return graphs.captured(key, full, inputs)(*inputs)


# ---------------------------------------------------------------------------
# the split branch: the reference's split block for one finished frame
# ---------------------------------------------------------------------------

def _row(t: torch.Tensor, index) -> torch.Tensor:
    """Row ``index`` (a 0-dim integer tensor) of ``t``, read on the device."""
    return t.index_select(0, index.reshape(1).long())[0]


def _put(t: torch.Tensor, index, value, mesh=None) -> torch.Tensor:
    """A copy of ``t`` with row ``index`` (0-dim integer tensor) set to
    ``value`` (a tensor of the row's shape, or a Python scalar).  On a mesh
    ``t`` is the rank's block of a row-sharded tensor and ``index`` global:
    the owner writes it, the other ranks keep their rows."""
    if not torch.is_tensor(value):
        value = torch.full(t.shape[1:], value, dtype=t.dtype, device=t.device)
    value = value.to(t.dtype).reshape((1,) + t.shape[1:])
    index = index.reshape(1).long()
    if mesh is not None:
        local = index - mesh.rank * t.shape[0]
        owned = (local >= 0) & (local < t.shape[0])
        index = local.clamp(0, t.shape[0] - 1)
        value = torch.where(owned.reshape((1,) * t.dim()), value, t.index_select(0, index))
    out = t.clone()
    out.index_copy_(0, index, value)
    return out


def split_branch(graph: pgo.PoseGraph, edge_count, db: loop_closure.DescriptorDatabase,
                 current_map, num_maps, T_fin, arena: lm.LandmarkArena, budget: int,
                 loop_cfg: loop_closure.LoopDetectorConfig, enable_loop: bool,
                 do_loop: bool, mesh=None):
    """What the reference does when a local map finishes
    (app_benchmark.cpp:136-161), for one finished frame, on the device:
    the new map's pose (the finished map's pose times ``T_fin``, the robot
    in the finished map) and the odometry factor, the budget selection, the
    ring insert (skipped when the map is already stored; the evicted map is
    reported), and with ``do_loop`` the loop query and the validation of
    its K candidates.  Map ids and counts are 0-dim int32 device tensors.

    Returns (graph, edge_count, db, current_map, num_maps, SplitYs); the
    closure decision on the meta row's candidates is the caller's.  On a
    mesh the odometry factor lands on its edge slot's owner, the ring
    insert writes the rank's stripe and the query merges across the
    stripes; the outputs are replicated.
    """
    dev = T_fin.device
    K = loop_cfg.max_candidates
    Q = arena.capacity
    prev, new = current_map, num_maps
    # makeNewMap: pose chain + odometry factor (models/slam.py::_make_new_map)
    pose_prev = _row(graph.poses, prev)
    T_world_new = pose_prev @ T_fin
    Z = se3.inverse(pose_prev) @ T_world_new
    odo = edge_count
    graph = graph._replace(
        poses=_put(graph.poses, new, T_world_new),
        pose_valid=_put(graph.pose_valid, new, True),
        edge_i=_put(graph.edge_i, odo, prev, mesh),
        edge_j=_put(graph.edge_j, odo, new, mesh),
        edge_Z=_put(graph.edge_Z, odo, Z, mesh),
        edge_weight=_put(graph.edge_weight, odo, 1.0, mesh),
        edge_valid=_put(graph.edge_valid, odo, True, mesh))
    edge_count = edge_count + 1

    # budget selection: the same rows feed the insert and the host mirror
    desc_b, pts_b, rows_b, valid_b, n_b = loop_closure.select_db_rows(
        arena.desc, arena.pos, arena.valid, arena.num_updates, budget=budget)
    if enable_loop:
        do_ins = ~(db.map_id == prev).any()
        slot = torch.remainder(db.next, db.num_slots)
        evicted = torch.where(do_ins, _row(db.map_id, slot), -1)
        inserted = loop_closure.add_local_map(db, desc_b, pts_b, valid_b, prev, rows_b, mesh)
        db = _select(do_ins, inserted, db)
    else:
        do_ins = torch.zeros((), dtype=torch.bool, device=dev)
        evicted = torch.full((), -1, dtype=torch.int32, device=dev)

    # rows of absent candidates: id -1, nothing accepted
    cp = torch.cat([torch.full((K, 1), -1.0, device=dev),
                    torch.zeros((K, loop_closure.PACKET_WIDTH - 1), device=dev)], 1)
    loop_row = torch.full((K, Q), -1, dtype=torch.int32, device=dev)
    loop_mask = torch.zeros((K, Q), dtype=torch.bool, device=dev)
    loop_T = torch.eye(4, dtype=torch.float32, device=dev).repeat(K, 1, 1)
    if do_loop:
        result, closures, packet = loop_closure.detect_and_validate(
            arena.desc, arena.valid, arena.pos, prev, db, graph.poses, loop_cfg,
            graph.capacity, mesh)
        k = packet.shape[0]       # min(K, slots, pose capacity)
        cp = torch.cat([packet, cp[k:]])
        loop_row = torch.cat([result.match_row, loop_row[k:]])
        loop_mask = torch.cat([result.match_mask, loop_mask[k:]])
        loop_T = torch.cat([closures.T_query_in_ref, loop_T[k:]])
    head = torch.stack([
        torch.ones((), dtype=torch.float32, device=dev), prev.to(torch.float32),
        new.to(torch.float32), odo.to(torch.float32), edge_count.to(torch.float32),
        n_b.to(torch.float32), do_ins.to(torch.float32), evicted.to(torch.float32),
        db.next.to(torch.float32)])
    meta = torch.cat([head, cp.reshape(-1)])
    return (graph, edge_count, db, new, num_maps + 1,
            SplitYs(meta, desc_b, pts_b, rows_b, loop_row, loop_mask, loop_T))


def run_split(graph, edge_count, db, current_map, num_maps, T_fin, arena, budget: int,
              loop_cfg: loop_closure.LoopDetectorConfig, enable_loop: bool, do_loop: bool,
              mesh=None):
    """``split_branch`` as a CUDA graph on CUDA tensors (one per capacities
    and ``do_loop``), eagerly on CPU tensors and on a mesh (its
    collectives cannot be captured)."""
    args = (budget, loop_cfg, enable_loop, do_loop)
    inputs = (graph, edge_count, db, current_map, num_maps, T_fin, arena)
    if mesh is not None or not T_fin.is_cuda:
        return split_branch(*inputs, *args, mesh)

    def fn(*xs):
        return split_branch(*xs, *args)

    key = ("split", T_fin.device, graph.capacity, graph.edge_capacity, db.num_slots,
           db.budget, arena.capacity) + args
    return graphs.captured(key, fn, inputs)(*inputs)


# ---------------------------------------------------------------------------
# relocalisation: undo later finishes, reload an old map
# ---------------------------------------------------------------------------

def _owned_rows(dead, rows: int, mesh) -> list:
    """The rank's local indices of the global rows ``dead`` of a tensor
    sharded in blocks of ``rows`` (all of them off a mesh)."""
    if mesh is None:
        return list(dead)
    return [d - mesh.rank * rows for d in dead if d // rows == mesh.rank]


def undo_graph_entries(graph: pgo.PoseGraph, dead_poses, dead_edges,
                       mesh=None) -> pgo.PoseGraph:
    """Invalidate the poses and odometry edges (index lists) later
    finishes added.

    Sound only when no later finish kept an accepted closure (its PGO
    rewrote every pose); the orchestrator replays the chunk there.  The
    values of the invalidated slots stay stale, as ``reloc_op``'s
    retirement leaves them: every insertion writes value and validity.
    On a mesh the edge slots are global and each owner clears its own.
    """
    dead_edges = _owned_rows(dead_edges, graph.edge_capacity, mesh)

    def cleared(valid, dead):
        return valid.index_fill(0, torch.as_tensor(dead, dtype=torch.long,
                                                   device=valid.device), False)

    return graph._replace(pose_valid=cleared(graph.pose_valid, dead_poses),
                          edge_valid=cleared(graph.edge_valid, dead_edges))


def db_write_slot(db: loop_closure.DescriptorDatabase, slot: int, desc, points, rows,
                  valid, map_id: int, next_val: int, mesh=None) -> loop_closure.DescriptorDatabase:
    """Overwrite one ring slot and the cursor (the rollback of a later
    insert): the evicted map's rows from the host mirror, padded as
    ``add_local_map`` pads, or a free slot (map id -1, all rows invalid).
    The rows span the whole budget; on a mesh the rank writes its stripe."""
    dev = db.desc.device
    idx = torch.full((1,), slot, dtype=torch.long, device=dev)
    stripe = db.budget
    lo = 0 if mesh is None else mesh.rank * stripe

    def put(field, value):
        value = torch.as_tensor(value, device=dev).to(field.dtype)
        if field.dim() > 1:
            value = value[lo:lo + stripe]
        return field.index_copy(0, idx, value.unsqueeze(0))

    return db._replace(
        desc=put(db.desc, desc), points=put(db.points, points),
        arena_row=put(db.arena_row, rows), valid=put(db.valid, valid),
        map_id=put(db.map_id, torch.full((), map_id, dtype=torch.int32, device=dev)),
        next=torch.full((), next_val, dtype=torch.int32, device=dev))


def reloc_op(graph: pgo.PoseGraph, ref_arena: lm.LandmarkArena,
             query_arena: lm.LandmarkArena, T_candidates, match_row, match_mask, k: int,
             T_lm_robot, velocity, meas_buf, dead_map: int, dead_edge_slot: int,
             max_insertions: int, mesh=None):
    """Rebuild tracking inside a reloaded map (MultiRelocalizer3D analog):
    merge the finished query map into the reference arena through the
    closure correspondences of candidate ``k`` (landmarks.merge_closure),
    retire the map opened at the split (its pose and odometry factor), and
    the tracker state at ``T_lm_robot`` with ``velocity``.  The smoother's
    buffers belong to the abandoned query map: the reloaded map starts
    with zeroed ones (T_world_to_cam slots 0, not identity, as in the JAX
    package).  On a mesh the dead edge slot's owner retires it.  Returns
    (graph, state)."""
    merged = lm.merge_closure(ref_arena, query_arena, T_candidates[k], match_row[k],
                              match_mask[k], max_insertions)
    pose_valid, edge_valid = graph.pose_valid.clone(), graph.edge_valid.clone()
    pose_valid[dead_map] = False
    for e in _owned_rows([dead_edge_slot], graph.edge_capacity, mesh):
        edge_valid[e] = False
    if meas_buf is not None:
        meas_buf = type(meas_buf)(*(torch.zeros_like(t) for t in meas_buf))
    state = TrackerState(arena=merged, T_lm_robot=T_lm_robot, velocity=velocity,
                         meas_buf=meas_buf)
    return graph._replace(pose_valid=pose_valid, edge_valid=edge_valid), state
