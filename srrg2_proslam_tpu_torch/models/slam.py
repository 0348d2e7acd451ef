"""Graph SLAM orchestrator: local maps, loop closing, PGO, relocalisation.

Port of srrg2_proslam_tpu/models/slam.py for the stereo and RGB-D models
with every landmark estimator of the tracker.
``process`` runs one tracker step (models/tracker.py) and reads back the
frame's small status packet (the one host read per frame) to drive the
status machine (Initializing / Tracking / Lost) and the viewpoint
splitting criterion.  At a split the finished local map enters the closure
database (models/loop_closure.py), the database is queried, the top-K
candidates are validated in one batch, and their [K, 22] decision packet
is read back (the one host read per split); accepted closures become
pose-graph factors, PGO runs (ops/pgo.py) under the geometric backstop,
and a closure that passes the relocaliser's gates moves tracking back into
the old map.  The trajectory is unrolled through the optimized local-map
poses.  With ``local_ba.enabled`` every ``keyframe_stride``-th tracked
frame's association is kept (the last ``max_keyframes``), and a split
first refines the finished map's landmarks by bundle adjustment over them
(ops/ba.py) before the map enters the database.

Speculation (``speculation_depth`` > 0): ``process_dispatch`` launches a
frame's tracker step and starts a non-blocking copy of its status packet
into pinned host memory, marked by a CUDA event; ``process_finalize``
consumes queued frames down to the depth.  A split or loss found in a
consumed frame rolls the tracker back to that frame, runs its handler and
re-dispatches the frames behind it; a split's closure decision waits in
the queue as a marker, consumed before any later frame, and a
relocalisation retires the map opened at the split and replays the
frames queued behind it.  ``flush`` consumes everything.  The end state
equals the synchronous run's (``speculation_depth = 0``).

Sequences (``process_sequence``, ``process_meas_sequence``, with
``chunk_size`` > 0) run the chunk program (models/chunk.py), the JAX
package's chunked mode: the stacks are uploaded once; ``chunk_size``
frames at a time go through the batched adaptor (one FAST and one BRIEF
launch per chunk on the card) and then through the chunk's tracker steps
and on-device status machine, one CUDA graph replay per chunk;
``chunk_group`` chunks are dispatched together and share one packet read;
``chunk_lag`` dispatches stay in flight before the oldest is consumed.
Consuming a dispatch reads its packet, runs the split branch of each
finished frame (a graph replay and a read of its split-meta row, then the
closure decision where a candidate was accepted), and mirrors status,
maps, database, events and counters on the host.  A relocalisation drops
the dispatches in flight and rewinds the sequence to the frame after the
finish; later finishes of its chunk are undone on the device
(``num_reloc_rollbacks``), or, where one of them kept a closure, the
chunk's split branches are replayed up to the finish
(``num_reloc_replays``), as the JAX package replays its chunk.
``speculation_depth`` has no effect there.

On a device mesh (``mesh``: parallel/spmd.py, one process per rank) every
rank runs the same program on a replicated tracker state (the adaptor,
K3, K1 and K2, and the chunk graph, on its full copy) while the closure
ring is striped along its budget axis and the pose graph's factors are
sharded along edges, as the JAX package's ``_apply_mesh`` lays them out;
the ring insert, the loop query, PGO and its backstop statistics hold the
collectives.  Every host read that drives a decision reads a replicated
tensor, so the ranks take the same control flow.  The chunk program's
split branches run eagerly there, and a relocalisation whose dispatch
holds later finishes replays them, as the JAX package does under a mesh.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import pgo, se3
from ..parallel import spmd
from ..ops.pinhole import Camera
from ..utils import config as cfg
from ..utils import graphs
from ..utils.profiling import profile_time
from . import landmarks as lm
from . import loop_closure
from . import chunk as chunk_ops
from .frontend import adapt_rgbd_batch, adapt_stereo_batch
from .tracker import (TrackerConfig, TrackerState, _check_supported, _robot_sensor,
                      initial_state, track_step)


@cfg.register
@dataclass(frozen=True)
class SplittingConfig:
    """LocalMapSplittingCriterionViewpoint3D (kitti.conf:542-550)."""

    maximum_translation_m: float = 10.0
    maximum_rotation_rad: float = 0.25


@cfg.register
@dataclass(frozen=True)
class RelocalizerConfig:
    """MultiRelocalizer3D gates (kitti.conf:91-110)."""

    max_translation: float = 10.0
    relocalize_max_chi_inliers: float = 5.0
    relocalize_min_inliers: int = 25
    relocalize_min_inliers_ratio: float = 0.5


BAConfig = ba_ops.BAConfig     # the type of LocalBAConfig.ba, as in the JAX package


@cfg.register
@dataclass(frozen=True)
class LocalBAConfig:
    """Split-time refinement of the finished local map (ops/ba.py) over its
    last ``max_keyframes`` keyframes, one every ``keyframe_stride`` frames;
    ``max_refine_maturity`` > 0 refines only landmarks updated at most that
    often."""

    enabled: bool = False
    max_keyframes: int = 8
    keyframe_stride: int = 2
    ba: BAConfig = field(default_factory=BAConfig)
    max_refine_maturity: int = 0


@cfg.register
@dataclass(frozen=True)
class GraphSLAMConfig:
    """Same fields and defaults as the JAX package's GraphSLAMConfig.

    ``speculation_depth``: frames dispatched ahead of the host's status
    machine in per-frame mode (0: synchronous).  ``chunk_size``: frames
    per chunk of the sequence API's chunk program (0: no sequence API),
    ``chunk_group`` chunks per dispatch and packet read, ``chunk_lag``
    dispatches in flight before the oldest is consumed.
    """

    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    splitting: SplittingConfig = field(default_factory=SplittingConfig)
    loop: loop_closure.LoopDetectorConfig = field(
        default_factory=loop_closure.LoopDetectorConfig)
    relocalizer: RelocalizerConfig = field(default_factory=RelocalizerConfig)
    pgo: pgo.PGOConfig = field(default_factory=pgo.PGOConfig)
    local_ba: LocalBAConfig = field(default_factory=LocalBAConfig)
    arena_capacity: int = 4096
    # initial capacities; the pose graph grows double-and-copy when full
    max_local_maps: int = 512
    max_edges: int = 1024
    # the closure database is a ring of database_capacity //
    # max_db_descriptors_per_map maps; a full ring evicts its oldest map
    database_capacity: int = 65536
    max_db_descriptors_per_map: int = 1024
    enable_loop_closing: bool = True
    min_track_inliers: int = 6          # below this the tracker is Lost
    # finalized-map arenas kept on the device (most recently used); older
    # ones move to CPU tensors and reload at relocalisation
    max_device_map_arenas: int = 64
    closure_merge_max_insertions: int = 512
    speculation_depth: int = 0
    chunk_size: int = 0
    chunk_lag: int = 2
    chunk_group: int = 1


# tracker status machine (app_benchmark.cpp:123-178)
INITIALIZING = "Initializing"
TRACKING = "Tracking"
LOST = "Lost"


class FrameRecord(NamedTuple):
    """Host-side per-frame bookkeeping for trajectory unrolling."""

    timestamp: float
    local_map_index: int
    T_lm_robot: np.ndarray  # robot in its local map at this frame


class _HostCopy:
    """A device tensor's copy to the host, started without blocking: a
    non-blocking copy into pinned memory and a CUDA event recorded after
    it.  A CPU tensor is its own copy, always ready."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        # the pinned buffer holds stale bytes until the copy's event completes
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _PendingFrame(NamedTuple):
    """A dispatched frame not yet consumed: its measurements (to re-dispatch
    after a rollback), the tracker state after it (to roll back to), its
    stats (local BA keyframes) and its status packet's host copy."""

    meas: tuple           # (points, desc, valid)
    timestamp: float
    state: TrackerState
    stats: object
    packet: _HostCopy


class _ChunkEntry(NamedTuple):
    """A dispatched chunk not yet consumed: its tracker outputs, its first
    frame and its packet's host copy."""

    ys: object            # chunk.ChunkYs
    start: int
    packet: _HostCopy


@dataclass
class _ClosureMarker:
    """A split's loop query in the frame queue: its decision packet's host
    copy and the device tensors the closure and relocalisation need."""

    packet: _HostCopy               # [K, 22] (loop_closure.detect_and_validate)
    match_row: torch.Tensor         # [K, Q]
    match_mask: torch.Tensor        # [K, Q]
    T_candidates: torch.Tensor      # [K, 4, 4] query map in each candidate
    query_state: TrackerState       # tracker state after the split frame
    query_map: int
    timestamp: float
    T_split: np.ndarray             # robot in the query map at the split
    frame_record_index: int
    new_map: int = -1
    odo_edge_slot: int = -1


def _packet_Z(pkt: np.ndarray, k: int) -> np.ndarray:
    """Candidate ``k``'s validated closure transform from [K, 22] decision rows."""
    return pkt[k, 6:22].reshape(4, 4).astype(np.float32)


class GraphSLAM:
    """Graph SLAM on one device, or on each rank of a device mesh.

    ``process(meas_points, meas_desc, meas_valid, timestamp)`` per frame,
    with the adaptor's tensors on ``device`` (or ``process_dispatch`` /
    ``process_finalize``, then ``flush``), or ``process_sequence`` over
    whole image stacks; read ``robot_in_world()``, ``trajectory()`` and
    ``status``.  ``device`` defaults to the card and raises without one.
    The stages carry the JAX package's ``profile_time`` scopes
    (utils/profiling.py): tracker_dispatch, status_readback, split,
    db_insert, loop_detect, closure_decision (the whole decision:
    agreement, backstop rounds and their PGO), pgo and reloc.

    The chunk program adds chunk_dispatch and chunk_readback (the packet
    read, and each split's meta row); ``chunk_stats`` counts what it ran.

    ``num_reloc_rollbacks`` and ``num_reloc_replays`` count, as in the JAX
    package, the chunk program's relocalisations whose chunk held later
    finishes: undone on the device, or (a later finish kept a closure)
    recovered by replaying its split branches.  In per-frame mode they count
    relocalisations that found frames dispatched behind the split
    (speculation) and those frames, re-dispatched into the reloaded map;
    both stay 0 in the synchronous mode.  ``num_replayed_frames`` counts
    every frame the speculative queue re-dispatched, after splits and
    losses too: each runs its tracker step again.

    ``mesh`` (a ``parallel.spmd.Mesh``) runs the session on every rank of
    the mesh, each on the mesh's device for it (``device`` is then
    ignored); ``max_db_descriptors_per_map`` and ``max_edges`` must be
    divisible by the mesh size.
    """

    def __init__(self, cam: Camera, config: GraphSLAMConfig = GraphSLAMConfig(),
                 model: str = "stereo", device=torch.device("cuda"), mesh=None):
        _check_supported(config.tracker, model)
        self.cam = cam
        self.config = config
        self.model = model
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self.status = INITIALIZING
        self.tracker_state: TrackerState = self._initial_state()
        self.graph = pgo.empty_graph(config.max_local_maps, config.max_edges, self.device)
        self.db = loop_closure.empty_database(
            config.database_capacity, config.max_db_descriptors_per_map, self.device)
        self.num_maps = 0
        self.current_map = -1
        self.num_edges = 0
        self.num_closures = 0
        self.frames: List[FrameRecord] = []
        self._frames_in_current_map = 0
        self.last_stats = None
        # finalized local-map arenas by map id: the store relocalisation
        # reloads from; the most recently used stay on the device
        self._map_arenas: dict = {}
        self._arena_lru = deque()
        # the ids of the maps the database ring holds, oldest first
        self._db_maps: dict = {}
        self.num_db_evictions = 0
        self.num_relocalizations = 0
        self.num_losses = 0
        self.num_backstop_rejections = 0
        # (reference_map, query_map) of every accepted closure, in order
        self.closure_events: list = []
        # local-BA keyframes of the active map: (T_lm_sensor, match_idx,
        # GN measurement rows, match_mask), device tensors
        self._ba_keyframes: list = []
        # dispatched frames and split markers, consumed in order
        self._queue = deque()
        self._draining = False
        self.num_reloc_rollbacks = 0
        self.num_reloc_replays = 0
        self.num_replayed_frames = 0
        # the chunk program: dispatches not yet consumed, the active
        # sequence and the carry (models/chunk.py)
        self._cqueue = deque()
        self._seq = None
        self._seq_cursor = 0
        self._seq_lo = 0
        self._carry = None
        # what the chunk program ran: dispatches, chunk graph replays,
        # frames stepped eagerly (short windows), tracker steps in all,
        # chunks through the batched adaptor, split branches, packet reads
        self.chunk_stats = dict.fromkeys(
            ("dispatches", "graph_replays", "eager_frames", "tracker_steps",
             "adapted_chunks", "splits", "packet_reads"), 0)
        if mesh is not None:
            self._apply_mesh()

    # ------------------------------------------------------------------
    # the device mesh (the JAX package's _apply_mesh)
    # ------------------------------------------------------------------

    def _apply_mesh(self):
        """Stripe the closure ring along its budget axis and shard the pose
        graph's factors along edges; the tracker state stays replicated."""
        n = self.mesh.size
        if self.db.budget % n:
            raise ValueError(
                f"max_db_descriptors_per_map ({self.db.budget}) must be "
                f"divisible by the mesh size ({n})")
        if self.graph.edge_capacity % n:
            raise ValueError(
                f"max_edges ({self.graph.edge_capacity}) must be "
                f"divisible by the mesh size ({n})")
        self.db = spmd.shard_database(self.db, self.mesh)
        self.graph = spmd.shard_graph(self.graph, self.mesh)

    def _edge_capacity(self, graph: pgo.PoseGraph) -> int:
        """The graph's edge slots (every rank's, on a mesh)."""
        return graph.edge_capacity * (1 if self.mesh is None else self.mesh.size)

    def _grow(self, graph: pgo.PoseGraph, pose_capacity: int,
              edge_capacity: int) -> pgo.PoseGraph:
        """``pgo.grow``; on a mesh the grown factors are resharded (the
        doubled capacity stays divisible by the mesh size)."""
        if self.mesh is None:
            return pgo.grow(graph, pose_capacity, edge_capacity)
        grown = pgo.grow(spmd.gather_graph(graph, self.mesh), pose_capacity, edge_capacity)
        return spmd.shard_graph(grown, self.mesh)

    def _edge_added(self, graph: pgo.PoseGraph, num_edges: int, i: int, j: int, Z):
        """Factor insertion at slot ``num_edges``, with double-and-copy
        growth: (graph, num_edges + 1)."""
        ecap = self._edge_capacity(graph)
        if num_edges >= ecap:
            graph = self._grow(graph, graph.capacity, 2 * ecap)
        return pgo.add_edge(graph, num_edges, i, j, Z, mesh=self.mesh), num_edges + 1

    def _initial_state(self) -> TrackerState:
        return initial_state(self.config.arena_capacity,
                             self.config.tracker.landmark_estimator,
                             device=self.device)

    # ------------------------------------------------------------------
    # local-map management
    # ------------------------------------------------------------------

    def _make_new_map(self, T_world_new_lm: torch.Tensor):
        """makeNewMap analog (app_benchmark.cpp:93-98,136-169)."""
        idx = self.num_maps
        if idx >= self.graph.capacity:
            self.graph = self._grow(self.graph, 2 * self.graph.capacity,
                                    self._edge_capacity(self.graph))
        self.graph = pgo.add_pose(self.graph, idx, T_world_new_lm)
        if self.current_map >= 0:
            # odometry factor from the previously active map (after a
            # relocalisation an OLD map, not idx - 1)
            prev = self.current_map
            Z = se3.inverse(self.graph.poses[prev]) @ T_world_new_lm
            self._add_graph_edge(prev, idx, Z)
        self.num_maps = idx + 1
        self.current_map = idx
        # fresh tracker state: empty arena, identity pose, keep velocity
        vel = self.tracker_state.velocity
        self.tracker_state = self._initial_state()._replace(velocity=vel)
        self._frames_in_current_map = 0
        self._ba_keyframes = []

    def _add_graph_edge(self, i: int, j: int, Z):
        self.graph, self.num_edges = self._edge_added(self.graph, self.num_edges, i, j, Z)

    def _get_map_arena(self, mid: int) -> lm.LandmarkArena:
        """A finalized map's arena on the device (reloaded if it was moved)."""
        arena = self._map_arenas[mid].to(self.device)
        self._map_arenas[mid] = arena
        self._note_device_arena(mid)
        return arena

    def _note_device_arena(self, mid: int):
        """Mark map ``mid``'s arena as most recently used; move the least
        recently used beyond ``max_device_map_arenas`` to CPU tensors (one
        synchronous copy each)."""
        if mid in self._arena_lru:
            self._arena_lru.remove(mid)
        self._arena_lru.append(mid)
        while len(self._arena_lru) > self.config.max_device_map_arenas:
            old = self._arena_lru.popleft()
            self._map_arenas[old] = self._map_arenas[old].to("cpu")

    def _mirror_ring_insert(self, map_id: int):
        """Mirror one ring insertion: a full ring's slot write evicts its
        oldest map, and the mirror drops the same one."""
        if len(self._db_maps) >= self.db.num_slots:
            oldest = next(iter(self._db_maps))
            del self._db_maps[oldest]
            self.num_db_evictions += 1
            print(f"[slam] loop database ring full: evicted map {oldest} "
                  f"({self.num_db_evictions} evictions total)")
        self._db_maps[map_id] = None

    def _finalize_current_map(self):
        """Keep the finished map's arena for relocalisation and write its most
        mature landmarks into the next database slot."""
        arena = self.tracker_state.arena
        self._map_arenas[self.current_map] = arena
        self._note_device_arena(self.current_map)
        if not self.config.enable_loop_closing:
            return
        if self.current_map in self._db_maps:
            return  # re-finalizing a reloaded map: descriptors already stored
        desc_b, pts_b, rows_b, valid_b, _ = loop_closure.select_db_rows(
            arena.desc, arena.pos, arena.valid, arena.num_updates,
            budget=self.config.max_db_descriptors_per_map)
        self._mirror_ring_insert(self.current_map)
        self.db = loop_closure.add_local_map(self.db, desc_b, pts_b, valid_b,
                                             self.current_map, rows_b, self.mesh)

    def _loop_query(self, state: TrackerState, T_split: np.ndarray,
                    timestamp: float) -> _ClosureMarker:
        """loopDetect/loopValidate (app_benchmark.cpp:136-161): query the
        database with the finished map and validate its candidates; the
        decision packet is the one host read of the split."""
        arena = state.arena
        result, closures, packet = loop_closure.detect_and_validate(
            arena.desc, arena.valid, arena.pos, self.current_map, self.db,
            self.graph.poses, self.config.loop, self.graph.capacity, self.mesh)
        return _ClosureMarker(
            packet=_HostCopy(packet), match_row=result.match_row,
            match_mask=result.match_mask, T_candidates=closures.T_query_in_ref,
            query_state=state, query_map=self.current_map, timestamp=timestamp,
            T_split=T_split, frame_record_index=len(self.frames))

    def _consume_marker(self, m: _ClosureMarker):
        """Apply a split's closure decision: factors and PGO under the
        geometric backstop.  Returns the relocalisation's (k, candidate,
        T_k) when the best accepted closure passes the relocaliser's gates,
        else None."""
        pkt = m.packet.numpy().reshape(-1, 22)
        accepted = [k for k in range(pkt.shape[0]) if pkt[k, 1] > 0.5 and pkt[k, 0] >= 0]
        if not accepted:
            return None
        self.graph, self.num_edges, kept = self._closure_decision(
            self.graph, self.num_edges, pkt, list(accepted), m.query_map)
        n_rej = len(accepted) - len(kept)
        if n_rej > 0:
            self.num_backstop_rejections += n_rej
            print(f"[slam] closure backstop: rejected {n_rej} "
                  f"candidate(s) into map {m.query_map}")
        if not kept:
            return None
        best_k = max(kept, key=lambda k: pkt[k, 2])
        for k in kept:
            self.num_closures += 1
            self.closure_events.append((int(pkt[k, 0]), m.query_map))
        row = pkt[best_k]
        if self._reloc_gates(row):
            return best_k, int(row[0]), _packet_Z(pkt, best_k)
        return None

    def _closure_decision(self, graph: pgo.PoseGraph, num_edges: int, pkt: np.ndarray,
                          accepted: list, query_map: int):
        """The candidates ``accepted`` by the reference's gates (rows of the
        [K, 22] decision ``pkt``) become factors of ``graph`` and PGO runs,
        under the geometric backstop.  Returns (graph, num_edges, the
        candidates kept); with none kept, the graph as it came."""
        config = self.config
        pre_graph, pre_edges = graph, num_edges

        def insert_and_optimize(ks):
            g, n = pre_graph, pre_edges
            for k in ks:
                g, n = self._edge_added(g, n, int(pkt[k, 0]), query_map,
                                        torch.as_tensor(_packet_Z(pkt, k), device=self.device))
            with profile_time("pgo"):
                g, _ = pgo.optimize(g, config.pgo, mesh=self.mesh)
            return g, n

        thr = config.loop.backstop_max_edge_residual
        tol = config.loop.backstop_agreement_tolerance
        poses_np = pre_graph.poses.cpu().numpy()
        if thr > 0 and tol > 0 and len(accepted) >= 2:
            # candidate agreement: the implied query positions must form a
            # majority cluster; 1-vs-1 rejects both
            t_impl = {k: (poses_np[int(pkt[k, 0])] @ pkt[k, 6:22].reshape(4, 4))[:3, 3]
                      for k in accepted}
            score = {a: sum(1 for b in accepted
                            if np.linalg.norm(t_impl[a] - t_impl[b]) <= tol)
                     for a in accepted}
            mx = max(score.values())
            accepted = [k for k in accepted if score[k] == mx and mx >= 2]
        if thr <= 0:
            g, n = insert_and_optimize(accepted)
            return g, n, accepted
        # greedy outlier pruning: while a closure edge's own post-PGO
        # residual, or the held-out pre-existing factors' mean residual
        # worsening, exceeds the bound, drop the candidate with the largest
        # pre-insertion residual and re-optimize from the graph as it came
        def held_out(g):
            # tracks the current edge capacity (insertion can grow it)
            return torch.arange(self._edge_capacity(g), device=self.device) < pre_edges

        base_chain = float(pgo.mean_edge_residual(pre_graph, held_out(pre_graph), self.mesh))
        pre_r = {}
        for k in accepted:
            M = (np.linalg.inv(_packet_Z(pkt, k)) @ np.linalg.inv(poses_np[int(pkt[k, 0])])
                 @ poses_np[query_map])
            pre_r[k] = float(np.linalg.norm(M[:3, 3]))
        for _ in range(len(accepted) + 1):
            if not accepted:
                break
            g, n = insert_and_optimize(accepted)
            # one read: every edge's residual and the held-out mean
            r = torch.cat([pgo.edge_t_residuals(g, self.mesh),
                           pgo.mean_edge_residual(g, held_out(g), self.mesh)[None]]).cpu().numpy()
            chain_bad = float(r[-1]) > base_chain + thr
            self_r = [r[pre_edges + j] for j in range(len(accepted))]
            if not chain_bad and max(self_r) <= thr:
                return g, n, accepted
            accepted.remove(max(accepted, key=lambda k: pre_r[k]))
        # budget exhausted while still inconsistent
        return pre_graph, pre_edges, []

    def _reloc_gates(self, row: np.ndarray) -> bool:
        """MultiRelocalizer3D gates (kitti.conf:91-110) on a packet row."""
        rc = self.config.relocalizer
        t = row[6:22].reshape(4, 4)[:3, 3]
        return bool(np.linalg.norm(t) <= rc.max_translation
                    and row[2] >= rc.relocalize_min_inliers
                    and row[3] <= rc.relocalize_max_chi_inliers
                    and row[4] >= rc.relocalize_min_inliers_ratio)

    def _relocalize(self, m: _ClosureMarker, k: int, cand: int, T_k: np.ndarray):
        """Move tracking back into the old local map ``cand``: retire the map
        opened at the split, merge the finished query map into the reloaded
        arena through the closure correspondences, re-record the split
        frame in the old map, and re-dispatch the frames queued behind the
        marker (tracked into the retired map) against the reloaded one."""
        rest = list(self._queue)
        self._queue.clear()
        T_new = (T_k @ m.T_split).astype(np.float32)
        qs = m.query_state
        self.graph, self.tracker_state = chunk_ops.reloc_op(
            self.graph, self._get_map_arena(cand), qs.arena, m.T_candidates, m.match_row,
            m.match_mask, k, torch.as_tensor(T_new, device=self.device), qs.velocity,
            qs.meas_buf, m.new_map, m.odo_edge_slot, self.config.closure_merge_max_insertions,
            self.mesh)
        self._map_arenas[cand] = self.tracker_state.arena
        self._note_device_arena(cand)
        self.num_relocalizations += 1
        self._frames_in_current_map = 1  # the arena is populated
        self.current_map = cand
        # keyframes of the abandoned map index its arena, not this one
        self._ba_keyframes = []
        # the split frame's record belongs to the reloaded map
        self.frames[m.frame_record_index] = FrameRecord(m.timestamp, cand, T_new)
        if rest:
            self.num_reloc_rollbacks += 1
            self.num_reloc_replays += len(rest)
        self._redispatch(rest)

    # ------------------------------------------------------------------
    # per-frame processing
    # ------------------------------------------------------------------

    def process(self, meas_points, meas_desc, meas_valid, timestamp: float = 0.0):
        """One SLAM step on adapted measurements; returns the frame's stats.

        With ``speculation_depth == 0`` the frame is consumed before this
        returns; with a positive depth the status machine runs that many
        frames behind the dispatch.
        """
        stats = self.process_dispatch(meas_points, meas_desc, meas_valid, timestamp)
        self.process_finalize()
        return stats

    def process_dispatch(self, meas_points, meas_desc, meas_valid,
                         timestamp: float = 0.0):
        """Dispatch the frame's tracker step and queue it, with a
        non-blocking host copy of its status packet; returns its stats."""
        if self.num_maps == 0:
            self._make_new_map(se3.identity(self.device))
            self.status = INITIALIZING
        with profile_time("tracker_dispatch"):
            state, stats, _ = track_step(self.tracker_state, meas_points, meas_desc,
                                         meas_valid, self.cam, self.config.tracker,
                                         self.model)
        self.tracker_state = state
        self.last_stats = stats
        self._queue.append(_PendingFrame(
            meas=(meas_points, meas_desc, meas_valid), timestamp=timestamp,
            state=state, stats=stats, packet=_HostCopy(stats.host_packet)))
        return stats

    def process_finalize(self):
        """Consume queued frames down to the speculation depth."""
        self._drain(self.config.speculation_depth)

    def flush(self):
        """Consume everything queued (waiting for the card as needed)."""
        if self._draining:
            return  # re-entered from inside a consumption
        self._draining = True
        try:
            self._drain(0, force=True)
        finally:
            self._draining = False

    def _drain(self, depth: int, force: bool = False):
        force = force or depth <= 0
        # a marker whose packet has not landed may wait, while the queue
        # runs ahead of it up to this cap
        hard = depth + max(depth, 4)
        while len(self._queue) > depth:
            head = self._queue[0]
            if isinstance(head, _ClosureMarker):
                if (not force and len(self._queue) <= hard
                        and not head.packet.ready()):
                    return
                self._queue.popleft()
                with profile_time("closure_decision"):
                    reloc = self._consume_marker(head)
                if reloc is not None:
                    with profile_time("reloc"):
                        self._relocalize(head, *reloc)
            else:
                self._queue.popleft()
                self._consume_frame(head)

    def _redispatch(self, frames):
        for f in frames:
            self.num_replayed_frames += 1
            self.process_dispatch(*f.meas, f.timestamp)

    def _rollback_replay(self, e: _PendingFrame, handler):
        """Roll the tracker back to frame ``e``, run ``handler`` (split or
        loss), then re-dispatch the frames dispatched after ``e``."""
        rest = list(self._queue)
        self._queue.clear()
        self.tracker_state = e.state
        handler()
        self._redispatch(rest)

    def _consume_frame(self, e: _PendingFrame):
        """The status machine on the frame's packet (one host read)."""
        config = self.config
        with profile_time("status_readback"):
            pkt = e.packet.numpy()
        num_inliers, t_norm, angle = int(pkt[0]), float(pkt[1]), float(pkt[2])
        if self._frames_in_current_map == 0:
            # a fresh map's first frame only populates the arena
            self.status = INITIALIZING
        elif num_inliers >= config.min_track_inliers:
            self.status = TRACKING
        else:
            self.status = LOST
        self._frames_in_current_map += 1
        if config.local_ba.enabled and self.status == TRACKING:
            self._record_ba_keyframe(e)

        T_rec = np.eye(4, dtype=np.float32)
        if self.status == LOST:
            self._rollback_replay(e, lambda: self._handle_lost(e))
        elif (t_norm > config.splitting.maximum_translation_m
              or angle > config.splitting.maximum_rotation_rad):
            # splitting criterion (viewpoint distance, kitti.conf:542-550)
            T_split = np.eye(4, dtype=np.float32)
            T_split[:3, :] = pkt[8:20].reshape(3, 4)
            with profile_time("split"):
                self._rollback_replay(e, lambda: self._handle_split(e, T_split))
        else:
            T_rec[:3, :] = pkt[8:20].reshape(3, 4)
        self.frames.append(FrameRecord(e.timestamp, self.current_map, T_rec))

    def _handle_lost(self, e: _PendingFrame):
        """Lost: close the map and start a fresh one at the predicted world
        pose, with the motion model reset (app_benchmark.cpp:163-169)."""
        self.num_losses += 1
        T_world_robot = self.graph.poses[self.current_map] @ e.state.T_lm_robot
        with profile_time("db_insert"):
            self._finalize_current_map()
        self._make_new_map(T_world_robot)
        self.tracker_state = self.tracker_state._replace(
            velocity=torch.zeros(6, dtype=torch.float32, device=self.device))
        self.status = TRACKING

    def _handle_split(self, e: _PendingFrame, T_split: np.ndarray):
        """Close the current local map, query the loop database, and open the
        next map (app_benchmark.cpp:136-161); the query's marker joins the
        queue.  With local BA the finished map's landmarks are refined
        first; the database and the arena store take the refined map, the
        loop query the frame's own."""
        if self.config.local_ba.enabled:
            with profile_time("local_ba"):
                self._run_local_ba()
        T_world_robot = self.graph.poses[self.current_map] @ e.state.T_lm_robot
        with profile_time("db_insert"):
            self._finalize_current_map()
        marker = None
        if self.config.enable_loop_closing and self.num_maps >= 2:
            with profile_time("loop_detect"):
                marker = self._loop_query(e.state, T_split, e.timestamp)
        self._make_new_map(T_world_robot)
        if marker is not None:
            marker.new_map = self.current_map
            marker.odo_edge_slot = self.num_edges - 1
            self._queue.append(marker)

    def _record_ba_keyframe(self, e: _PendingFrame):
        """Keep every ``keyframe_stride``-th tracked frame's association for
        split-time BA (device tensors; no read back), the last
        ``max_keyframes`` of the active map.  Keyframe poses are sensor
        poses: the sensor-in-robot extrinsic is folded in."""
        lba = self.config.local_ba
        if self._frames_in_current_map % lba.keyframe_stride != 0:
            return
        meas_points = e.meas[0]
        gn_meas = meas_points[:, :3] if self.model == "stereo" else meas_points
        T_rs, _ = _robot_sensor(tuple(self.config.tracker.T_robot_sensor), self.device)
        self._ba_keyframes.append((e.state.T_lm_robot @ T_rs, e.stats.match_idx, gn_meas,
                                   e.stats.match_mask))
        if len(self._ba_keyframes) > lba.max_keyframes:
            self._ba_keyframes.pop(0)

    def _run_local_ba(self):
        """Refine the finished map's landmarks over its keyframes (ops/ba.py;
        with ``ba.structure_only`` off the keyframe poses move too, but only
        the points are kept).  Pure device work: nothing is read back."""
        lba = self.config.local_ba
        K = len(self._ba_keyframes)
        if K < 2:
            return
        arena = self.tracker_state.arena
        P = lba.max_keyframes
        N = self._ba_keyframes[0][2].shape[0]
        zdim = self._ba_keyframes[0][2].shape[1]
        dev = self.device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        pad = (P - K) * N
        refine_mask = arena.valid
        if lba.max_refine_maturity > 0:
            refine_mask = refine_mask & (arena.num_updates <= lba.max_refine_maturity)
        problem = ba_ops.BAProblem(
            poses=torch.stack([kf[0] for kf in self._ba_keyframes] + [eye] * (P - K)),
            pose_valid=torch.arange(P, device=dev) < K,
            points=arena.pos, point_valid=refine_mask,
            obs_kf=torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(N),
            obs_lm=torch.cat([kf[1].clamp_min(0) for kf in self._ba_keyframes]
                             + [torch.zeros((pad,), dtype=torch.int32, device=dev)]),
            obs_z=torch.cat([kf[2] for kf in self._ba_keyframes]
                            + [torch.zeros((pad, zdim), dtype=torch.float32, device=dev)]),
            obs_valid=torch.cat([kf[3] for kf in self._ba_keyframes]
                                + [torch.zeros((pad,), dtype=torch.bool, device=dev)]))
        refined, _ = ba_ops.optimize(problem, self.cam, self.model, lba.ba)
        self.tracker_state = self.tracker_state._replace(
            arena=arena._replace(pos=refined.points))

    # ------------------------------------------------------------------
    # sequences: the chunk program (models/chunk.py)
    # ------------------------------------------------------------------

    def process_sequence(self, a_all, b_all, timestamps, adaptor_config,
                         count: int = None):
        """Run a whole image sequence through the chunk program: ``a_all`` /
        ``b_all`` [T, H, W] stacks (left/right for stereo, intensity/raw
        depth for RGB-D) are uploaded to the device once; each chunk of
        ``chunk_size`` frames goes through the batched adaptor and then the
        chunk's tracker steps.  Equal frame for frame to the per-frame
        ``process`` loop."""
        T = int(count if count is not None else a_all.shape[0])
        self._start_sequence(dict(kind="images", stacks=(a_all, b_all),
                                  acfg=adaptor_config), timestamps, T)
        self._run_sequence()

    def process_meas_sequence(self, points_all, desc_all, valid_all, timestamps,
                              count: int = None):
        """``process_sequence`` over adapted measurement stacks [T, N, ...]."""
        T = int(count if count is not None else points_all.shape[0])
        self._start_sequence(dict(kind="meas", stacks=(points_all, desc_all, valid_all)),
                             timestamps, T)
        self._run_sequence()

    @property
    def _chunk_span(self) -> int:
        """Frames per dispatch and packet read: chunk_size * chunk_group."""
        return self.config.chunk_size * max(1, self.config.chunk_group)

    def _start_sequence(self, seq: dict, timestamps, T: int):
        span = self._chunk_span
        if span <= 0:
            raise ValueError("sequence processing requires config.chunk_size > 0")
        if self.config.local_ba.enabled:
            raise ValueError("local_ba is per-frame-mode only, as in the JAX package "
                             "(its keyframe ring does not ride the chunk program)")
        if self._queue:
            raise RuntimeError("cannot mix per-frame and sequence processing: "
                               "flush() first")
        # padded to whole dispatches: the tail's frames are inactive
        Tp = -(-T // span) * span
        stacks = []
        for x in seq["stacks"]:
            x = torch.as_tensor(x)[:T].to(self.device)
            pad = torch.zeros((Tp - T,) + x.shape[1:], dtype=x.dtype, device=self.device)
            stacks.append(torch.cat([x, pad]))
        seq["stacks"] = stacks
        ts = list(timestamps)
        seq["ts"] = ts + [float(len(ts) + i) for i in range(T - len(ts))]
        seq["T"] = T
        self._seq = seq
        self._seq_cursor = 0
        self._seq_lo = 0
        if self.num_maps == 0:
            self._make_new_map(se3.identity(self.device))
            self.status = INITIALIZING

        def scalar(v):
            return torch.full((), v, dtype=torch.int32, device=self.device)

        self._carry = chunk_ops.ChunkCarry(
            state=self.tracker_state, frames_in_map=scalar(self._frames_in_current_map),
            graph=self.graph, edge_count=scalar(self.num_edges), db=self.db,
            current_map=scalar(self.current_map), num_maps=scalar(self.num_maps))

    def _run_sequence(self):
        span = self._chunk_span
        T = self._seq["T"]
        while self._seq_cursor < T or self._cqueue:
            if self._seq_cursor < T:
                start, lo = self._seq_cursor, self._seq_lo
                self._seq_lo = 0
                self._dispatch_chunk(start, lo, min(span, T - start))
                self._seq_cursor = start + span
                self._drain_chunk_queue(self.config.chunk_lag)
            else:
                # the tail: consume everything; a relocalisation here can
                # rewind the cursor into the dispatch branch
                self._drain_chunk_queue(0, force=True)
        self._seq = None

    def _chunk_inputs(self, start: int):
        """The measurements of the ``chunk_size`` frames from ``start``: the
        batched adaptor over the images (one FAST and one BRIEF launch on
        the card), or slices of the measurement stacks."""
        B = self.config.chunk_size
        seq = self._seq
        chunk = [x[start:start + B] for x in seq["stacks"]]
        if seq["kind"] == "images":
            adapt = adapt_stereo_batch if self.model == "stereo" else adapt_rgbd_batch
            meas = adapt(*chunk, seq["acfg"])
            self.chunk_stats["adapted_chunks"] += 1
            return meas.points, meas.desc, meas.valid
        return chunk

    def _invoke_chunk(self, state: TrackerState, frames_in_map, start: int, lo: int,
                      hi: int):
        """The tracker half of one dispatch: ``chunk_group`` chunks from
        ``start``, frames [lo, hi) active (dispatch coordinates).  Returns
        (state, frames_in_map, ChunkYs of chunk_size * chunk_group rows)."""
        config = self.config
        B = config.chunk_size
        sp = config.splitting
        args = (self.cam, config.tracker, self.model, config.min_track_inliers,
                sp.maximum_translation_m, sp.maximum_rotation_rad)
        parts = []
        st = self.chunk_stats
        for g in range(max(1, config.chunk_group)):
            # a chunk of the group with no active frame (the padded tail, a
            # rewind) still gets its rows, as each chunk of JAX's group scan
            lo_g = min(max(lo - g * B, 0), B)
            hi_g = max(min(max(hi - g * B, 0), B), lo_g)
            pts, desc, valid = self._chunk_inputs(start + g * B)
            state, frames_in_map, ys = chunk_ops.run_chunk(
                state, frames_in_map, pts, desc, valid, lo_g, hi_g, *args)
            st["tracker_steps"] += hi_g - lo_g
            if pts.is_cuda and (lo_g, hi_g) == (0, B):
                st["graph_replays"] += 1
            else:
                st["eager_frames"] += hi_g - lo_g
            parts.append(ys)
        if len(parts) == 1:
            return state, frames_in_map, parts[0]
        ys = graphs.unflatten(graphs.flatten(parts[0])[1],
                              [torch.cat(ts) for ts in zip(*(graphs.flatten(p)[0]
                                                              for p in parts))])
        return state, frames_in_map, ys

    def _dispatch_chunk(self, start: int, lo: int, hi: int):
        with profile_time("chunk_dispatch"):
            state, fim, ys = self._invoke_chunk(self._carry.state, self._carry.frames_in_map,
                                                start, lo, hi)
            packet = _HostCopy(ys.packet)
        self._carry = self._carry._replace(state=state, frames_in_map=fim)
        self.tracker_state = state
        self.chunk_stats["dispatches"] += 1
        self._cqueue.append(_ChunkEntry(ys=ys, start=start, packet=packet))

    def _drain_chunk_queue(self, lag: int, force: bool = False):
        while self._cqueue and (force or len(self._cqueue) > lag):
            self._consume_chunk(self._cqueue.popleft())

    def _consume_chunk(self, entry: "_ChunkEntry"):
        """Read the dispatch's packet (one host read), run the split branch
        of every finished frame, then mirror status, maps, database, events
        and counters frame by frame; a relocalisation ends the dispatch."""
        with profile_time("chunk_readback"):
            pkt = entry.packet.numpy()
        self.chunk_stats["packet_reads"] += 1
        # the map half of the carry before this dispatch's splits, with the
        # host's counts of maps and edges: what a replay starts from
        pre = (self._carry, self.num_maps, self.num_edges)
        finished = [i for i in range(pkt.shape[0])
                    if pkt[i, chunk_ops.PKT_ACTIVE] > 0.5 and pkt[i, chunk_ops.PKT_FINISH] > 0.5]
        self._carry, meta, splits = self._split_pass(entry.ys, pkt, finished, *pre)
        self.graph, self.db = self._carry.graph, self._carry.db
        for i in range(pkt.shape[0]):
            if pkt[i, chunk_ops.PKT_ACTIVE] > 0.5 and self._consume_chunk_frame(
                    entry, pre, i, pkt, meta, splits):
                return

    def _split_pass(self, ys: chunk_ops.ChunkYs, pkt: np.ndarray, finished: list,
                    carry: chunk_ops.ChunkCarry, num_maps: int, num_edges: int):
        """The split branch of every finished frame in order, from ``carry``
        (map half) with ``num_maps`` maps and ``num_edges`` edges: a graph
        replay on the card, the read of its split-meta row, and where a
        candidate passed the reference's gates the closure decision (PGO),
        whose backstop rejections the row then reports as -1.  Returns
        (carry, meta [rows, SM] float32, {frame: (SplitYs, arena)})."""
        P = chunk_ops
        config = self.config
        K = config.loop.max_candidates
        meta = np.zeros((pkt.shape[0], P.split_meta_size(K)), np.float32)
        splits = {}
        for i in finished:
            graph = self._ensure_chunk_capacity(carry.graph, num_maps, num_edges)
            do_loop = (config.enable_loop_closing and num_maps >= 2
                       and pkt[i, P.PKT_FINISH] != P.FINISH_LOST)
            arena = P.take_frame(ys.arenas, i)
            graph, ec, db, cur, nm, sy = P.run_split(
                graph, carry.edge_count, carry.db, carry.current_map, carry.num_maps,
                ys.T_lm_robot[i], arena, config.max_db_descriptors_per_map, config.loop,
                config.enable_loop_closing, do_loop, self.mesh)
            with profile_time("chunk_readback"):
                m = sy.meta.cpu().numpy()
            self.chunk_stats["splits"] += 1
            self.chunk_stats["packet_reads"] += 1
            num_edges, num_maps = int(m[P.SM_EDGES]), int(m[P.SM_NEW]) + 1
            cp = m[P.SM_CP:].reshape(K, 22)
            accepted = [k for k in range(K) if cp[k, 1] > 0.5 and cp[k, 0] >= 0]
            if accepted:
                with profile_time("closure_decision"):
                    graph, num_edges, kept = self._closure_decision(
                        graph, num_edges, cp, list(accepted), int(m[P.SM_PREV]))
                ec = torch.full((), num_edges, dtype=torch.int32, device=self.device)
                m[P.SM_EDGES] = num_edges
                for k in accepted:
                    if k not in kept:
                        cp[k, 1] = -1.0
                m[P.SM_CP:] = cp.reshape(-1)
            meta[i] = m
            splits[i] = (sy, arena)
            carry = carry._replace(graph=graph, edge_count=ec, db=db, current_map=cur,
                                   num_maps=nm)
        return carry, meta, splits

    def _consume_chunk_frame(self, entry: "_ChunkEntry", pre: tuple, i: int,
                             pkt: np.ndarray, meta: np.ndarray, splits: dict) -> bool:
        """Mirror frame ``i`` of the dispatch: its status and record, and at
        a finish the split the device ran and its closure decision.
        Returns True when it relocalised (the rest of the dispatch and the
        queue are dropped)."""
        P = chunk_ops
        config = self.config
        row = pkt[i]
        g = entry.start + i
        ts = self._seq["ts"][g]
        if self._frames_in_current_map == 0:
            self.status = INITIALIZING
        elif row[P.PKT_INLIERS] >= config.min_track_inliers:
            self.status = TRACKING
        else:
            self.status = LOST
        self._frames_in_current_map += 1
        fin = row[P.PKT_FINISH]
        if fin == P.FINISH_NONE:
            T_rec = np.eye(4, dtype=np.float32)
            T_rec[:3, :] = row[P.PKT_T:P.PKT_T + 12].reshape(3, 4)
            self.frames.append(FrameRecord(ts, self.current_map, T_rec))
            return False
        sm = meta[i]
        sy, arena = splits[i]
        prev, new = int(sm[P.SM_PREV]), int(sm[P.SM_NEW])
        self._map_arenas[prev] = arena
        self._note_device_arena(prev)
        if sm[P.SM_INS] > 0.5:
            ev = int(sm[P.SM_EVICTED])
            if ev >= 0:
                # the ring slot write overwrote the oldest stored map
                self._db_maps.pop(ev, None)
                self.num_db_evictions += 1
                print(f"[slam] loop database ring full: evicted map {ev} "
                      f"({self.num_db_evictions} evictions total)")
            # the stored rows, kept to restore the slot in a rollback
            self._db_maps[prev] = (sy.desc, sy.pos, sy.rows, int(sm[P.SM_DBN]))
        self.num_edges = int(sm[P.SM_EDGES])
        self.num_maps = new + 1
        self.current_map = new
        self._frames_in_current_map = 0
        self.frames.append(FrameRecord(ts, new, np.eye(4, dtype=np.float32)))
        if fin == P.FINISH_LOST:
            self.num_losses += 1
            self.status = TRACKING
        K = config.loop.max_candidates
        cp = sm[P.SM_CP:].reshape(K, 22)
        accepted = [k for k in range(K) if cp[k, 1] > 0.5 and cp[k, 0] >= 0]
        rejected = [k for k in range(K) if cp[k, 1] < -0.5]
        if rejected:
            self.num_backstop_rejections += len(rejected)
            print(f"[slam] closure backstop: rejected {len(rejected)} "
                  f"candidate(s) into map {prev}")
        if not accepted:
            return False
        self.num_closures += len(accepted)
        for k in accepted:
            self.closure_events.append((int(cp[k, 0]), prev))
        best_k = max(accepted, key=lambda k: cp[k, 2])
        if not self._reloc_gates(cp[best_k]):
            return False
        with profile_time("reloc"):
            self._fused_relocalize(entry, pre, i, best_k, int(cp[best_k, 0]),
                                   _packet_Z(cp, best_k), pkt, meta, splits)
        return True

    def _fused_relocalize(self, entry: "_ChunkEntry", pre: tuple, i: int, k: int,
                          cand: int, T_k: np.ndarray, pkt: np.ndarray, meta: np.ndarray,
                          splits: dict):
        """Reload old map ``cand`` at frame ``i``'s finish: drop the
        dispatches in flight, recover the map half of the carry exactly at
        the finish, run ``reloc_op``, and rewind the sequence to the frame
        after the finish.

        Later finishes of the dispatch ran their split branches already.
        Where none kept a closure they are undone on the device (their pose
        and odometry factor invalidated, their ring slot restored from the
        host's mirror, the counters reset from frame ``i``'s split-meta
        row): ``num_reloc_rollbacks``.  A later closure's PGO rewrote every
        pose, which invalidation cannot undo: the dispatch's split branches
        are replayed up to the finish from the map half they started from
        instead (``num_reloc_replays``).  The tracker rows up to the finish
        are the dispatch's own: the JAX package's replay recomputes them, to
        the same values, because its program fuses both halves."""
        P = chunk_ops
        K = self.config.loop.max_candidates
        self._cqueue.clear()
        sm = meta[i]
        later = [j for j in range(i + 1, pkt.shape[0])
                 if pkt[j, P.PKT_ACTIVE] > 0.5 and pkt[j, P.PKT_FINISH] > 0.5]
        carry = self._carry
        if later:
            later_closure = any(meta[j, P.SM_CP + 22 * c + 1] > 0.5
                                for j in later for c in range(K))
            try:
                if later_closure or self.mesh is not None:
                    # a mesh replays, as the JAX package's meshed program does
                    raise KeyError("a later finish kept a closure, or a mesh")
                carry = self._rollback_later_finishes(carry, sm, [meta[j] for j in later])
                self.num_reloc_rollbacks += 1
            except KeyError:
                # a later closure, or an evicted map's rows not mirrored:
                # with a small ring a later finish can evict a map another
                # later finish of this dispatch stored, and a database
                # restored from a checkpoint mirrors no rows: replay
                self.num_reloc_replays += 1
                finished = [j for j in range(i + 1)
                            if pkt[j, P.PKT_ACTIVE] > 0.5 and pkt[j, P.PKT_FINISH] > 0.5]
                carry, _, splits = self._split_pass(entry.ys, pkt, finished, *pre)
        row = pkt[i]
        T_split = np.eye(4, dtype=np.float32)
        T_split[:3, :] = row[P.PKT_T:P.PKT_T + 12].reshape(3, 4)
        T_new = (T_k @ T_split).astype(np.float32)
        sy, query_arena = splits[i]
        velocity = torch.as_tensor(row[P.PKT_VEL:P.PKT_VEL + 6].copy(), device=self.device)
        graph, state = P.reloc_op(
            carry.graph, self._get_map_arena(cand), query_arena, sy.loop_T, sy.loop_row,
            sy.loop_mask, k, torch.as_tensor(T_new, device=self.device), velocity,
            carry.state.meas_buf, int(sm[P.SM_NEW]), int(sm[P.SM_ODO]),
            self.config.closure_merge_max_insertions, self.mesh)
        self._carry = carry._replace(
            state=state, frames_in_map=torch.full((), 1, dtype=torch.int32, device=self.device),
            graph=graph, current_map=torch.full((), cand, dtype=torch.int32, device=self.device))
        self.tracker_state, self.graph, self.db = state, graph, carry.db
        self._map_arenas[cand] = state.arena
        self._note_device_arena(cand)
        self.current_map = cand
        self._frames_in_current_map = 1
        self.num_relocalizations += 1
        # the finish frame's record belongs to the reloaded map
        g = entry.start + i
        self.frames[-1] = FrameRecord(self._seq["ts"][g], cand, T_new)
        span = self._chunk_span
        self._seq_cursor = (g + 1) // span * span
        self._seq_lo = g + 1 - self._seq_cursor

    def _rollback_later_finishes(self, carry: chunk_ops.ChunkCarry, sm_i: np.ndarray,
                                 later_meta: list) -> chunk_ops.ChunkCarry:
        """The carry at frame ``i``'s finish from the carry after the later
        finishes, undone on the device: their poses and odometry factors
        invalidated, each ring slot they wrote restored from the mirror of
        the map it evicted (or cleared where the slot was free), the edge
        and map counts from frame ``i``'s row.  Raises KeyError where an
        evicted map's rows are not mirrored."""
        P = chunk_ops
        graph = P.undo_graph_entries(carry.graph, [int(m[P.SM_NEW]) for m in later_meta],
                                     [int(m[P.SM_ODO]) for m in later_meta], self.mesh)
        db = carry.db
        budget = db.budget * (1 if self.mesh is None else self.mesh.size)
        next_fin = int(sm_i[P.SM_DBNEXT])
        for m in reversed(later_meta):
            if m[P.SM_INS] < 0.5:
                continue
            slot = (int(m[P.SM_DBNEXT]) - 1) % db.num_slots
            ev = int(m[P.SM_EVICTED])
            desc = torch.full((budget, lm.DESC_BITS), -1, dtype=torch.int8, device=self.device)
            points = torch.zeros((budget, 3), dtype=torch.float32, device=self.device)
            rows = torch.zeros((budget,), dtype=torch.int32, device=self.device)
            valid = torch.zeros((budget,), dtype=torch.bool, device=self.device)
            if ev >= 0:
                mirror = self._db_maps[ev]
                if mirror is None:
                    raise KeyError(ev)
                m_desc, m_pos, m_rows, n = mirror
                desc[:n], points[:n], rows[:n], valid[:n] = (
                    m_desc[:n], m_pos[:n], m_rows[:n], True)
            db = P.db_write_slot(db, slot, desc, points, rows, valid, ev, next_fin, self.mesh)
        return carry._replace(
            graph=graph, db=db,
            edge_count=torch.full((), int(sm_i[P.SM_EDGES]), dtype=torch.int32,
                                  device=self.device),
            num_maps=torch.full((), int(sm_i[P.SM_NEW]) + 1, dtype=torch.int32,
                                device=self.device))

    def _ensure_chunk_capacity(self, graph: pgo.PoseGraph, num_maps: int,
                               num_edges: int) -> pgo.PoseGraph:
        """The pose graph grown (double-and-copy) before a split branch
        that would overflow it, as the per-frame path grows it: the split
        adds a pose at ``num_maps`` and an edge at ``num_edges``.  The
        counts are exact here (the branches run in order as the dispatch
        is consumed), so the graph grows when the per-frame one does; the
        new capacities give the split branch a new graph to capture."""
        pcap, ecap = graph.capacity, self._edge_capacity(graph)
        if num_maps >= pcap:
            pcap *= 2
        if num_edges >= ecap:
            ecap *= 2
        if (pcap, ecap) == (graph.capacity, self._edge_capacity(graph)):
            return graph
        return self._grow(graph, pcap, ecap)

    # ------------------------------------------------------------------
    # accessors (example_slam_3d.cpp:106-141 parity)
    # ------------------------------------------------------------------

    def robot_in_world(self) -> np.ndarray:
        T_world_lm = self.graph.poses[self.current_map].cpu().numpy()
        return T_world_lm @ self.tracker_state.T_lm_robot.cpu().numpy()

    def current_local_map(self) -> lm.LandmarkArena:
        return self.tracker_state.arena

    def trajectory(self) -> List[np.ndarray]:
        """Per-frame poses through the (PGO-updated) local-map estimates
        (app_benchmark.cpp:195-203)."""
        poses = self.graph.poses.cpu().numpy()
        return [poses[f.local_map_index] @ f.T_lm_robot for f in self.frames]

    def timestamps(self) -> List[float]:
        return [f.timestamp for f in self.frames]
