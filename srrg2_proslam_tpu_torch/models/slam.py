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
``chunk_size`` > 0): the stacks are uploaded once, ``chunk_size *
chunk_group`` frames at a time go through the batched adaptor (one FAST
and one BRIEF launch per chunk on the card), and each frame then goes
through the per-frame pipeline above.  The JAX package's fused chunk
program (models/chunk.py: the adaptor, tracker, status machine and split
pipeline as one device program per chunk, with rollback in the op) is not
carried over: its results are pinned to the per-frame loop, which this
mode runs; on the card its counterpart would be a CUDA graph of a chunk's
tracker steps.  ``chunk_lag`` has no effect.  The device mesh raises
NotImplementedError.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import pgo, se3
from ..ops.pinhole import Camera
from ..utils import config as cfg
from ..utils.profiling import profile_time
from . import landmarks as lm
from . import loop_closure
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
    machine (0: synchronous).  ``chunk_size * chunk_group``: frames per
    batched adaptor call of ``process_sequence`` (0: no sequence API).
    ``chunk_lag`` has no effect (the JAX package's chunk program queue).
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


def _check_graph_config(config: GraphSLAMConfig, model: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the device mesh is not ported yet")
    _check_supported(config.tracker, model)


class GraphSLAM:
    """Graph SLAM on one device.

    ``process(meas_points, meas_desc, meas_valid, timestamp)`` per frame,
    with the adaptor's tensors on ``device`` (or ``process_dispatch`` /
    ``process_finalize``, then ``flush``), or ``process_sequence`` over
    whole image stacks; read ``robot_in_world()``, ``trajectory()`` and
    ``status``.  ``device`` defaults to the card and raises without one.
    The stages carry the JAX package's ``profile_time`` scopes
    (utils/profiling.py): tracker_dispatch, status_readback, split,
    db_insert, loop_detect, closure_decision (the whole decision:
    agreement, backstop rounds and their PGO), pgo and reloc.

    ``num_reloc_rollbacks`` counts relocalisations that found frames
    dispatched behind the split (speculation) and ``num_reloc_replays``
    those frames, re-dispatched into the reloaded map; both stay 0 in the
    synchronous mode.  (In the JAX package's chunk program they count its
    device rollbacks and chunk replays.)  ``num_replayed_frames`` counts
    every re-dispatched frame, after splits and losses too: each runs its
    tracker step again.
    """

    def __init__(self, cam: Camera, config: GraphSLAMConfig = GraphSLAMConfig(),
                 model: str = "stereo", device=torch.device("cuda"), mesh=None):
        _check_graph_config(config, model, mesh)
        self.cam = cam
        self.config = config
        self.model = model
        self.device = torch.device(device)
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
            self.graph = pgo.grow(self.graph, 2 * self.graph.capacity,
                                  self.graph.edge_capacity)
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
        """Factor insertion with double-and-copy growth."""
        if self.num_edges >= self.graph.edge_capacity:
            self.graph = pgo.grow(self.graph, self.graph.capacity,
                                  2 * self.graph.edge_capacity)
        self.graph = pgo.add_edge(self.graph, self.num_edges, i, j, Z)
        self.num_edges += 1

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
                                             self.current_map, rows_b)

    def _loop_query(self, state: TrackerState, T_split: np.ndarray,
                    timestamp: float) -> _ClosureMarker:
        """loopDetect/loopValidate (app_benchmark.cpp:136-161): query the
        database with the finished map and validate its candidates; the
        decision packet is the one host read of the split."""
        arena = state.arena
        result, closures, packet = loop_closure.detect_and_validate(
            arena.desc, arena.valid, arena.pos, self.current_map, self.db,
            self.graph.poses, self.config.loop, self.graph.capacity)
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
        # pre_graph stays valid: pgo's functions return new tensors
        pre_graph, pre_edges = self.graph, self.num_edges

        def Z_of(k):
            return pkt[k, 6:22].reshape(4, 4).astype(np.float32)

        def insert_and_optimize(ks):
            for k in ks:
                self._add_graph_edge(int(pkt[k, 0]), m.query_map,
                                     torch.as_tensor(Z_of(k), device=self.device))
            with profile_time("pgo"):
                self.graph, _ = pgo.optimize(self.graph, self.config.pgo)

        thr = self.config.loop.backstop_max_edge_residual
        tol = self.config.loop.backstop_agreement_tolerance
        n_pre_agree = len(accepted)
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
        if thr > 0:
            # greedy outlier pruning: while a closure edge's own post-PGO
            # residual, or the held-out pre-existing factors' mean residual
            # worsening, exceeds the bound, drop the candidate with the
            # largest pre-insertion residual and re-optimize
            def held_out():
                # tracks the current edge capacity (insertion can grow it)
                return torch.arange(self.graph.edge_capacity, device=self.device) < pre_edges

            base_chain = float(pgo.mean_edge_residual(self.graph, held_out()))
            pre_r = {}
            for k in accepted:
                M = (np.linalg.inv(Z_of(k)) @ np.linalg.inv(poses_np[int(pkt[k, 0])])
                     @ poses_np[m.query_map])
                pre_r[k] = float(np.linalg.norm(M[:3, 3]))
            n_initial = len(accepted)
            for _ in range(n_initial + 1):
                self.graph, self.num_edges = pre_graph, pre_edges
                if not accepted:
                    break
                insert_and_optimize(accepted)
                # one read: every edge's residual and the held-out mean
                r = torch.cat([pgo.edge_t_residuals(self.graph),
                               pgo.mean_edge_residual(self.graph, held_out())[None]]
                              ).cpu().numpy()
                chain_bad = float(r[-1]) > base_chain + thr
                self_r = [r[pre_edges + j] for j in range(len(accepted))]
                if not chain_bad and max(self_r) <= thr:
                    break
                accepted.remove(max(accepted, key=lambda k: pre_r[k]))
            else:
                accepted = []  # budget exhausted while still inconsistent
                self.graph, self.num_edges = pre_graph, pre_edges
            n_rej = n_pre_agree - len(accepted)
            if n_rej > 0:
                self.num_backstop_rejections += n_rej
                print(f"[slam] closure backstop: rejected {n_rej} "
                      f"candidate(s) into map {m.query_map}")
            if not accepted:
                return None
        else:
            insert_and_optimize(accepted)
        best_k = max(accepted, key=lambda k: pkt[k, 2])
        for k in accepted:
            self.num_closures += 1
            self.closure_events.append((int(pkt[k, 0]), m.query_map))
        row = pkt[best_k]
        if self._reloc_gates(row):
            return best_k, int(row[0]), Z_of(best_k)
        return None

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
        g = self.graph
        pose_valid, edge_valid = g.pose_valid.clone(), g.edge_valid.clone()
        pose_valid[m.new_map] = False
        edge_valid[m.odo_edge_slot] = False
        self.graph = g._replace(pose_valid=pose_valid, edge_valid=edge_valid)
        merged = lm.merge_closure(
            self._get_map_arena(cand), m.query_state.arena, m.T_candidates[k],
            m.match_row[k], m.match_mask[k], self.config.closure_merge_max_insertions)
        self._map_arenas[cand] = merged
        self._note_device_arena(cand)
        buf = m.query_state.meas_buf
        if buf is not None:
            # the buffers belong to the abandoned query map: the reloaded
            # map starts with zeroed ones (T_world_to_cam slots 0, not
            # identity, as in the JAX package)
            buf = type(buf)(*(torch.zeros_like(t) for t in buf))
        T_new = (T_k @ m.T_split).astype(np.float32)
        self.tracker_state = TrackerState(
            arena=merged, T_lm_robot=torch.as_tensor(T_new, device=self.device),
            velocity=m.query_state.velocity, meas_buf=buf)
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
    # sequences
    # ------------------------------------------------------------------

    def process_sequence(self, a_all, b_all, timestamps, adaptor_config,
                         count: int = None):
        """Run a whole image sequence: ``a_all``/``b_all`` [T, H, W] stacks
        (left/right for stereo, intensity/raw depth for RGB-D), uploaded to
        the device once and adapted ``chunk_size * chunk_group`` frames at
        a time by the batched adaptor; equal frame for frame to the
        per-frame ``process`` loop."""
        T = int(count if count is not None else a_all.shape[0])
        self._run_sequence("images", (a_all, b_all), timestamps, T, adaptor_config)

    def process_meas_sequence(self, points_all, desc_all, valid_all, timestamps,
                              count: int = None):
        """``process_sequence`` over adapted measurement stacks [T, N, ...]."""
        T = int(count if count is not None else points_all.shape[0])
        self._run_sequence("meas", (points_all, desc_all, valid_all), timestamps, T)

    def _run_sequence(self, kind: str, stacks, timestamps, T: int, adaptor_config=None):
        B = self.config.chunk_size * max(1, self.config.chunk_group)   # frames per adaptor call
        if B <= 0:
            raise ValueError("sequence processing requires config.chunk_size > 0")
        if self.config.local_ba.enabled:
            raise ValueError("local_ba is per-frame-mode only, as in the JAX package "
                             "(its keyframe ring does not ride the chunk program)")
        if self._queue:
            raise RuntimeError("cannot mix per-frame and sequence processing: "
                               "flush() first")
        stacks = [torch.as_tensor(x)[:T].to(self.device) for x in stacks]
        ts = list(timestamps)
        ts += [float(len(ts) + i) for i in range(T - len(ts))]
        adapt = adapt_stereo_batch if self.model == "stereo" else adapt_rgbd_batch
        for start in range(0, T, B):
            chunk = [x[start:start + B] for x in stacks]
            if kind == "images":
                chunk = adapt(*chunk, adaptor_config)
            for i in range(chunk[0].shape[0]):
                self.process_dispatch(*(x[i] for x in chunk), ts[start + i])
                self.process_finalize()
        self.flush()

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
