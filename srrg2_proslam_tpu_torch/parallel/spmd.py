"""Sharded SLAM stages over a 1-D mesh of torch.distributed ranks.

Port of srrg2_proslam_tpu/parallel/spmd.py.  The JAX package annotates
shardings and lets XLA insert the collectives; here one process runs per
rank, a rank holds its shard as an ordinary tensor, and each collective is
an explicit call of the ``Mesh`` below, placed where the JAX docstrings say
XLA puts it:

  * frame step (``slam_step_spmd``): measurement rows and arena rows are
    placed in shards; the association's Hamming cost is computed on the
    rank's measurement rows against the gathered arena columns, the
    column-side mutual argmin is one packed-key MIN all-reduce and the
    adaptive stage's match counts one SUM; the matches are all-gathered and
    the rest of the step (the GN bursts, K2 on a CUDA tensor, the merge
    and the binned insertion) runs replicated; the rank keeps its arena
    shard.  The result equals the single-device ``track_step``.
  * loop query (``loop_query_spmd``): the slotted ring striped along its
    budget axis; each rank's per-slot two-best keys carry the global flat
    row, two MIN all-reduces merge them, the votes follow from the merged
    distances, and the matched rows are gathered by owner
    (models/loop_closure.py).
  * PGO (``pgo_optimize_spmd``): factor arrays sharded along edges; the
    partial normal equations (or each CG product) are SUM-reduced, the
    gauge prior added once after the reduce, the dense solve replicated
    (ops/pgo.py).
  * BA (``ba_optimize_spmd``): observations sharded; the partial block
    systems are SUM-reduced, poses, points and the reduced camera solve
    replicated (ops/ba.py).

``Mesh`` carries the process group, the rank, the size, the rank's device
and the backend, and counts its collectives and bytes by stage.  On the
gloo backend a CUDA tensor is staged through host memory for every call
(a fixed property of the backend, not a fallback): gloo reduces on the
host, and ranks that share one card cannot use NCCL.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..models import loop_closure
from ..models.tracker import TrackerConfig, TrackerState, track_step
from ..ops import ba as ba_ops
from ..ops import pgo as pgo_ops
from ..ops.pinhole import Camera
from ..utils.graphs import tree_map


@dataclass
class Mesh:
    """A 1-D mesh of ``size`` ranks named ``axis``; this process is ``rank``
    on ``device``.  ``collectives`` counts calls and bytes per stage tag."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    axis: str = "d"
    collectives: dict = field(default_factory=dict)

    def _count(self, tag: str, t: torch.Tensor) -> None:
        calls, nbytes = self.collectives.get(tag, (0, 0))
        self.collectives[tag] = (calls + 1, nbytes + t.numel() * t.element_size())

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective runs on: a host copy of a CUDA tensor on
        gloo, else a contiguous copy; bool travels as uint8."""
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        return t.clone(memory_format=torch.contiguous_format)

    def _reduce(self, t: torch.Tensor, op, tag: str) -> torch.Tensor:
        self._count(tag, t)
        buf = self._staged(t)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device, t.dtype)

    def all_sum(self, t: torch.Tensor, tag: str = "other") -> torch.Tensor:
        """SUM over ranks (bool and integer sums as int32 / int64)."""
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        return self._reduce(t, dist.ReduceOp.SUM, tag)

    def all_min(self, t: torch.Tensor, tag: str = "other") -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN, tag)

    def all_gather(self, t: torch.Tensor, tag: str = "other", dim: int = 0) -> torch.Tensor:
        """The ranks' shards concatenated along ``dim`` in rank order."""
        self._count(tag, t)
        buf = self._staged(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(t.device, t.dtype)

    def gather_by_owner(self, values: torch.Tensor, owned: torch.Tensor,
                        tag: str = "other") -> torch.Tensor:
        """Each rank fills the entries it owns (``owned``, broadcast against
        ``values``) and zeros elsewhere; the SUM is exact, one term being
        non-zero."""
        while owned.dim() < values.dim():
            owned = owned[..., None]
        mine = torch.where(owned, values, torch.zeros((), dtype=values.dtype,
                                                      device=values.device))
        if values.dtype == torch.bool:
            return self.all_sum(mine, tag) > 0
        return self.all_sum(mine, tag)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def backend_for(world_size: int, device) -> str:
    """NCCL when every rank has a card of its own, gloo when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)``, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return device


def make_mesh(devices=None, axis: str = "d", group=None) -> Mesh:
    """The 1-D mesh over the initialised process group (parallel/multihost.py
    or parallel/launch.py); ``devices`` lists one device per rank (default:
    rank r on ``cuda:(r % device_count)``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize or parallel.launch.run)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    device = rank_device(rank) if devices is None else torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank=rank, size=size, device=device, backend=dist.get_backend(group),
                group=group, axis=axis)


# ---------------------------------------------------------------------------
# placement: a rank's shard of a global tensor, and back
# ---------------------------------------------------------------------------

def shard(t: torch.Tensor, mesh: Mesh, dim: int = 0, what: str = "axis") -> torch.Tensor:
    """The rank's contiguous block of ``t`` along ``dim`` (a copy)."""
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) must be divisible by the mesh size ({mesh.size})")
    k = n // mesh.size
    return t.narrow(dim, mesh.rank * k, k).clone()


def shard_database(db: loop_closure.DescriptorDatabase,
                   mesh: Mesh) -> loop_closure.DescriptorDatabase:
    """The ring striped along its budget axis; map ids and cursor replicated."""
    what = "max_db_descriptors_per_map"
    return db._replace(desc=shard(db.desc, mesh, 1, what), points=shard(db.points, mesh, 1, what),
                       arena_row=shard(db.arena_row, mesh, 1, what),
                       valid=shard(db.valid, mesh, 1, what))


def gather_database(db: loop_closure.DescriptorDatabase,
                    mesh: Mesh) -> loop_closure.DescriptorDatabase:
    return db._replace(**{k: mesh.all_gather(getattr(db, k), "gather", dim=1)
                          for k in ("desc", "points", "arena_row", "valid")})


_EDGE_FIELDS = ("edge_i", "edge_j", "edge_Z", "edge_weight", "edge_valid")


def shard_graph(graph: pgo_ops.PoseGraph, mesh: Mesh) -> pgo_ops.PoseGraph:
    """Factor arrays sharded along edges; poses replicated."""
    return graph._replace(**{k: shard(getattr(graph, k), mesh, 0, "max_edges")
                             for k in _EDGE_FIELDS})


def gather_graph(graph: pgo_ops.PoseGraph, mesh: Mesh) -> pgo_ops.PoseGraph:
    return graph._replace(**{k: mesh.all_gather(getattr(graph, k), "gather")
                             for k in _EDGE_FIELDS})


def shard_state(state: TrackerState, mesh: Mesh) -> TrackerState:
    """Arena (and smoother buffer) rows sharded; pose and velocity replicated."""
    return state._replace(
        arena=tree_map(lambda t: shard(t, mesh, 0, "arena capacity"), state.arena),
        meas_buf=tree_map(lambda t: shard(t, mesh, 0, "arena capacity"), state.meas_buf))


def gather_state(state: TrackerState, mesh: Mesh) -> TrackerState:
    return state._replace(
        arena=tree_map(lambda t: mesh.all_gather(t, "tracker"), state.arena),
        meas_buf=tree_map(lambda t: mesh.all_gather(t, "tracker"), state.meas_buf))


# ---------------------------------------------------------------------------
# the sharded stages
# ---------------------------------------------------------------------------

def shard_frame_inputs(mesh: Mesh, state: TrackerState, points, desc, valid):
    """Place a frame's inputs in shards: measurement rows along the keypoint
    axis, the arena (and the smoother's buffers) along the landmark axis;
    pose and velocity replicated.  Both capacities must divide the mesh
    size.  Returns the rank's (state, points, desc, valid)."""
    def rows(t):
        return shard(t.to(mesh.device), mesh, 0, "measurement rows")

    return shard_state(state.to(mesh.device), mesh), rows(points), rows(desc), rows(valid)


def slam_step_spmd(mesh: Mesh, state: TrackerState, points, desc, valid, cam: Camera,
                   config: TrackerConfig, model: str = "stereo"):
    """One sharded tracker step from a global frame and state: returns (the
    rank's shard of the new state, stats, X), equal to the single-device
    ``track_step`` (its stats and X replicated)."""
    st, p, d, v = shard_frame_inputs(mesh, state, points, desc, valid)
    full = gather_state(st, mesh)
    p, d, v = (mesh.all_gather(t, "tracker") for t in (p, d, v))
    new_state, stats, X = track_step(full, p, d, v, cam, config, model, mesh=mesh)
    return shard_state(new_state, mesh), stats, X


def pgo_optimize_spmd(mesh: Mesh, graph: pgo_ops.PoseGraph, config: pgo_ops.PGOConfig):
    """Factor-sharded pose-graph optimisation of a global graph: returns
    (the optimised graph with the rank's edges, chi)."""
    graph = pgo_ops.PoseGraph(*(t.to(mesh.device) for t in graph))
    return pgo_ops.optimize(shard_graph(graph, mesh), config, mesh=mesh)


def ba_optimize_spmd(mesh: Mesh, problem: ba_ops.BAProblem, cam: Camera, model: str,
                     config: ba_ops.BAConfig):
    """Observation-sharded bundle adjustment of a global problem: returns
    (the problem with replicated poses and points and the rank's
    observations, chi)."""
    problem = ba_ops.BAProblem(*(t.to(mesh.device) for t in problem))
    obs = {k: shard(getattr(problem, k), mesh, 0, "observations")
           for k in ("obs_kf", "obs_lm", "obs_z", "obs_valid")}
    return ba_ops.optimize(problem._replace(**obs), cam, model, config, mesh=mesh)


def loop_query_spmd(mesh: Mesh, query_desc, query_valid, query_map_id,
                    db: loop_closure.DescriptorDatabase,
                    config: loop_closure.LoopDetectorConfig, num_maps: int = None):
    """Budget-striped loop query of a global ring (replicated result)."""
    db = loop_closure.DescriptorDatabase(*(t.to(mesh.device) for t in db))
    return loop_closure.query(query_desc.to(mesh.device), query_valid.to(mesh.device),
                              query_map_id, shard_database(db, mesh), config, num_maps,
                              mesh=mesh)

