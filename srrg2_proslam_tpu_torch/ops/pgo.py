"""SE(3) pose-graph optimization (PGO) as a batched Gauss-Newton.

Port of srrg2_proslam_tpu/ops/pgo.py.  The factor graph is a fixed-capacity
edge array (i, j, Z_ij, weight, mask); the residuals and adjoint Jacobians
of all factors are evaluated in one batch (e = log(Z^-1 T_i^-1 T_j),
J_j = Ad(Z^-1 T_i^-1), J_i = -J_j), and the normal equations are
scatter-added into a dense [6N, 6N] system or solved matrix-free by
block-Jacobi preconditioned CG.  Gauge freedom is fixed by a prior on
pose 0.

Every function returns new tensors and never writes into its inputs: the
orchestrator keeps old graphs (the backstop reverts to one).  Scatter-adds
at repeated indices use ``index_add``, whose sum order on CUDA varies from
run to run; only a float tolerance holds across devices.  No function
reads a value back to the host.

On a mesh (``mesh``: parallel/spmd.py) the edge arrays are sharded along
edges, the rank holding a contiguous block, and poses are replicated:
each rank builds the partial normal equations of its edges, a SUM
all-reduce combines H, b and chi, and the gauge prior is added once,
after the reduce; the dense solve is replicated.  The CG solver reduces
its block-Jacobi blocks once and each matvec product, so every rank takes
the same iterations.  Edge slots are global: ``add_edge`` writes on the
slot's owner, and the residual statistics gather every edge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils import config as cfg
from . import se3


@cfg.register
@dataclass(frozen=True)
class PGOConfig:
    """Same fields and defaults as the JAX package's PGOConfig."""

    iterations: int = 10
    damping: float = 1e-3
    chi_threshold: float = 25.0     # RobustifierSaturated policy
    anchor_weight: float = 1e6      # gauge prior on pose 0
    solver: str = "dense"           # "dense" or matrix-free "cg"
    cg_iterations: int = 100
    cg_tolerance: float = 1e-6
    max_step: float = 1.0           # per-pose twist clamp per GN step


class PoseGraph(NamedTuple):
    """Fixed-capacity SE3 pose graph; Z = measured T_i^-1 T_j."""

    poses: torch.Tensor         # [N, 4, 4] world_from_localmap
    pose_valid: torch.Tensor    # [N] bool
    edge_i: torch.Tensor        # [E] int64
    edge_j: torch.Tensor        # [E] int64
    edge_Z: torch.Tensor        # [E, 4, 4]
    edge_weight: torch.Tensor   # [E] float32 information scale
    edge_valid: torch.Tensor    # [E] bool

    @property
    def capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def _eye_stack(n: int, device) -> torch.Tensor:
    # a real [n, 4, 4] tensor, not an expand() view: callers write rows of it
    return torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1)


def empty_graph(num_poses: int, num_edges: int,
                device=torch.device("cuda")) -> PoseGraph:
    return PoseGraph(
        poses=_eye_stack(num_poses, device),
        pose_valid=torch.zeros((num_poses,), dtype=torch.bool, device=device),
        edge_i=torch.zeros((num_edges,), dtype=torch.int64, device=device),
        edge_j=torch.zeros((num_edges,), dtype=torch.int64, device=device),
        edge_Z=_eye_stack(num_edges, device),
        edge_weight=torch.zeros((num_edges,), dtype=torch.float32, device=device),
        edge_valid=torch.zeros((num_edges,), dtype=torch.bool, device=device),
    )


def graph_from_numpy(d: dict, device=torch.device("cuda")) -> PoseGraph:
    """A PoseGraph from numpy arrays keyed by the JAX PoseGraph's fields."""
    t = {k: torch.tensor(np.asarray(d[k]), device=device) for k in PoseGraph._fields}
    return PoseGraph(
        poses=t["poses"].to(torch.float32), pose_valid=t["pose_valid"].to(torch.bool),
        edge_i=t["edge_i"].to(torch.int64), edge_j=t["edge_j"].to(torch.int64),
        edge_Z=t["edge_Z"].to(torch.float32),
        edge_weight=t["edge_weight"].to(torch.float32),
        edge_valid=t["edge_valid"].to(torch.bool))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [v, w]: [[R, [t]x R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, se3.skew(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def factor_terms(poses: torch.Tensor, graph: PoseGraph, chi_threshold: float):
    """Batched residuals + adjoint Jacobians for all edges.

    Returns (e [E,6], A [E,6,6], w [E], chi [E]) with A = Ad(Z^-1 T_i^-1);
    the robust weight folds the saturated kernel and the edge information.
    """
    Ti = poses[graph.edge_i]
    Tj = poses[graph.edge_j]
    ZiTi = se3.inverse(graph.edge_Z) @ se3.inverse(Ti)
    e = se3.log(ZiTi @ Tj)
    A = adjoint(ZiTi)
    chi = torch.sum(e * e, dim=-1) * graph.edge_weight
    kw = torch.clamp_max(chi_threshold / torch.clamp_min(chi, 1e-12), 1.0)
    w = torch.where(graph.edge_valid, graph.edge_weight * kw, 0.0)
    return e, A, w, chi


def _edge_blocks(poses, graph: PoseGraph, chi_threshold: float):
    """Per-edge weighted blocks AtA [E,6,6], Ate [E,6] and the robust chi sum
    (shared by the dense and CG paths)."""
    e, A, w, chi = factor_terms(poses, graph, chi_threshold)
    AtA = torch.einsum("eki,ekj,e->eij", A, A, w)
    Ate = torch.einsum("eki,ek,e->ei", A, e, w)
    chi_total = torch.where(graph.edge_valid, torch.clamp_max(chi, chi_threshold), 0.0).sum()
    return AtA, Ate, chi_total


def _prior_diag(graph: PoseGraph, anchor_weight: float):
    """Gauge anchor on pose 0 + a unit prior on invalid poses (keeps H SPD)."""
    N = graph.capacity
    first = torch.arange(N, device=graph.poses.device) == 0
    return torch.where(first, anchor_weight,
                       torch.where(graph.pose_valid, 0.0, 1.0))


def _gradient(graph: PoseGraph, Ate: torch.Tensor) -> torch.Tensor:
    """b [N, 6]: +Ate at each edge's j, -Ate at its i (repeated indices add)."""
    b = torch.zeros((graph.capacity, 6), dtype=torch.float32, device=Ate.device)
    return b.index_add(0, graph.edge_j, Ate).index_add(0, graph.edge_i, -Ate)


def normal_equations(poses: torch.Tensor, graph: PoseGraph,
                     chi_threshold: float, anchor_weight: float, mesh=None):
    """The dense GN system as blocks H [N, N, 6, 6], b [N, 6], and chi."""
    N = graph.capacity
    dev = poses.device
    AtA, Ate, chi_total = _edge_blocks(poses, graph, chi_threshold)
    i, j = graph.edge_i, graph.edge_j
    if mesh is not None:
        # the rank's edges, reduced; the prior once, after the reduce
        H = torch.zeros((N * N, 6, 6), dtype=torch.float32, device=dev).index_add_(
            0, torch.cat([i * N + i, j * N + j, i * N + j, j * N + i]),
            torch.cat([AtA, AtA, -AtA, -AtA]))
        H = mesh.all_sum(H, "pgo")
        diag = torch.arange(N, device=dev) * (N + 1)
        prior = _prior_diag(graph, anchor_weight)
        H[diag] += prior[:, None, None] * torch.eye(6, device=dev)
        return (H.reshape(N, N, 6, 6), mesh.all_sum(_gradient(graph, Ate), "pgo"),
                mesh.all_sum(chi_total, "pgo"))
    # one index_add over the N*N blocks: H_ii, H_jj += AtA, H_ij, H_ji -=
    # AtA, and the prior on the diagonal (index_put_ with accumulate takes a
    # sort-based path on CUDA, ~2 ms per call at N = 512)
    diag = torch.arange(N, device=dev) * (N + 1)
    prior = _prior_diag(graph, anchor_weight)
    H = torch.zeros((N * N, 6, 6), dtype=torch.float32, device=dev).index_add_(
        0, torch.cat([i * N + i, j * N + j, i * N + j, j * N + i, diag]),
        torch.cat([AtA, AtA, -AtA, -AtA,
                   prior[:, None, None] * torch.eye(6, device=dev)]))
    return H.reshape(N, N, 6, 6), _gradient(graph, Ate), chi_total


def _solve_cg(graph: PoseGraph, AtA, b, prior, damping: float,
              iterations: int, tolerance: float, mesh=None):
    """Matrix-free block-Jacobi preconditioned CG.

    The JAX package exits early once |r|^2 <= tol^2 |b|^2; here every one of
    ``iterations`` runs, and an iteration after convergence changes nothing
    (a sticky live mask, no host read).  On a mesh ``AtA`` holds the
    rank's edges and ``b`` is reduced already.
    """
    reduce = (lambda t: t) if mesh is None else (lambda t: mesh.all_sum(t, "pgo"))
    N = graph.capacity
    i_idx, j_idx = graph.edge_i, graph.edge_j
    dev = b.device
    reg = prior + damping

    def matvec(x):
        t = torch.einsum("eij,ej->ei", AtA, x[i_idx] - x[j_idx])
        y = torch.zeros((N, 6), dtype=torch.float32, device=dev)
        y = y.index_add(0, i_idx, t).index_add(0, j_idx, -t)
        return reduce(y) + reg[:, None] * x

    D = torch.zeros((N, 6, 6), dtype=torch.float32, device=dev)
    D = reduce(D.index_add(0, i_idx, AtA).index_add(0, j_idx, AtA))
    D = D + reg[:, None, None] * torch.eye(6, device=dev)
    D_inv = torch.linalg.inv_ex(D)[0]    # no error check: nothing read back

    def precond(r):
        return torch.einsum("nij,nj->ni", D_inv, r)

    x = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    limit = tolerance * tolerance * torch.clamp_min(torch.sum(b * b), 1e-30)
    for _ in range(iterations):
        live = torch.sum(r * r) > limit
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom.abs() < 1e-30, 0.0, rz / denom)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = torch.where(rz > 1e-30, rz_n / rz, 0.0)
        p_n = z + beta * p
        x = torch.where(live, x_n, x)
        r = torch.where(live, r_n, r)
        p = torch.where(live, p_n, p)
        rz = torch.where(live, rz_n, rz)
    return x


def optimize(graph: PoseGraph, config: PGOConfig, mesh=None):
    """Run ``config.iterations`` GN steps; returns (graph', chi_final)."""
    if config.solver not in ("dense", "cg"):
        raise ValueError(f"PGOConfig.solver must be 'dense' or 'cg', got {config.solver!r}")
    N = graph.capacity
    dev = graph.poses.device

    def dense_step(poses):
        H, b, chi = normal_equations(poses, graph, config.chi_threshold,
                                     config.anchor_weight, mesh)
        Hd = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        Hd = Hd + config.damping * torch.eye(6 * N, device=dev)
        # symmetric Jacobi scaling: the anchor prior plus a long chain make
        # cond(H) exceed float32 otherwise
        s = torch.rsqrt(torch.clamp_min(torch.diagonal(Hd), 1e-12))
        Hs = Hd * s[:, None] * s[None, :]
        sol, _ = torch.linalg.solve_ex(Hs, s * b.reshape(-1))
        return -(s * sol).reshape(N, 6), chi

    def cg_step(poses):
        AtA, Ate, chi = _edge_blocks(poses, graph, config.chi_threshold)
        prior = _prior_diag(graph, config.anchor_weight)
        b = -_gradient(graph, Ate)
        if mesh is not None:
            b, chi = mesh.all_sum(b, "pgo"), mesh.all_sum(chi, "pgo")
        dx = _solve_cg(graph, AtA, b, prior, config.damping,
                       config.cg_iterations, config.cg_tolerance, mesh)
        return dx, chi

    step = cg_step if config.solver == "cg" else dense_step
    poses = graph.poses
    chi = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(config.iterations):
        dx, chi = step(poses)
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        # trust region: clamp each pose's twist to max_step on its own
        norms = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
        dx = dx * torch.clamp_max(config.max_step / torch.clamp_min(norms, 1e-12), 1.0)
        poses = se3.exp(dx) @ poses
    return graph._replace(poses=poses), chi


def edge_t_residuals(graph: PoseGraph, mesh=None) -> torch.Tensor:
    """Per-factor translational residual (meters) at the current poses, [E]
    (every edge, gathered on a mesh): the closure backstop's statistic."""
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    M = se3.inverse(graph.edge_Z) @ se3.inverse(Ti) @ Tj
    t_err = torch.linalg.vector_norm(M[..., :3, 3], dim=-1)
    return t_err if mesh is None else mesh.all_gather(t_err, "pgo")


def mean_edge_residual(graph: PoseGraph, edge_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean translational factor residual (meters) over masked valid edges
    (``edge_mask`` over every edge; on a mesh the sum runs over the gathered
    edges in the single-device order)."""
    t_err = edge_t_residuals(graph, mesh)
    valid = graph.edge_valid if mesh is None else mesh.all_gather(graph.edge_valid, "pgo")
    w = valid & edge_mask
    return torch.where(w, t_err, 0.0).sum() / torch.clamp_min(w.sum(), 1)


def grow(graph: PoseGraph, pose_capacity: int, edge_capacity: int) -> PoseGraph:
    """A copy with enlarged capacities (double-and-copy)."""
    n_old, e_old = graph.capacity, graph.edge_capacity
    n_new = max(pose_capacity, n_old)
    e_new = max(edge_capacity, e_old)
    if n_new == n_old and e_new == e_old:
        return graph
    out = empty_graph(n_new, e_new, graph.poses.device)
    for name, old in graph._asdict().items():
        getattr(out, name)[:old.shape[0]] = old
    return out


def _set(t: torch.Tensor, index, value) -> torch.Tensor:
    out = t.clone()
    out[index] = value
    return out


def add_pose(graph: PoseGraph, index, T: torch.Tensor) -> PoseGraph:
    return graph._replace(poses=_set(graph.poses, index, T),
                          pose_valid=_set(graph.pose_valid, index, True))


def add_edge(graph: PoseGraph, slot, i, j, Z: torch.Tensor,
             weight: float = 1.0, mesh=None) -> PoseGraph:
    """Factor ``i -> j`` at edge slot ``slot`` (an int; on a mesh the slot is
    global and only its owner writes)."""
    if mesh is not None:
        per = graph.edge_capacity
        if slot // per != mesh.rank:
            return graph
        slot = slot % per
    return graph._replace(
        edge_i=_set(graph.edge_i, slot, i),
        edge_j=_set(graph.edge_j, slot, j),
        edge_Z=_set(graph.edge_Z, slot, Z),
        edge_weight=_set(graph.edge_weight, slot, weight),
        edge_valid=_set(graph.edge_valid, slot, True),
    )
