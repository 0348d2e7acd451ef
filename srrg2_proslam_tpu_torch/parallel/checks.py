"""Rank programs of the multi-GPU slice and the checks that hold them.

``entry.dryrun_multichip``, the CPU tests and ``chip_smoke.py`` start these
through ``parallel/launch.py``: each is a function of the rank's ``Mesh``
that a spawned process imports by name, so this module imports torch and
numpy only (a rank must not load JAX).

* ``dryrun_rank``: every sharded stage of parallel/spmd.py on small
  shapes built from numpy seeds (the tracker step, the budget-striped
  ring query, PGO with the dense and the CG solver, BA structure-only and
  joint), each beside its single-rank call on the same rank, and a short
  meshed GraphSLAM through the chunk program beside the unmeshed one;
  ``check_stages`` holds them: query keys, matches, candidates and counts
  bit for bit, floats within ``FLOAT_TOL``, the solvers' chi within
  ``CHI_RTOL``.
* ``slam_run``: a GraphSLAM session over a measurement stream or the
  rendered loop, meshed or not, per frame or through the chunk program;
  it reports what the comparisons need (per-frame status and map,
  counters, closure events, the trajectory, launches, collectives, times).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import profiling

FLOAT_TOL = 1e-5       # a sharded stage against its single-rank call
# a solver's chi (a sum of squared residuals near its minimum) against the
# single-rank call, relative: the float32 rounding of each pixel coordinate
# (ulp 6e-5 px at u ~ 600) moves each squared residual by ~1e-5 px^2
CHI_RTOL = 1e-3
SLAM_POSE_TOL = 1e-4   # a meshed GraphSLAM against the unmeshed one (m)


# ---------------------------------------------------------------------------
# inputs, from numpy seeds
# ---------------------------------------------------------------------------

def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64)
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def _pose(w, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rodrigues(np.asarray(w, np.float64))
    T[:3, 3] = t
    return T


def ring_arrays(budget: int, slots: int = 4, seed: int = 1) -> dict:
    """A ring of ``slots`` x ``budget`` holding maps 0-2 (two near copies of
    the query's descriptors and a far one, 10 % of rows invalid; map 0 has
    four duplicated rows, whose tied keys the row breaks) and a query."""
    rng = np.random.RandomState(seed)
    base = rng.choice(np.array([-1, 1], np.int8), size=(budget, 256))
    d = dict(desc=np.full((slots, budget, 256), -1, np.int8),
             points=np.zeros((slots, budget, 3), np.float32),
             arena_row=np.zeros((slots, budget), np.int32),
             valid=np.zeros((slots, budget), bool),
             map_id=np.full((slots,), -1, np.int32), next=np.int32(3))
    for s, flip in enumerate((0.03, 0.08, 0.3)):
        desc = base.copy()
        desc[rng.rand(budget, 256) < flip] *= -1
        d["desc"][s] = desc
        d["points"][s] = rng.normal(0, 5, (budget, 3))
        d["arena_row"][s] = rng.permutation(2 * budget)[:budget]
        d["valid"][s] = rng.rand(budget) > 0.1
        d["map_id"][s] = s
    d["desc"][0, budget // 2:budget // 2 + 4] = d["desc"][0, :4]
    query = base.copy()
    query[rng.rand(budget, 256) < 0.02] *= -1
    return dict(db=d, query_desc=query, query_valid=rng.rand(budget) > 0.05, query_map=5)


def pgo_arrays(n_edges: int, n_poses: int = 8, seed: int = 2) -> dict:
    """A drifted ring of ``n_poses`` poses with noisy odometry and one loop
    factor (``n_poses`` valid edges) in a graph of ``n_edges`` edge slots."""
    rng = np.random.RandomState(seed)
    true = [_pose([0, 0, 2 * np.pi * k / n_poses],
                  [4 * np.cos(2 * np.pi * k / n_poses), 4 * np.sin(2 * np.pi * k / n_poses), 0])
            for k in range(n_poses)]
    pairs = [(k, k + 1) for k in range(n_poses - 1)] + [(n_poses - 1, 0)]
    poses = np.tile(np.eye(4), (n_poses, 1, 1))
    drift = np.eye(4)
    for k in range(n_poses):
        poses[k] = true[k] @ drift
        drift = drift @ _pose(rng.normal(0, 0.02, 3), rng.normal(0, 0.05, 3))
    g = dict(poses=poses.astype(np.float32), pose_valid=np.ones(n_poses, bool),
             edge_i=np.zeros(n_edges, np.int64), edge_j=np.zeros(n_edges, np.int64),
             edge_Z=np.tile(np.eye(4, dtype=np.float32), (n_edges, 1, 1)),
             edge_weight=np.zeros(n_edges, np.float32), edge_valid=np.zeros(n_edges, bool))
    for e, (i, j) in enumerate(pairs):
        Z = np.linalg.inv(true[i]) @ true[j] @ _pose(rng.normal(0, 0.01, 3),
                                                     rng.normal(0, 0.02, 3))
        g["edge_i"][e], g["edge_j"][e], g["edge_Z"][e] = i, j, Z
        g["edge_weight"][e], g["edge_valid"][e] = 1.0, True
    return g


def ba_arrays(cam, n_pts: int, seed: int = 3) -> dict:
    """Two keyframes 0.5 m apart observing ``n_pts`` points (exact stereo
    projections; the points start 5 cm off, a few observations invalid)."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-5, 5, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(5, 20, n_pts)], 1).astype(np.float32)
    poses = np.stack([np.eye(4), _pose([0, 0.02, 0], [0.5, 0, 0])]).astype(np.float32)
    obs_kf = np.repeat(np.arange(2, dtype=np.int32), n_pts)
    obs_lm = np.tile(np.arange(n_pts, dtype=np.int32), 2)
    p_c = np.einsum("oij,oj->oi", np.linalg.inv(poses)[obs_kf][:, :3, :3], pts[obs_lm]) \
        + np.linalg.inv(poses)[obs_kf][:, :3, 3]
    z = np.zeros((2 * n_pts, 3), np.float32)
    z[:, 0] = cam.fx * p_c[:, 0] / p_c[:, 2] + cam.cx
    z[:, 1] = cam.fy * p_c[:, 1] / p_c[:, 2] + cam.cy
    z[:, 2] = z[:, 0] - cam.baseline_px / p_c[:, 2]
    return dict(poses=poses, pose_valid=np.ones(2, bool),
                points=(pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
                point_valid=np.ones(n_pts, bool), obs_kf=obs_kf, obs_lm=obs_lm, obs_z=z,
                obs_valid=rng.rand(2 * n_pts) > 0.05)


def stage_sizes(n: int) -> dict:
    """The dry run's shapes for ``n`` ranks (the JAX dry run's, and a PGO
    graph with free edge slots on several ranks)."""
    return dict(n_meas=16 * n, capacity=32 * n, budget=32 * n, n_edges=-(-10 // n) * n,
                n_pts=8 * n)


# ---------------------------------------------------------------------------
# the dry run's rank program
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def stages(mesh, sizes: dict) -> dict:
    """Each sharded stage and its single-rank call on this rank's device:
    {stage: {"single": {...}, "sharded": {...}}} of numpy values."""
    from ..io.datasets import kitti_camera
    from ..models import loop_closure as lc
    from ..models.tracker import TrackerConfig, track_step
    from ..ops import ba, pgo
    from ..entry import _synthetic_frame
    from . import spmd

    dev = mesh.device
    cam = kitti_camera()
    out = {}

    state, points, desc, valid = _synthetic_frame(sizes["n_meas"], sizes["capacity"], cam,
                                                  device=dev)
    tcfg = TrackerConfig()

    def tracker(st, stats, X):
        return dict(X=_np(X), T=_np(st.T_lm_robot), pos=_np(st.arena.pos),
                    valid=_np(st.arena.valid), num_updates=_np(st.arena.num_updates),
                    match_idx=_np(stats.match_idx), match_mask=_np(stats.match_mask),
                    packet=_np(stats.host_packet), num_inliers=int(stats.num_inliers),
                    num_matches=int(stats.num_matches))

    single = tracker(*track_step(state, points, desc, valid, cam, tcfg, "stereo"))
    st, stats, X = spmd.slam_step_spmd(mesh, state, points, desc, valid, cam, tcfg, "stereo")
    out["tracker"] = dict(single=single,
                          sharded=tracker(spmd.gather_state(st, mesh), stats, X))

    ring = ring_arrays(sizes["budget"])
    db = lc.database_from_numpy(ring["db"], dev)
    qd = torch.from_numpy(ring["query_desc"]).to(dev)
    qv = torch.from_numpy(ring["query_valid"]).to(dev)
    lcfg = lc.LoopDetectorConfig(minimum_age_difference=1)

    def query(res):
        return {k: _np(v) for k, v in res._asdict().items()}

    out["ring"] = dict(single=query(lc.query(qd, qv, ring["query_map"], db, lcfg, 4)),
                       sharded=query(spmd.loop_query_spmd(mesh, qd, qv, ring["query_map"],
                                                          db, lcfg, 4)))

    graph = pgo.graph_from_numpy(pgo_arrays(sizes["n_edges"]), dev)
    for name, solver in (("pgo", "dense"), ("pgo_cg", "cg")):
        pcfg = pgo.PGOConfig(solver=solver)
        g1, chi1 = pgo.optimize(graph, pcfg)
        g2, chi2 = spmd.pgo_optimize_spmd(mesh, graph, pcfg)
        out[name] = dict(single=dict(poses=_np(g1.poses), chi=float(chi1)),
                         sharded=dict(poses=_np(g2.poses), chi=float(chi2)))

    prob = ba.BAProblem(**{k: torch.from_numpy(v).to(dev)
                           for k, v in ba_arrays(cam, sizes["n_pts"]).items()})
    for name, structure_only in (("ba", True), ("ba_joint", False)):
        bcfg = ba.BAConfig(iterations=2, structure_only=structure_only)
        p1, chi1 = ba.optimize(prob, cam, "stereo", bcfg)
        p2, chi2 = spmd.ba_optimize_spmd(mesh, prob, cam, "stereo", bcfg)
        out[name] = dict(single=dict(poses=_np(p1.poses), points=_np(p1.points),
                                     chi=float(chi1)),
                         sharded=dict(poses=_np(p2.poses), points=_np(p2.points),
                                      chi=float(chi2)))
    return out


def dryrun_rank(mesh) -> dict:
    """The dry run on one rank: ``stages`` at ``stage_sizes(mesh.size)`` and
    a short meshed GraphSLAM through the chunk program (the JAX dry run's
    config and 8 synthetic frames) beside the unmeshed one."""
    from ..entry import synthetic_arrays
    from ..io.datasets import kitti_camera
    from ..models.loop_closure import LoopDetectorConfig
    from ..models.slam import GraphSLAMConfig, SplittingConfig

    n = mesh.size
    report = stages(mesh, stage_sizes(n))
    report["collectives"] = dict(mesh.collectives)
    cam = kitti_camera()
    frames = [synthetic_arrays(16 * n, 32 * n, cam, seed=s)[1:] for s in range(8)]
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=1.2),
        loop=LoopDetectorConfig(minimum_age_difference=1),
        arena_capacity=32 * n, database_capacity=64 * n,
        max_db_descriptors_per_map=8 * n, max_edges=128 * n, chunk_size=4)
    spec = dict(cam=cam, config=config, mode="sequence",
                frames=("meas",) + tuple(np.stack([f[k] for f in frames]) for k in range(3))
                + ([0.1 * i for i in range(8)],))
    meshed = slam_run(mesh, dict(spec, meshed=True))
    plain = slam_run(mesh, dict(spec, meshed=False))
    report["slam"] = dict(meshed=meshed, plain=plain, frames=len(meshed["rows"]),
                          num_maps=meshed["counters"]["num_maps"])
    report.update(rank=mesh.rank, size=n, device=str(mesh.device), backend=mesh.backend)
    return report


_EXACT = {"tracker": ("match_idx", "match_mask", "valid", "num_updates", "num_inliers",
                      "num_matches"),
          "ring": ("candidate_maps", "votes", "match_idx", "match_row", "match_mask")}


def check_stages(report: dict, tol: float = FLOAT_TOL) -> dict:
    """Hold each sharded stage of a ``dryrun_rank`` (or ``stages``) report to
    its single-rank call: the exact fields bit for bit, chi within
    ``CHI_RTOL`` of it, the other floats within ``tol`` (relative past a
    magnitude of 1); a meshed GraphSLAM run to the unmeshed one.  Raises
    AssertionError on a mismatch; returns each stage's largest float
    difference."""
    worst = {}
    for stage in ("tracker", "ring", "pgo", "pgo_cg", "ba", "ba_joint"):
        if stage not in report:
            continue
        single, sharded = report[stage]["single"], report[stage]["sharded"]
        worst[stage] = 0.0
        for key, ref in single.items():
            got = sharded[key]
            if key in _EXACT.get(stage, ()):
                if not np.array_equal(np.asarray(got), np.asarray(ref)):
                    raise AssertionError(f"{stage}.{key}: sharded != single-rank")
                continue
            diff = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(ref))))
            if key == "chi":
                bound = CHI_RTOL * abs(ref) + 1e-6
            else:
                worst[stage] = max(worst[stage], diff)
                bound = tol * max(1.0, float(np.max(np.abs(ref))))
            if not diff <= bound:
                raise AssertionError(f"{stage}.{key}: sharded differs from the single-rank "
                                     f"call by {diff:.3e} (bound {bound:.3e})")
    if "slam" in report:
        worst["slam"] = compare_slam(report["slam"]["meshed"], report["slam"]["plain"])
    return worst


def compare_slam(got: dict, ref: dict, tol: float = SLAM_POSE_TOL, replays: bool = False) -> float:
    """Two ``slam_run`` reports: per-frame status and map, counters and
    closure events equal, every pose within ``tol`` (m; rotations within
    ``tol`` of the rotation matrix entries).  ``replays``: the
    relocalisation rollbacks and replays must be equal too (else their sum).
    Raises AssertionError; returns the largest pose difference."""
    if got["rows"] != ref["rows"]:
        i = next((i for i, (a, b) in enumerate(zip(got["rows"], ref["rows"])) if a != b),
                 min(len(got["rows"]), len(ref["rows"])))
        raise AssertionError(f"the runs part at frame {i}: {got['rows'][i:i + 1]} vs "
                             f"{ref['rows'][i:i + 1]}")
    if got["counters"] != ref["counters"] or got["events"] != ref["events"]:
        raise AssertionError(f"counters {got['counters']} {got['events']} vs "
                             f"{ref['counters']} {ref['events']}")
    g, r = got["recovery"], ref["recovery"]
    if (g != r) if replays else (sum(g) != sum(r)):
        raise AssertionError(f"relocalisation rollbacks / replays {g} vs {r}")
    diff = float(np.max(np.abs(got["trajectory"] - ref["trajectory"]))) if len(
        got["trajectory"]) else 0.0
    if not diff <= tol:
        raise AssertionError(f"trajectories differ by {diff:.3e} (tolerance {tol})")
    return diff


# ---------------------------------------------------------------------------
# a GraphSLAM session on a rank
# ---------------------------------------------------------------------------

COUNTERS = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections", "num_db_evictions")
KERNEL_NAMES = {"fast": "fast_scores_kernel", "brief": "brief_descriptors_kernel",
                "gn_burst": "gn_burst_stereo_kernel"}


def _watch_statuses(slam) -> list:
    """The status after each frame the host consumes (per frame and in the
    chunk program's mirror), in order."""
    statuses = []
    for name in ("_consume_frame", "_consume_chunk_frame"):
        consume = getattr(slam, name)

        def consume_and_record(*args, consume=consume):
            out = consume(*args)
            statuses.append(slam.status)
            return out

        setattr(slam, name, consume_and_record)
    return statuses


def _load_frames(spec: dict, device):
    """(camera, frames, adaptor config): frames are (points, desc, valid)
    measurement stacks, or the rendered loop's (left, right) stacks."""
    kind = spec["frames"][0]
    if kind == "meas":
        _, points, desc, valid, ts = spec["frames"]
        stacks = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                       for x in (points, desc, valid))
        return spec["cam"], stacks, list(ts), None
    from ..io import synthetic
    from ..models.frontend import StereoAdaptorConfig

    loop = list(synthetic.iter_rendered_loop(device=device, **spec["frames"][1]))
    stacks = (torch.stack([f.left for f in loop]), torch.stack([f.right for f in loop]))
    return (synthetic.synthetic_camera(), stacks, [f.timestamp for f in loop],
            StereoAdaptorConfig())


def _session(mesh, spec: dict, cam, stacks, ts, acfg, count: int = None):
    """One pass: a GraphSLAM over the first ``count`` frames; (slam, rows)."""
    from ..models.frontend import adapt_stereo
    from ..models.slam import GraphSLAM

    slam = GraphSLAM(cam, spec["config"], device=mesh.device,
                     mesh=mesh if spec.get("meshed", True) else None)
    statuses = _watch_statuses(slam)
    T = len(ts) if count is None else count
    if spec["mode"] == "sequence":
        if acfg is None:
            slam.process_meas_sequence(*(x[:T] for x in stacks), ts[:T])
        else:
            slam.process_sequence(stacks[0][:T], stacks[1][:T], ts[:T], acfg)
    else:
        for i in range(T):
            if acfg is None:
                meas = [x[i] for x in stacks]
            else:
                m = adapt_stereo(stacks[0][i], stacks[1][i], acfg)
                meas = [m.points, m.desc, m.valid]
            slam.process(*meas, ts[i])
        slam.flush()
    profiling.sync(mesh.device)
    return slam, list(zip(statuses, (f.local_map_index for f in slam.frames)))


def slam_run(mesh, spec: dict) -> dict:
    """A GraphSLAM session on this rank.  ``spec``: ``config``
    (GraphSLAMConfig), ``frames`` (("meas", points, desc, valid,
    timestamps) numpy stacks seen by the camera ``cam``, or ("loop",
    iter_rendered_loop's keyword arguments): the loop is rendered on the
    rank's device and adapted with the default stereo adaptor), ``mode`` ("sequence": the chunk program;
    "frame": ``process`` per frame, then ``flush``), ``meshed`` (default
    True), ``passes`` (default 1: later passes only time), and optionally
    ``profile_frames`` (a window over that many frames under
    torch.profiler, counting the kernels' events on the card) and
    ``checkpoint`` (a path ``io.checkpoint.save`` writes after the first
    pass)."""
    from .. import kernels
    from ..io import checkpoint
    from ..models import chunk as chunk_ops
    from ..utils import graphs

    cam, stacks, ts, acfg = _load_frames(spec, mesh.device)
    n = len(ts)
    meshed = spec.get("meshed", True)
    # the first pass: results, launches, collectives, the split branches' time
    split_ms = []
    real_split = chunk_ops.run_split

    def timed_split(*args, **kw):
        profiling.sync(mesh.device)
        t0 = time.perf_counter()
        out = real_split(*args, **kw)
        profiling.sync(mesh.device)
        split_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    before = set(graphs.programs())
    kernels.reset_launch_counts()
    mesh.collectives.clear()
    chunk_ops.run_split = timed_split
    t0 = time.perf_counter()
    try:
        slam, rows = _session(mesh, spec, cam, stacks, ts, acfg)
    finally:
        chunk_ops.run_split = real_split
    first_ms = (time.perf_counter() - t0) / n * 1e3
    report = dict(
        rows=rows, counters={k: getattr(slam, k) for k in COUNTERS},
        events=[tuple(e) for e in slam.closure_events],
        trajectory=np.stack(slam.trajectory()) if slam.frames else np.zeros((0, 4, 4)),
        recovery=(slam.num_reloc_rollbacks, slam.num_reloc_replays),
        chunk_stats=dict(slam.chunk_stats), launches=kernels.launch_counts(),
        warm_frames=sum(key[2][0] for key in graphs.programs()
                        if key[0] == "chunk" and key not in before),
        collectives=dict(mesh.collectives), split_ms=split_ms, ms_per_frame=[first_ms],
        rank=mesh.rank, size=mesh.size if meshed else 1, backend=mesh.backend)
    if spec.get("checkpoint"):
        checkpoint.save(slam, spec["checkpoint"])
        report["resumed_equal"] = _resumes(mesh, slam, spec)
    for _ in range(spec.get("passes", 1) - 1):
        profiling.sync(mesh.device)
        t0 = time.perf_counter()
        _session(mesh, spec, cam, stacks, ts, acfg)
        report["ms_per_frame"].append((time.perf_counter() - t0) / n * 1e3)
    if spec.get("profile_frames"):
        report["profiled"] = _profiled(mesh, spec, cam, stacks, ts, acfg,
                                       spec["profile_frames"])
    return report


def _resumes(mesh, slam, spec) -> bool:
    """Whether ``spec["checkpoint"]`` loads into a fresh GraphSLAM like
    ``slam`` (meshed alike) with the same graph, ring, tracker state and
    frames."""
    from ..io import checkpoint
    from ..models.slam import GraphSLAM
    from . import spmd

    if slam.mesh is not None:
        mesh.barrier()      # rank 0 has written the file
    fresh = checkpoint.load(GraphSLAM(slam.cam, slam.config, device=mesh.device,
                                      mesh=slam.mesh), spec["checkpoint"])

    def leaves(s):
        graph, db = s.graph, s.db
        if s.mesh is not None:
            graph, db = spmd.gather_graph(graph, mesh), spmd.gather_database(db, mesh)
        return list(graph) + list(db) + list(s.tracker_state.arena) + [s.tracker_state.T_lm_robot]

    return (all(torch.equal(a, b) for a, b in zip(leaves(slam), leaves(fresh)))
            and [f.local_map_index for f in fresh.frames]
            == [f.local_map_index for f in slam.frames])


def _profiled(mesh, spec, cam, stacks, ts, acfg, count: int) -> dict:
    """A window of ``count`` frames: the wrappers' launch counts and, on
    rank 0, the kernels' events torch.profiler sees on the card (graph
    replays included); the other ranks run the window unprofiled."""
    from .. import kernels

    profiling.sync(mesh.device)
    kernels.reset_launch_counts()
    seen = None
    if mesh.rank == 0 and mesh.device.type == "cuda":
        from torch.autograd import DeviceType

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _session(mesh, spec, cam, stacks, ts, acfg, count)
        seen = dict.fromkeys(KERNEL_NAMES, 0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for key, name in KERNEL_NAMES.items():
                    seen[key] += name in e.name
    else:
        _session(mesh, spec, cam, stacks, ts, acfg, count)
    return dict(counted=kernels.launch_counts(), seen=seen, frames=count)


def slam_runs(mesh, specs: list) -> list:
    """``slam_run`` of each spec in turn, on the same ranks."""
    return [slam_run(mesh, spec) for spec in specs]


def multihost_rank(rank: int, world_size: int, coordinator: str) -> dict:
    """A rank that joins the group itself (``multihost.initialize`` with
    ``coordinator``, gloo on the CPU): its mesh, a SUM across the
    processes of 1 + rank, and the budget-striped query of ``ring_arrays``
    beside the single-process query on the same rank."""
    import torch.distributed as dist

    from ..models import loop_closure as lc
    from . import multihost, spmd

    multihost.initialize(coordinator, world_size, rank, device="cpu", timeout_s=60.0)
    try:
        mesh = multihost.global_mesh(device="cpu")
        total = float(mesh.all_sum(torch.tensor([1.0 + rank]))[0])
        ring = ring_arrays(16 * world_size)
        db = lc.database_from_numpy(ring["db"], "cpu")
        qd, qv = torch.from_numpy(ring["query_desc"]), torch.from_numpy(ring["query_valid"])
        lcfg = lc.LoopDetectorConfig(minimum_age_difference=1, minimum_matches=10)
        single = lc.query(qd, qv, ring["query_map"], db, lcfg)
        sharded = spmd.loop_query_spmd(mesh, qd, qv, ring["query_map"], db, lcfg)
        return dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
                    coordinator=multihost.is_coordinator(), total=total,
                    single={k: _np(v) for k, v in single._asdict().items()},
                    sharded={k: _np(v) for k, v in sharded._asdict().items()})
    finally:
        dist.destroy_process_group()
