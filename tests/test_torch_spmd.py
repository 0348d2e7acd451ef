"""The port's sharded stages (parallel/spmd.py) at world size 2 on gloo CPU
ranks == their single-rank calls, and agree with the JAX package's
``parallel.*`` on a mesh of 2 of the conftest's 8 virtual CPU devices.

One spawned pair of ranks (parallel/launch.py, a FileStore in tmp_path)
runs parallel/checks.py::stages on numpy-seeded inputs: the tracker step
at tests/test_spmd_tracker.py's shapes (128 measurements, a 256-landmark
arena), the budget-striped ring query (4 slots x 64, duplicated rows whose
tied keys the row breaks), PGO with the dense and the CG solver (8 poses,
8 factors in 10 edge slots: rank 1 holds free slots), and BA
structure-only and joint (2 keyframes, 16 points).  Each rank also runs
the stage on its own, unsharded.

Placement and the owner-only writes of the chunk program are checked on
meshes without a process group (no collective is needed).

Bounds against the single-rank call: tracker matches, inliers, arena
validity and update counts, and the query's candidates, votes, keys, rows
and masks bit for bit; floats within 1e-5 (relative to their magnitude
past 1), chi within 1e-3 of itself (parallel/checks.py::CHI_RTOL).
Against JAX: tests/test_spmd_tracker.py's bounds for the tracker (X and
arena positions within 1e-5, inliers, matches and validity equal),
the query's integer outputs equal and its points within 1e-6, PGO poses
within 1e-4 (tests/test_mesh_orchestrator.py's trajectory bound; the
largest difference seen is printed) and BA within 1e-4.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from srrg2_proslam_tpu import parallel as jpar  # noqa: E402
from srrg2_proslam_tpu.io.datasets import kitti_camera as jkitti_camera  # noqa: E402
from srrg2_proslam_tpu.models import loop_closure as jlc  # noqa: E402
from srrg2_proslam_tpu.models.tracker import TrackerConfig as JTrackerConfig  # noqa: E402
from srrg2_proslam_tpu.ops import ba as jba, pgo as jpgo  # noqa: E402

from srrg2_proslam_tpu_torch.entry import synthetic_arrays  # noqa: E402
from srrg2_proslam_tpu_torch.io.datasets import kitti_camera  # noqa: E402
from srrg2_proslam_tpu_torch.models import loop_closure as lc  # noqa: E402
from srrg2_proslam_tpu_torch.parallel import checks, launch, spmd  # noqa: E402

SIZES = dict(n_meas=128, capacity=256, budget=64, n_edges=10, n_pts=16)
STAGES = ("tracker", "ring", "pgo", "pgo_cg", "ba", "ba_joint")
JAX_POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' reports of checks.stages at SIZES."""
    return launch.run(checks.stages, 2, SIZES, device="cpu",
                      store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's parallel.* on 2 virtual CPU devices, same inputs."""
    mesh = jpar.make_mesh(jax.devices()[:2])
    cam = jkitti_camera()
    out = {}
    state, points, desc, valid = jentry._synthetic_frame(SIZES["n_meas"], SIZES["capacity"], cam)
    s, stats, X = jpar.slam_step_spmd(mesh, state, points, desc, valid, cam, JTrackerConfig(),
                                      "stereo")
    out["tracker"] = dict(X=np.asarray(X), pos=np.asarray(s.arena.pos),
                          valid=np.asarray(s.arena.valid), num_inliers=int(stats.num_inliers),
                          num_matches=int(stats.num_matches))
    ring = checks.ring_arrays(SIZES["budget"])
    db = jlc.DescriptorDatabase(**{k: jnp.asarray(v) for k, v in ring["db"].items()})
    res = jpar.loop_query_spmd(mesh, jnp.asarray(ring["query_desc"]),
                               jnp.asarray(ring["query_valid"]), ring["query_map"], db,
                               jlc.LoopDetectorConfig(minimum_age_difference=1), num_maps=4)
    out["ring"] = {k: np.asarray(v) for k, v in res._asdict().items()}
    g = checks.pgo_arrays(SIZES["n_edges"])
    graph = jpgo.PoseGraph(**{k: jnp.asarray(v.astype(np.int32) if k in ("edge_i", "edge_j")
                                              else v) for k, v in g.items()})
    for name, solver in (("pgo", "dense"), ("pgo_cg", "cg")):
        gj, chi = jpar.pgo_optimize_spmd(mesh, graph, jpgo.PGOConfig(solver=solver))
        out[name] = dict(poses=np.asarray(gj.poses), chi=float(chi))
    prob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in checks.ba_arrays(cam, SIZES["n_pts"])
                            .items()})
    for name, structure_only in (("ba", True), ("ba_joint", False)):
        pj, chi = jpar.ba_optimize_spmd(mesh, prob, cam, "stereo",
                                        jba.BAConfig(iterations=2, structure_only=structure_only))
        out[name] = dict(poses=np.asarray(pj.poses), points=np.asarray(pj.points),
                         chi=float(chi))
    return out


def test_inputs_are_the_jax_inputs():
    """The port's synthetic frame draws the JAX entry's numbers."""
    j = jentry._synthetic_frame(SIZES["n_meas"], SIZES["capacity"], jkitti_camera())
    _, points, desc, valid = synthetic_arrays(SIZES["n_meas"], SIZES["capacity"], kitti_camera())
    np.testing.assert_array_equal(points, np.asarray(j[1]))
    np.testing.assert_array_equal(desc, np.asarray(j[2]))
    np.testing.assert_array_equal(valid, np.asarray(j[3]))


@pytest.mark.parametrize("stage", STAGES)
def test_sharded_stage_equals_single_rank(ranks, stage):
    for report in ranks:
        worst = checks.check_stages({stage: report[stage]})
        print(f"rank {report is ranks[1]:d} {stage}: largest float difference {worst[stage]:.3e}")
    if stage == "ring":
        assert ranks[0][stage]["sharded"]["votes"][0] >= 25   # a candidate was found
    if stage == "tracker":
        assert ranks[0][stage]["sharded"]["num_inliers"] >= 25


@pytest.mark.parametrize("stage", STAGES)
def test_ranks_hold_the_same_replicated_result(ranks, stage):
    a, b = ranks[0][stage]["sharded"], ranks[1][stage]["sharded"]
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


def test_tracker_agrees_with_jax(ranks, jax_ref):
    got, ref = ranks[0]["tracker"]["sharded"], jax_ref["tracker"]
    np.testing.assert_allclose(got["X"], ref["X"], atol=1e-5)
    assert got["num_inliers"] == ref["num_inliers"]
    assert got["num_matches"] == ref["num_matches"]
    np.testing.assert_allclose(got["pos"], ref["pos"], atol=1e-5)
    np.testing.assert_array_equal(got["valid"], ref["valid"])


def test_ring_query_agrees_with_jax(ranks, jax_ref):
    got, ref = ranks[0]["ring"]["sharded"], jax_ref["ring"]
    for key in ("candidate_maps", "votes", "match_idx", "match_row", "match_mask"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["match_points"], ref["match_points"], atol=1e-6)


@pytest.mark.parametrize("stage", ("pgo", "pgo_cg", "ba", "ba_joint"))
def test_optimizers_agree_with_jax(ranks, jax_ref, stage):
    got, ref = ranks[0][stage]["sharded"], jax_ref[stage]
    for key in ("poses", "points"):
        if key in ref:
            diff = float(np.abs(got[key] - ref[key]).max())
            print(f"{stage} {key}: port sharded vs JAX sharded max |diff| {diff:.3e}")
            assert diff <= JAX_POSE_TOL, (key, diff)
    assert got["chi"] == pytest.approx(ref["chi"], rel=1e-3, abs=1e-6)


def _fake_mesh(size, rank=0):
    """A Mesh of ``size`` ranks without a process group: placement only."""
    return spmd.Mesh(rank=rank, size=size, device=torch.device("cpu"), backend="gloo")


def test_placement_validates_divisibility():
    from srrg2_proslam_tpu_torch.entry import _synthetic_frame

    cam = kitti_camera()
    st, points, desc, valid = _synthetic_frame(10, 32, cam, device="cpu")
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        spmd.shard_frame_inputs(_fake_mesh(4), st, points, desc, valid)
    db = lc.empty_database(4 * 67, 67, device="cpu")
    with pytest.raises(ValueError, match=r"max_db_descriptors_per_map \(67\)"):
        spmd.shard_database(db, _fake_mesh(2))


def test_stripes_and_shards_tile_the_global_arrays():
    """Each rank's stripe of the ring and block of a graph's edges, put
    side by side in rank order, are the global arrays."""
    from srrg2_proslam_tpu_torch.ops import pgo

    ring = checks.ring_arrays(32)["db"]
    db = lc.database_from_numpy(ring, "cpu")
    stripes = [spmd.shard_database(db, _fake_mesh(4, r)) for r in range(4)]
    for f in ("desc", "points", "arena_row", "valid"):
        torch.testing.assert_close(torch.cat([getattr(s, f) for s in stripes], dim=1),
                                   getattr(db, f), rtol=0, atol=0)
    graph = pgo.graph_from_numpy(checks.pgo_arrays(12), "cpu")
    blocks = [spmd.shard_graph(graph, _fake_mesh(2, r)) for r in range(2)]
    for f in ("edge_i", "edge_j", "edge_Z", "edge_weight", "edge_valid"):
        torch.testing.assert_close(torch.cat([getattr(b, f) for b in blocks]),
                                   getattr(graph, f), rtol=0, atol=0)


def test_owner_writes_tile_the_single_device_writes():
    """The chunk program's writes on a mesh (each rank its stripe or block):
    ``db_write_slot``, ``undo_graph_entries`` and the split branch's
    edge-slot put, rank by rank, equal the single-device write cut into
    the same pieces (``reloc_op``'s retired edge runs in the meshed
    GraphSLAM tests)."""
    from srrg2_proslam_tpu_torch.models import chunk
    from srrg2_proslam_tpu_torch.ops import pgo

    rng = np.random.RandomState(4)
    db = lc.database_from_numpy(checks.ring_arrays(32)["db"], "cpu")
    rows = dict(desc=torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (32, 256))),
                points=torch.from_numpy(rng.normal(0, 1, (32, 3)).astype(np.float32)),
                rows=torch.arange(32, dtype=torch.int32), valid=torch.rand(32) > 0.3)
    full = chunk.db_write_slot(db, 2, *rows.values(), 7, 5)
    graph = pgo.graph_from_numpy(checks.pgo_arrays(12), "cpu")
    undone = chunk.undo_graph_entries(graph, [3, 5], [2, 9])
    odo = torch.tensor(7)
    put = chunk._put(graph.edge_j, odo, 4)
    for n in (2, 4):
        meshes = [_fake_mesh(n, r) for r in range(n)]
        stripes = [chunk.db_write_slot(spmd.shard_database(db, m), 2, *rows.values(), 7, 5, m)
                   for m in meshes]
        for f in ("desc", "points", "arena_row", "valid"):
            torch.testing.assert_close(torch.cat([getattr(s, f) for s in stripes], dim=1),
                                       getattr(full, f), rtol=0, atol=0)
        for s in stripes:
            torch.testing.assert_close(s.map_id, full.map_id, rtol=0, atol=0)
            assert int(s.next) == int(full.next)
        if n == 4:
            continue   # 12 edge slots: blocks of 6 on 2 ranks
        blocks = [chunk.undo_graph_entries(spmd.shard_graph(graph, m), [3, 5], [2, 9], m)
                  for m in meshes]
        torch.testing.assert_close(torch.cat([b.edge_valid for b in blocks]),
                                   undone.edge_valid, rtol=0, atol=0)
        for b in blocks:
            torch.testing.assert_close(b.pose_valid, undone.pose_valid, rtol=0, atol=0)
        torch.testing.assert_close(
            torch.cat([chunk._put(spmd.shard_graph(graph, m).edge_j, odo, 4, m) for m in meshes]),
            put, rtol=0, atol=0)
