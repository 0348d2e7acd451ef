"""Port GraphSLAM, renderer and trajectory metrics == the JAX package, on the CPU.

GraphSLAM runs the synthetic measurement streams of tests/test_slam.py and
tests/test_relocalization.py (a random world projected into the stereo
rig) through both packages: forward with a frame whose measurements are all
invalid (Lost), an out-and-back walk with closures, and one whose return
relocalizes into the first maps.  Split thresholds sit between two step
lengths, so float noise cannot move a split.  Bounds: per frame the status
and local-map index equal; at the end the map, edge, closure,
relocalisation, loss and backstop counts and ``closure_events`` equal, and
the trajectory within 1e-3 m / 1e-3 rad.  The closure backstop (candidate
agreement and post-PGO pruning, several accepted candidates) is driven with
the same hand-made decision packets in both packages.  The renderer at
120x160: depth within rtol 1e-5 and images within 1e-2 grey levels except
where two planes meet: there a one-ulp difference in the in-quad test can
pick the other plane, so up to 0.5 % of pixels may differ by more;
``evaluate`` within 1e-6.  Pose-graph growth (the relocalise walk from 2
poses and 2 edges) and ring eviction (the closure walk with two ring
slots) run per frame in both packages, held as the streams above and to
the grown capacities.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import synthetic as jsyn  # noqa: E402
from srrg2_proslam_tpu.metrics import trajectory as jtm  # noqa: E402
from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402
from srrg2_proslam_tpu.ops import se3 as jse3  # noqa: E402
from srrg2_proslam_tpu.utils import profiling as jprof  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from srrg2_proslam_tpu_torch.io.datasets import kitti_camera  # noqa: E402
from srrg2_proslam_tpu_torch.metrics import trajectory as ttm  # noqa: E402
from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import se3 as tse3  # noqa: E402
from srrg2_proslam_tpu_torch.utils import profiling as tprof  # noqa: E402

CAM = kitti_camera(rows=400, cols=600)._replace(fx=450.0, fy=450.0, cx=300.0, cy=200.0,
                                                baseline_px=450.0 * 0.5)
POSE_TOL = 1e-3
COUNTERS = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections", "num_db_evictions")


def _world(rng, n):
    return np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                     rng.uniform(2, 40, n)], axis=1).astype(np.float32)


def _stereo_measurements(pts_w, T_wc):
    """tests/test_slam.py: project world points into the rig at T_wc."""
    p_c = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    z = p_c[:, 2]
    zs = np.maximum(z, 0.5)
    u = CAM.fx * p_c[:, 0] / zs + CAM.cx
    v = CAM.fy * p_c[:, 1] / zs + CAM.cy
    ur = u - CAM.baseline_px / zs
    ok = (z > 0.5) & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows) & (ur >= 0)
    return np.stack([u, v, ur, v], axis=1).astype(np.float32), ok


def _scenario(name):
    """(frames [(points, desc, valid, timestamp)], config kwargs) of a stream."""
    rng = np.random.RandomState(0)
    n = 400 if name == "lost" else 500
    pts_w = _world(rng, n)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    common = dict(arena_capacity=1024, max_local_maps=32, max_edges=64)
    if name == "lost":
        zs = [0.4 * i for i in range(12)]
        cfg = dict(splitting=dict(maximum_translation_m=1.0), enable_loop_closing=False)
    elif name == "closure":
        zs = list(np.arange(0, 3.0, 0.3)) + list(np.arange(3.0, -0.01, -0.3))
        cfg = dict(splitting=dict(maximum_translation_m=1.0), database_capacity=8192,
                   loop=dict(minimum_age_difference=2, minimum_matches=25))
    else:
        zs = list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))
        # at most 2 finished-map arenas stay on the device: the relocalisation
        # reloads a moved one
        cfg = dict(splitting=dict(maximum_translation_m=0.6), database_capacity=16384,
                   loop=dict(minimum_age_difference=3, minimum_matches=25),
                   max_device_map_arenas=2)
    frames = []
    for i, z in enumerate(zs):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -z
        p, ok = _stereo_measurements(pts_w, T_wc)
        if name == "lost" and i == 6:
            ok[:] = False                  # nothing measured: the tracker is Lost
        frames.append((p, desc, ok, 0.1 * i))
    return frames, dict(common, **cfg)


def _config(mod, loop_cls, kw):
    kw = dict(kw)
    if "splitting" in kw:
        kw["splitting"] = mod.SplittingConfig(**kw["splitting"])
    if "loop" in kw:
        kw["loop"] = loop_cls(**kw["loop"])
    return mod.GraphSLAMConfig(**kw)


def _summary(slam, per_frame, prof):
    return dict(per_frame=per_frame, counters={k: getattr(slam, k) for k in COUNTERS},
                events=list(slam.closure_events), trajectory=slam.trajectory(),
                robot=slam.robot_in_world(),
                scopes={k: v["calls"] for k, v in prof.stats().items()})


@pytest.fixture(scope="module")
def runs():
    """Every scenario once through each package, with both packages'
    profile_time scopes on."""
    out = {}
    for name in ("lost", "closure", "relocalize"):
        frames, kw = _scenario(name)
        j = js.GraphSLAM(CAM, _config(js, JLoopCfg, kw))
        t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, kw), device="cpu")
        j_rows, t_rows = [], []
        for prof in (jprof, tprof):
            prof.reset()
            prof.enable(True)
        try:
            for p, d, ok, stamp in frames:
                j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
                j_rows.append((j.status, j.current_map))
                t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok),
                          stamp)
                t_rows.append((t.status, t.current_map))
        finally:
            for prof in (jprof, tprof):
                prof.enable(False)
        out[name] = (_summary(j, j_rows, jprof), _summary(t, t_rows, tprof))
    return out


SCENARIOS = ("lost", "closure", "relocalize")


@pytest.mark.parametrize("name", SCENARIOS)
def test_per_frame_status_and_map_match_jax(runs, name):
    j, t = runs[name]
    assert t["per_frame"] == j["per_frame"]
    if name == "lost":
        assert ts.LOST not in [s for s, _ in t["per_frame"]]   # recovered in-frame
        assert t["counters"]["num_losses"] == 1


@pytest.mark.parametrize("name", SCENARIOS)
def test_counters_and_closure_events_match_jax(runs, name):
    j, t = runs[name]
    assert t["counters"] == j["counters"]
    assert t["events"] == j["events"]
    if name != "lost":
        assert t["counters"]["num_closures"] >= 1
    if name == "relocalize":
        assert t["counters"]["num_relocalizations"] >= 1


@pytest.mark.parametrize("name", SCENARIOS)
def test_trajectory_matches_jax(runs, name):
    j, t = runs[name]
    assert len(t["trajectory"]) == len(j["trajectory"])
    A = torch.from_numpy(np.stack(t["trajectory"]))
    B = torch.from_numpy(np.stack(j["trajectory"]).astype(np.float32))
    d_t, d_ang = tse3.error_t_and_angle(A, B)
    assert float(d_t.max()) <= POSE_TOL and float(d_ang.max()) <= POSE_TOL
    np.testing.assert_allclose(t["robot"], j["robot"], atol=POSE_TOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_profile_scopes_match_jax(runs, name):
    """The port's profile_time scopes carry the JAX package's names and are
    entered as often; ``reloc`` counts the relocalisations."""
    j, t = runs[name]
    assert t["scopes"]["tracker_dispatch"] == len(t["per_frame"])
    assert {k: t["scopes"].get(k, 0) for k in j["scopes"]} == j["scopes"]
    assert t["scopes"].get("reloc", 0) == t["counters"]["num_relocalizations"]
    if name != "lost":
        assert t["scopes"]["loop_detect"] >= 1 and t["scopes"]["pgo"] >= 1


def _chain(slam, n, device_of):
    """Maps 0..n-1 one metre apart along -z, odometry edges between them."""
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = float(i)
        slam._make_new_map(device_of(T))


def _packet(poses, query, rows):
    """A decision packet: per row (candidate, extra translation of its
    T_query_in_ref in metres along x)."""
    pkt = np.zeros((4, 22), np.float32)
    pkt[:, 0] = -1
    for r, (cand, err) in enumerate(rows):
        T = np.linalg.inv(poses[cand]) @ poses[query]
        T[0, 3] += err
        pkt[r, :6] = [cand, 1.0, 100 - r, 0.5, 0.9, 100]
        pkt[r, 6:] = T.reshape(-1)
    return pkt


BACKSTOP_CASES = {
    "two_agreeing": [(0, 0.0), (1, 0.02)],
    "majority_drops_outlier": [(0, 0.0), (1, 0.01), (2, 3.0)],
    "one_vs_one_rejects_both": [(0, 0.0), (1, 3.0)],
    "agreeing_but_wrong_pruned": [(0, 2.0), (1, 2.2), (2, 0.0)],
}


@pytest.mark.parametrize("case", BACKSTOP_CASES)
def test_backstop_decision_matches_jax(case):
    """The same hand-made packet into both packages' closure decision."""
    # relocalisation gates unreachable: this pins factors, PGO and pruning
    kw = dict(relocalizer=dict(relocalize_min_inliers=10 ** 6), arena_capacity=64,
              max_local_maps=8, max_edges=8, database_capacity=256)
    j = js.GraphSLAM(CAM, js.GraphSLAMConfig(
        relocalizer=js.RelocalizerConfig(**kw["relocalizer"]),
        **{k: v for k, v in kw.items() if k != "relocalizer"}))
    t = ts.GraphSLAM(CAM, ts.GraphSLAMConfig(
        relocalizer=ts.RelocalizerConfig(**kw["relocalizer"]),
        **{k: v for k, v in kw.items() if k != "relocalizer"}), device="cpu")
    _chain(j, 6, jnp.asarray)
    _chain(t, 6, torch.from_numpy)
    pkt = _packet(np.asarray(j.graph.poses), 5, BACKSTOP_CASES[case])
    m = js._ClosureMarker()
    m.packet, m.query_map = jnp.asarray(pkt), 5
    j._consume_marker(m)
    reloc = t._consume_marker(ts._ClosureMarker(
        packet=ts._HostCopy(torch.from_numpy(pkt)), match_row=None, match_mask=None, T_candidates=None, query_state=None,
        query_map=5, timestamp=0.0, T_split=np.eye(4, dtype=np.float32),
        frame_record_index=0))
    assert reloc is None
    assert t.num_closures == j.num_closures and t.closure_events == j.closure_events
    assert t.num_backstop_rejections == j.num_backstop_rejections
    assert t.num_edges == j.num_edges
    expected = {"two_agreeing": (2, 0), "majority_drops_outlier": (2, 1),
                "one_vs_one_rejects_both": (0, 2)}.get(case)
    if expected:
        assert (t.num_closures, t.num_backstop_rejections) == expected
    else:
        assert t.num_backstop_rejections >= 1
    for name in ("edge_i", "edge_j", "edge_valid", "pose_valid"):
        np.testing.assert_array_equal(getattr(t.graph, name).numpy(),
                                      np.asarray(getattr(j.graph, name)), err_msg=name)
    np.testing.assert_allclose(t.graph.poses.numpy(), np.asarray(j.graph.poses), atol=1e-4)


@pytest.mark.parametrize("kw,model", [
    (dict(speculation_depth=2), "stereo"),
    (dict(chunk_size=16), "stereo"),
    (dict(local_ba=ts.LocalBAConfig(enabled=True), chunk_size=16), "stereo"),
    (dict(tracker=ts.TrackerConfig(landmark_estimator="smoother"), speculation_depth=8),
     "stereo"),
    # icl_slam.json's stepping
    (dict(chunk_size=16, speculation_depth=8), "rgbd"),
    (dict(), "mesh"),
])
def test_unsupported_options_raise(kw, model):
    """Of the settings refused before the speculative pipeline, the
    sequence API and the mesh were ported, none raises NotImplementedError
    any more: local BA with a sequence raises ValueError, as in the JAX
    package, and so does a mesh whose size does not divide the ring budget
    (the mesh itself runs: tests/test_torch_mesh_slam.py).  The others run
    the Lost stream (on (u, v, depth) rows for RGB-D), per frame with
    ``process`` and ``flush`` or, with a chunk size, through
    ``process_meas_sequence``, and equal the synchronous per-frame run
    exactly: per-frame local maps, counters and every pose."""
    if model == "mesh":
        from srrg2_proslam_tpu_torch.parallel.spmd import Mesh

        two = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
        ts.GraphSLAM(CAM, ts.GraphSLAMConfig(), device="cpu", mesh=two)
        with pytest.raises(ValueError, match="divisible by the mesh size"):
            ts.GraphSLAM(CAM, ts.GraphSLAMConfig(max_db_descriptors_per_map=67), device="cpu",
                         mesh=two)
        return
    frames, base = _scenario("lost")
    if model == "rgbd":
        frames = [(np.stack([p[:, 0], p[:, 1], CAM.baseline_px / np.maximum(p[:, 0] - p[:, 2],
                                                                             1e-3)], 1),
                   d, ok, stamp) for p, d, ok, stamp in frames]
    base = dict(base, tracker=kw.get("tracker", ts.TrackerConfig()))
    runs = []
    for extra in ({}, {k: v for k, v in kw.items() if k != "tracker"}):
        slam = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, dict(base, **extra)),
                            model=model, device="cpu")
        if slam.config.chunk_size > 0:
            stacks = [np.stack([f[k] for f in frames]) for k in range(3)]
            if slam.config.local_ba.enabled:
                with pytest.raises(ValueError):
                    slam.process_meas_sequence(*stacks, [f[3] for f in frames])
                return
            slam.process_meas_sequence(*stacks, [f[3] for f in frames])
        else:
            for p, d, ok, stamp in frames:
                slam.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok),
                             stamp)
            slam.flush()
        runs.append(slam)
    sync, other = runs
    assert [f.local_map_index for f in other.frames] == [f.local_map_index
                                                          for f in sync.frames]
    assert {k: getattr(other, k) for k in COUNTERS} == {k: getattr(sync, k) for k in COUNTERS}
    np.testing.assert_array_equal(np.stack(other.trajectory()), np.stack(sync.trajectory()))
    assert sync.num_maps >= 3 and len(sync.frames) == len(frames)


# the settings that grow the pose graph (from 2 poses and 2 edges) and
# evict from the ring (two slots of 512 rows), on the walks above
def test_graphslam_defaults_to_the_card():
    cfg = ts.GraphSLAMConfig(arena_capacity=16, max_local_maps=4, max_edges=4,
                             database_capacity=64)
    if torch.cuda.is_available():
        slam = ts.GraphSLAM(CAM, cfg)
        assert slam.tracker_state.arena.pos.is_cuda and slam.graph.poses.is_cuda
        assert slam.db.desc.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ts.GraphSLAM(CAM, cfg)


def test_evaluate_matches_jax(rng):
    poses = [np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
             for _ in range(20)]
    gt = [np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
          for _ in range(20)]
    for align in (True, False):
        a, b = ttm.evaluate(poses, gt, align), jtm.evaluate(poses, gt, align)
        np.testing.assert_allclose(a.mean_translation_rmse, b.mean_translation_rmse,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a.std_translation_rmse, b.std_translation_rmse,
                                   rtol=1e-6, atol=1e-6)
        for k in ("mean_rotation_deg", "std_rotation_deg", "ate_rmse"):
            assert abs(getattr(a, k) - getattr(b, k)) <= 1e-6, k
    for x, y in zip(ttm.rpe(poses, gt, 2), jtm.rpe(poses, gt, 2)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
    # collinear positions: the degenerate alignment falls back to pose 0
    line = [np.eye(4) for _ in range(5)]
    for i, T in enumerate(line):
        T[2, 3] = i
    assert ttm.evaluate(line, line).ate_rmse == jtm.evaluate(line, line).ate_rmse


def test_trajectories_and_room_match_jax():
    for a, b in [(tsyn.loop_trajectory(10.0, 6.0, 0.4, 10), jsyn.loop_trajectory(10.0, 6.0,
                                                                                  0.4, 10)),
                 (tsyn.out_and_back_trajectory(), jsyn.out_and_back_trajectory())]:
        assert len(a) == len(b)
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert len(jsyn.loop_trajectory(10.0, 6.0, 0.4, 10)) == 145
    room_t, room_j = tsyn.make_room(seed=3, tex_size=64, device="cpu"), \
        jsyn.make_room(seed=3, tex_size=64)
    for name in tsyn.PlaneSet._fields:
        np.testing.assert_array_equal(getattr(room_t, name).numpy(),
                                      np.asarray(getattr(room_j, name)), err_msg=name)
    assert tuple(tsyn.synthetic_camera()) == tuple(jsyn.synthetic_camera())
    img = np.linspace(0, 255, 12, dtype=np.float32)
    np.testing.assert_allclose(tsyn.crush_exposure(torch.from_numpy(img)).numpy(),
                               np.asarray(jsyn.crush_exposure(jnp.asarray(img))), rtol=1e-6)


def _assert_images_close(got, ref):
    """Within 1e-2 grey levels but on plane seams (<= 0.5 % of pixels)."""
    off = np.abs(got - ref) > 1e-2
    assert off.mean() <= 5e-3, off.mean()
    assert np.median(np.abs(got - ref)) <= 1e-3


@pytest.mark.parametrize("frame", [0, 37, 64])
def test_render_stereo_matches_jax(frame):
    """Straight, turning and far-wall views at 120x160, supersample 2."""
    cam_t = tsyn.synthetic_camera(120, 160, fx=112.5)
    cam_j = jsyn.synthetic_camera(120, 160, fx=112.5)
    T_wc = jsyn.loop_trajectory(10.0, 6.0, 0.4, 10)[frame]
    planes_t = tsyn.make_room(size_x=18.0, size_z=22.0, tex_size=128, device="cpu")
    planes_j = jsyn.make_room(size_x=18.0, size_z=22.0, tex_size=128)
    got = tsyn.render_stereo(cam_t, torch.from_numpy(T_wc), planes_t)
    ref = jsyn.render_stereo(cam_j, jnp.asarray(T_wc), planes_j)
    for name, g, r in zip(("left", "right", "depth"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == (120, 160) and g.dtype == np.float32, name
        if name == "depth":
            assert np.array_equal(np.isfinite(g), np.isfinite(r))
            fin = np.isfinite(r)
            np.testing.assert_allclose(g[fin], r[fin], rtol=1e-5)
        else:
            _assert_images_close(g, r)
            assert g.std() > 20.0, name      # textured, not blank


def test_iter_rendered_loop_matches_jax():
    kw = dict(count=2, rows=120, cols=160, side_a=10.0, side_b=6.0, step_m=0.4,
              turn_frames=10, fx=112.5)
    for a, b in zip(tsyn.iter_rendered_loop(**kw, device="cpu"), jsyn.iter_rendered_loop(**kw)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
        _assert_images_close(a.left.numpy(), b.left)
        _assert_images_close(a.right.numpy(), b.right)


@pytest.mark.slow
def test_rendered_closed_loop_port_matches_jax():
    """tests/test_rendered_e2e.py's loop (145 frames, 480x640) through the
    port on the CPU, held to its gates and to the JAX run."""
    from srrg2_proslam_tpu.models.frontend import StereoAdaptorConfig as JAdaptCfg
    from srrg2_proslam_tpu.models.frontend import adapt_stereo as j_adapt
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo

    kw = dict(splitting=dict(maximum_translation_m=4.0, maximum_rotation_rad=0.35),
              loop=dict(minimum_age_difference=3), arena_capacity=4096,
              database_capacity=8192, max_db_descriptors_per_map=384)
    j = js.GraphSLAM(jsyn.synthetic_camera(), _config(js, JLoopCfg, kw))
    t = ts.GraphSLAM(tsyn.synthetic_camera(), _config(ts, LoopDetectorConfig, kw),
                     device="cpu")
    gt, rows = [], []
    for fr in jsyn.iter_rendered_loop(side_a=10.0, side_b=6.0, step_m=0.4, turn_frames=10):
        jm = j_adapt(jnp.asarray(fr.left), jnp.asarray(fr.right), JAdaptCfg())
        j.process(jm.points, jm.desc, jm.valid, fr.timestamp)
        tm_ = adapt_stereo(torch.from_numpy(fr.left), torch.from_numpy(fr.right),
                           StereoAdaptorConfig())
        t.process(tm_.points, tm_.desc, tm_.valid, fr.timestamp)
        rows.append(((j.status, j.current_map), (t.status, t.current_map)))
        gt.append(fr.gt_pose)
    assert len(gt) > 120 and t.num_maps >= 10
    assert t.num_closures >= 1 and t.num_relocalizations >= 1
    err = ttm.evaluate(t.trajectory(), gt)
    assert np.all(err.mean_translation_rmse <= 0.30), err.mean_translation_rmse
    assert err.mean_rotation_deg <= 3.0 and err.ate_rmse <= 0.5
    assert [r[1] for r in rows] == [r[0] for r in rows]
    assert {k: getattr(t, k) for k in COUNTERS} == {k: getattr(j, k) for k in COUNTERS}
    assert t.closure_events == j.closure_events
    d_t, d_ang = tse3.error_t_and_angle(torch.from_numpy(np.stack(t.trajectory())),
                                        torch.from_numpy(np.stack(j.trajectory())))
    assert float(d_t.max()) <= 1e-2 and float(d_ang.max()) <= 1e-3


# ---- pose-graph growth and ring eviction ----------------------------------------------

GROWTH_CASES = {"growth": ("relocalize", dict(max_local_maps=2, max_edges=2)),
                "eviction": ("closure", dict(database_capacity=1024,
                                             max_db_descriptors_per_map=512))}


@pytest.mark.parametrize("case", GROWTH_CASES)
def test_growth_and_eviction_match_jax(case):
    """Pose-graph growth (the relocalise walk from 2 poses and 2 edges: 11
    maps, 12 closures) and ring eviction (the closure walk with two ring
    slots: 2 evictions) per frame in both packages: per-frame status and
    map, counters and closure events equal, the trajectory within
    POSE_TOL, the grown capacities equal."""
    name, extra = GROWTH_CASES[case]
    frames, kw = _scenario(name)
    kw = dict(kw, **extra)
    j = js.GraphSLAM(CAM, _config(js, JLoopCfg, kw))
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, kw), device="cpu")
    j_rows, t_rows = [], []
    for p, d, ok, stamp in frames:
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
        j_rows.append((j.status, j.current_map))
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        t_rows.append((t.status, t.current_map))
    assert t_rows == j_rows
    assert {k: getattr(t, k) for k in COUNTERS} == {k: getattr(j, k) for k in COUNTERS}
    assert t.closure_events == j.closure_events
    assert (t.graph.capacity, t.graph.edge_capacity) == (j.graph.capacity, j.graph.edge_capacity)
    if case == "growth":
        assert t.num_maps > 2 and t.graph.edge_capacity > 2 and t.num_relocalizations >= 1
    else:
        assert t.num_db_evictions >= 1
    d_t, d_ang = tse3.error_t_and_angle(
        torch.from_numpy(np.stack(t.trajectory())),
        torch.from_numpy(np.stack(j.trajectory()).astype(np.float32)))
    print(f"{case}: largest |dt| {float(d_t.max()):.3e} m, angle {float(d_ang.max()):.3e} rad")
    assert float(d_t.max()) <= POSE_TOL and float(d_ang.max()) <= POSE_TOL
