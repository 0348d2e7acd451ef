"""Port local bundle adjustment == the JAX package, on the CPU.

``ops/ba.py``: a random world observed from 4 keyframes (stereo rows or
RGB-D rows, ICL's negative fy for the latter), poses and points
perturbed, some observations masked out and one keyframe slot empty.
The observation terms agree within rtol 1e-4 (residuals, Jacobians,
weights); ``optimize`` in both branches (structure only, and the joint
Schur solve with its [6P, 6P] camera system) agrees within 1e-3 m on the
points and 1e-4 on the poses after 5 iterations, chi within rtol 1e-3.

GraphSLAM with ``local_ba.enabled`` on the walk of tests/test_slam.py
(stereo rows of a random world, splits every 0.6 m, closures): the same
per-frame status and map, counters and closure events as JAX, the
trajectory within 1e-3 m / 1e-3 rad, and every finished map's (refined)
arena within 1e-3 m.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402
from srrg2_proslam_tpu.ops import ba as jba, se3 as jse3  # noqa: E402
from srrg2_proslam_tpu.ops.pinhole import Camera as JCamera  # noqa: E402

from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import ba as tba, se3 as tse3  # noqa: E402
from srrg2_proslam_tpu_torch.ops.pinhole import Camera  # noqa: E402

CAMS = {
    "stereo": Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
                     baseline_px=450.0 * 0.5),
    "rgbd": Camera(fx=481.2, fy=-481.0, cx=319.5, cy=239.5, rows=480, cols=640,
                   range_min=0.1, range_max=20.0),
}
POSE_TOL = 1e-3


def _problem(rng, model, n_poses=4, slots=5, n_points=300):
    """(numpy fields of a BAProblem) with perturbed poses and points."""
    cam = CAMS[model]
    pts_w = np.stack([rng.uniform(-6, 6, n_points), rng.uniform(-3, 3, n_points),
                      rng.uniform(4, 18, n_points)], 1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    step = np.asarray(jse3.exp(jnp.asarray(np.array([0.2, 0.03, 0.4, 0.0, 0.02, 0.0],
                                                     np.float32))))
    poses, obs = [], []
    for k in range(n_poses):
        poses.append(T.copy())
        T_cw = np.linalg.inv(T)
        p_c = pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = np.maximum(p_c[:, 2], 1e-3)
        u = cam.fx * p_c[:, 0] / z + cam.cx
        v = cam.fy * p_c[:, 1] / z + cam.cy
        third = u - cam.baseline_px / z if model == "stereo" else p_c[:, 2]
        meas = np.stack([u, v, third], 1) + rng.normal(0, 0.5, (n_points, 3))
        ok = ((p_c[:, 2] > 1) & (u >= 0) & (u < cam.cols) & (v >= 0) & (v < cam.rows)
              & (rng.uniform(size=n_points) > 0.2))
        obs.append((meas.astype(np.float32), ok))
        T = T @ step
    for k in range(1, n_poses):
        xi = rng.normal(0, 0.02, 6).astype(np.float32)
        poses[k] = poses[k] @ np.asarray(jse3.exp(jnp.asarray(xi)))
    poses += [np.eye(4, dtype=np.float32)] * (slots - n_poses)     # an empty slot
    n_obs = slots * n_points
    return dict(
        poses=np.stack(poses).astype(np.float32),
        pose_valid=np.arange(slots) < n_poses,
        points=(pts_w + rng.normal(0, 0.2, pts_w.shape)).astype(np.float32),
        point_valid=rng.uniform(size=n_points) > 0.1,
        obs_kf=np.repeat(np.arange(slots, dtype=np.int32), n_points),
        obs_lm=np.tile(np.arange(n_points, dtype=np.int32), slots),
        obs_z=np.concatenate([o[0] for o in obs]
                             + [np.zeros(((slots - n_poses) * n_points, 3), np.float32)]),
        obs_valid=np.concatenate([o[1] for o in obs]
                                 + [np.zeros((slots - n_poses) * n_points, bool)]),
    ), n_obs


def _both(fields):
    t = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    j = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    return t, j


def test_empty_problem_matches_jax():
    t, j = tba.empty_problem(3, 5, 7, "cpu"), jba.empty_problem(3, 5, 7)
    for name in tba.BAProblem._fields:
        got, ref = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("model", ["stereo", "rgbd"])
def test_observation_terms_match_jax(rng, model):
    fields, _ = _problem(rng, model)
    t, j = _both(fields)
    got = tba._observation_terms(t.poses, t.points, t, CAMS[model], model, 25.0, 2.0)
    ref = jba._observation_terms(j.poses, j.points, j, JCamera(*CAMS[model]), model,
                                 25.0, 2.0)
    for name, g, r in zip(("r", "Jp", "Jl", "w", "chi_total"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("model", ["stereo", "rgbd"])
@pytest.mark.parametrize("structure_only", [True, False])
def test_optimize_matches_jax(rng, model, structure_only):
    fields, _ = _problem(rng, model)
    t, j = _both(fields)
    kw = dict(iterations=5, structure_only=structure_only,
              depth_weight=1.0 if model == "stereo" else 10.0)
    t_out, t_chi = tba.optimize(t, CAMS[model], model, tba.BAConfig(**kw))
    j_out, j_chi = jba.optimize(j, JCamera(*CAMS[model]), model, jba.BAConfig(**kw))
    np.testing.assert_allclose(t_out.points.numpy(), np.asarray(j_out.points), atol=1e-3)
    np.testing.assert_allclose(t_out.poses.numpy(), np.asarray(j_out.poses), atol=1e-4)
    np.testing.assert_allclose(float(t_chi), float(j_chi), rtol=1e-3)
    moved = np.abs(t_out.points.numpy() - fields["points"]).max(1) > 1e-3
    assert moved.sum() > 100                          # BA did refine
    assert not moved[~fields["point_valid"]].any()    # masked points stay
    if structure_only:
        np.testing.assert_array_equal(t_out.poses.numpy(), fields["poses"])
    else:
        np.testing.assert_allclose(t_out.poses.numpy()[0], fields["poses"][0], atol=1e-4)


def _walk(rng):
    """tests/test_slam.py's world and an out-and-back walk along z, as
    stereo rows."""
    cam = CAMS["stereo"]
    n = 500
    pts_w = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                      rng.uniform(2, 40, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for i, z in enumerate(list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))):
        p = pts_w + np.array([0.0, 0.0, -z], np.float32)
        zs = np.maximum(p[:, 2], 0.5)
        u = cam.fx * p[:, 0] / zs + cam.cx
        v = cam.fy * p[:, 1] / zs + cam.cy
        ur = u - cam.baseline_px / zs
        ok = (p[:, 2] > 0.5) & (u >= 0) & (u < cam.cols) & (v >= 0) & (v < cam.rows) & (ur >= 0)
        frames.append((np.stack([u, v, ur, v], 1).astype(np.float32), desc, ok, 0.1 * i))
    return frames


def test_graphslam_local_ba_matches_jax(rng):
    kw = dict(arena_capacity=1024, max_local_maps=32, max_edges=64, database_capacity=16384)
    lba = dict(enabled=True, max_keyframes=4, keyframe_stride=1)
    j = js.GraphSLAM(JCamera(*CAMS["stereo"]), js.GraphSLAMConfig(
        splitting=js.SplittingConfig(maximum_translation_m=0.6),
        loop=JLoopCfg(minimum_age_difference=3, minimum_matches=25),
        local_ba=js.LocalBAConfig(**lba), **kw))
    t = ts.GraphSLAM(CAMS["stereo"], ts.GraphSLAMConfig(
        splitting=ts.SplittingConfig(maximum_translation_m=0.6),
        loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25),
        local_ba=ts.LocalBAConfig(**lba), **kw), device="cpu")
    calls = []
    real = ts.GraphSLAM._run_local_ba

    def counted(self):
        before = self.tracker_state.arena.pos.clone()
        real(self)
        calls.append(float((self.tracker_state.arena.pos - before).abs().max()))

    rows = []
    ts.GraphSLAM._run_local_ba = counted
    try:
        for p, d, ok, stamp in _walk(rng):
            j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
            t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
            rows.append(((j.status, j.current_map), (t.status, t.current_map)))
    finally:
        ts.GraphSLAM._run_local_ba = real
    assert [r[1] for r in rows] == [r[0] for r in rows]
    keys = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections")
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert t.closure_events == j.closure_events and t.num_closures >= 1
    assert len(calls) >= 3 and max(calls) > 1e-4       # BA ran at splits and moved points
    # the finished maps' arenas: refined at their split (and merged into
    # at a relocalisation)
    assert sorted(t._map_arenas) == sorted(j._map_arenas)
    for mid, arena in t._map_arenas.items():
        np.testing.assert_allclose(arena.pos.cpu().numpy(),
                                   np.asarray(j._map_arenas[mid].pos), atol=1e-3,
                                   err_msg=f"map {mid}")
    d_t, d_ang = tse3.error_t_and_angle(
        torch.from_numpy(np.stack(t.trajectory())),
        torch.from_numpy(np.stack(j.trajectory()).astype(np.float32)))
    assert float(d_t.max()) <= POSE_TOL and float(d_ang.max()) <= POSE_TOL
