"""Port landmark estimators and the motion prior == the JAX package, on the CPU.

``ops/landmark_estimators.py`` on a 300-slot arena of random landmarks:
the weighted mean within rtol 1e-6 with equal acceptance; the ring
buffer after 11 inserts into 8 slots (wrapping) within rtol 1e-6 with
equal counts; the smoother (buffers from noisy views of the landmarks,
some slots behind the camera, counts below, at and above the minimum)
with equal acceptance and inlier counts and positions within 1e-4 m.

``track_step`` with ``weighted_mean``, ``smoother`` and the EKF with the
motion prior (euroc_slam.json's 1.0 / 4.0) over 6 frames of a random
world seen by a moving stereo rig: every frame's counts equal, poses
within 5e-4, arenas within 1e-3 m, the smoother's buffers within 1e-4;
the state (with its buffers) survives ``state_to_numpy`` /
``state_from_numpy`` unchanged.

GraphSLAM with the smoother on the walk of tests/test_relocalization.py
(splits every 0.6 m, closures and a relocalisation, which zeroes the
buffers): the same per-frame status and map, counters and closure events
as JAX, the trajectory within 1e-3 m / 1e-3 rad and the final buffers
within 1e-3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import slam as js, tracker as jtr  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402
from srrg2_proslam_tpu.ops import landmark_estimators as jle, se3 as jse3  # noqa: E402
from srrg2_proslam_tpu.ops.pinhole import Camera as JCamera  # noqa: E402

from srrg2_proslam_tpu_torch.models import slam as ts, tracker as ttr  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import landmark_estimators as tle, se3 as tse3  # noqa: E402
from srrg2_proslam_tpu_torch.ops.pinhole import Camera  # noqa: E402

CAM = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
             baseline_px=450.0 * 0.5)
JCAM = JCamera(*CAM)
M = 300


def _buffers_close(t_buf, j_buf, atol):
    for name, g, r in zip(tle.MeasurementBuffer._fields, t_buf, j_buf):
        g, r = g.cpu().numpy(), np.asarray(r)
        assert g.dtype == r.dtype, name
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=atol, err_msg=name)


def test_weighted_mean_matches_jax(rng):
    pos = rng.uniform(-10, 10, (M, 3)).astype(np.float32)
    n = rng.randint(0, 20, M).astype(np.int32)
    meas = (pos + rng.normal(0, 3, (M, 3))).astype(np.float32)
    valid = rng.uniform(size=M) > 0.3
    cfg = dict(maximum_distance_geometry_m2=4.0)
    t = tle.weighted_mean_update_batch(*map(torch.from_numpy, (pos, n, meas, valid)),
                                       tle.WeightedMeanConfig(**cfg))
    j = jle.weighted_mean_update_batch(*map(jnp.asarray, (pos, n, meas, valid)),
                                       jle.WeightedMeanConfig(**cfg))
    np.testing.assert_array_equal(t.accepted.numpy(), np.asarray(j.accepted))
    np.testing.assert_allclose(t.position.numpy(), np.asarray(j.position), rtol=1e-6)
    assert 0 < t.accepted.sum() < valid.sum()          # the gate refused some


def _views(rng, pos, k):
    """Frame k's world->camera transform and the landmarks seen from it:
    (T [4, 4], uv [M, 2], p_cam [M, 3])."""
    xi = np.array([0.1 * k, 0.02 * k, -0.3 * k, 0.01 * k, -0.02 * k, 0.0], np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    p_c = pos @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(p_c[:, 2], 1e-3)
    uv = np.stack([CAM.fx * p_c[:, 0] / z + CAM.cx, CAM.fy * p_c[:, 1] / z + CAM.cy], 1)
    noise = rng.normal(0, 1.0, (M, 3)) * [1, 1, 0.05]
    return (T, (uv + noise[:, :2]).astype(np.float32),
            (p_c + noise * [0, 0, 1]).astype(np.float32))


def _buffer_run(rng, frames):
    """Both packages' buffers after ``frames`` inserts (observed at random)."""
    pos = np.stack([rng.uniform(-6, 6, M), rng.uniform(-3, 3, M),
                    rng.uniform(3, 20, M)], 1).astype(np.float32)
    pos[:10, 2] = -2.0                      # behind every camera: no valid slot
    t_buf = tle.empty_measurement_buffer(M, 8, "cpu")
    j_buf = jle.empty_measurement_buffer(M, 8)
    for k in range(frames):
        T, uv, p_cam = _views(rng, pos, k)
        obs = rng.uniform(size=M) > 0.25
        t_buf = tle.add_measurements(t_buf, *(torch.from_numpy(np.array(a))
                                              for a in (uv, p_cam, T, obs)))
        j_buf = jle.add_measurements(j_buf, *map(jnp.asarray, (uv, p_cam, T, obs)))
    return pos, t_buf, j_buf


def test_measurement_buffer_matches_jax(rng):
    t, j = tle.empty_measurement_buffer(M, 8, "cpu"), jle.empty_measurement_buffer(M, 8)
    _buffers_close(t, j, 0.0)
    assert t.T_world_to_cam.is_contiguous()      # a real identity per slot, not a view
    _, t_buf, j_buf = _buffer_run(rng, 11)       # the ring wraps
    _buffers_close(t_buf, j_buf, 0.0)
    assert int(t_buf.count.max()) > 8


@pytest.mark.parametrize("frames", [2, 6, 11])
def test_smoother_matches_jax(rng, frames):
    pos, t_buf, j_buf = _buffer_run(rng, frames)
    start = (pos + rng.normal(0, 0.3, pos.shape)).astype(np.float32)
    n_upd = rng.randint(0, 6, M).astype(np.int32)
    lm_valid = rng.uniform(size=M) > 0.1
    cfg = dict(minimum_measurements=3, iterations=10)
    t = tle.smoother_update_batch(torch.from_numpy(start), t_buf, torch.from_numpy(n_upd),
                                  torch.from_numpy(lm_valid), CAM, tle.SmootherConfig(**cfg))
    j = jle.smoother_update_batch(jnp.asarray(start), j_buf, jnp.asarray(n_upd),
                                  jnp.asarray(lm_valid), JCAM, jle.SmootherConfig(**cfg))
    np.testing.assert_array_equal(t.accepted.numpy(), np.asarray(j.accepted))
    np.testing.assert_array_equal(t.num_inliers.numpy(), np.asarray(j.num_inliers))
    np.testing.assert_allclose(t.position.numpy(), np.asarray(j.position), atol=1e-4)
    assert t.accepted.any()


def _stereo_frames(rng, n=400, count=6):
    """A random world seen by a stereo rig moving 0.3 m per frame along z
    with a slow yaw: (points [n, 4], desc, valid) numpy per frame."""
    pts_w = np.stack([rng.uniform(-12, 12, n), rng.uniform(-4, 4, n),
                      rng.uniform(3, 35, n)], 1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for k in range(count):
        T_wc = np.asarray(jse3.exp(jnp.asarray(
            np.array([0.0, 0.0, -0.3 * k, 0.0, 0.01 * k, 0.0], np.float32))))
        p = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
        z = np.maximum(p[:, 2], 0.5)
        u = CAM.fx * p[:, 0] / z + CAM.cx
        v = CAM.fy * p[:, 1] / z + CAM.cy
        ur = u - CAM.baseline_px / z
        noise = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
        rows = np.stack([u + noise[:, 0], v + noise[:, 1], ur + noise[:, 2],
                         v + noise[:, 1]], 1).astype(np.float32)
        ok = (p[:, 2] > 0.5) & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows) & (ur >= 0)
        frames.append((rows, desc, ok))
    return frames


KEYS = ("num_matches", "num_inliers", "num_merges", "num_additions", "matcher_stage")


@pytest.mark.parametrize("kw", [
    dict(landmark_estimator="weighted_mean"),
    dict(landmark_estimator="smoother"),
    dict(motion_prior_translation_info=1.0, motion_prior_rotation_info=4.0),
], ids=["weighted_mean", "smoother", "motion_prior"])
def test_track_step_matches_jax(rng, kw):
    est = kw.get("landmark_estimator", "ekf")
    t_state = ttr.initial_state(1024, est, device="cpu")
    j_state = jtr.initial_state(1024, est)
    for k, (p, d, ok) in enumerate(_stereo_frames(rng)):
        t_state, t_st, t_X = ttr.track_step(t_state, *map(torch.from_numpy, (p, d, ok)), CAM,
                                            ttr.TrackerConfig(**kw), "stereo")
        j_state, j_st, j_X = jtr.track_step(j_state, *map(jnp.asarray, (p, d, ok)), JCAM,
                                            jtr.TrackerConfig(**kw), "stereo")
        assert {n: int(getattr(t_st, n)) for n in KEYS} == \
            {n: int(getattr(j_st, n)) for n in KEYS}, k
        np.testing.assert_allclose(t_X.numpy(), np.asarray(j_X), atol=5e-4)
        np.testing.assert_allclose(t_state.T_lm_robot.numpy(), np.asarray(j_state.T_lm_robot),
                                   atol=5e-4)
    assert int(t_st.num_inliers) > 100 and int(t_st.num_merges) > 50
    np.testing.assert_array_equal(t_state.arena.valid.numpy(), np.asarray(j_state.arena.valid))
    np.testing.assert_array_equal(t_state.arena.num_updates.numpy(),
                                  np.asarray(j_state.arena.num_updates))
    np.testing.assert_allclose(t_state.arena.pos.numpy(), np.asarray(j_state.arena.pos),
                               atol=1e-3)
    if est == "smoother":
        _buffers_close(t_state.meas_buf, j_state.meas_buf, 1e-4)
    else:
        assert t_state.meas_buf is None and j_state.meas_buf is None
    d = ttr.state_to_numpy(t_state)
    back = ttr.state_to_numpy(ttr.state_from_numpy(d, "cpu"))
    assert back.keys() == d.keys() and ("meas_buf.count" in d) == (est == "smoother")
    for key, val in d.items():
        assert back[key].dtype == val.dtype, key
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def _walk(rng):
    """tests/test_relocalization.py's world and out-and-back walk."""
    n = 500
    pts_w = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                      rng.uniform(2, 40, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for i, z in enumerate(list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))):
        p = pts_w + np.array([0.0, 0.0, -z], np.float32)
        zs = np.maximum(p[:, 2], 0.5)
        u = CAM.fx * p[:, 0] / zs + CAM.cx
        v = CAM.fy * p[:, 1] / zs + CAM.cy
        ur = u - CAM.baseline_px / zs
        ok = (p[:, 2] > 0.5) & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows) & (ur >= 0)
        frames.append((np.stack([u, v, ur, v], 1).astype(np.float32), desc, ok, 0.1 * i))
    return frames


def test_graphslam_smoother_matches_jax(rng):
    kw = dict(arena_capacity=1024, max_local_maps=32, max_edges=64, database_capacity=16384)
    j = js.GraphSLAM(JCAM, js.GraphSLAMConfig(
        tracker=jtr.TrackerConfig(landmark_estimator="smoother"),
        splitting=js.SplittingConfig(maximum_translation_m=0.6),
        loop=JLoopCfg(minimum_age_difference=3, minimum_matches=25), **kw))
    t = ts.GraphSLAM(CAM, ts.GraphSLAMConfig(
        tracker=ttr.TrackerConfig(landmark_estimator="smoother"),
        splitting=ts.SplittingConfig(maximum_translation_m=0.6),
        loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25), **kw),
        device="cpu")
    rows, zeroed = [], []
    for p, d, ok, stamp in _walk(rng):
        relocs = t.num_relocalizations
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        rows.append(((j.status, j.current_map), (t.status, t.current_map)))
        if t.num_relocalizations > relocs:
            buf = t.tracker_state.meas_buf
            zeroed.append(all(not x.any() for x in buf))
    assert [r[1] for r in rows] == [r[0] for r in rows]
    keys = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections")
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert t.closure_events == j.closure_events
    # the relocalisation leaves zeroed buffers: T_world_to_cam slots 0, not identity
    assert t.num_relocalizations >= 1 and zeroed == [True] * len(zeroed)
    d_t, d_ang = tse3.error_t_and_angle(
        torch.from_numpy(np.stack(t.trajectory())),
        torch.from_numpy(np.stack(j.trajectory()).astype(np.float32)))
    assert float(d_t.max()) <= 1e-3 and float(d_ang.max()) <= 1e-3
    _buffers_close(t.tracker_state.meas_buf, j.tracker_state.meas_buf, 1e-3)
