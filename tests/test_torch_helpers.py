"""The port's remaining ops helpers, the EKF "projective" model, the sparse
stereo ground truth, ``device_trace``, the viewer and ``entry()`` == the
JAX package's, on the CPU.

Bounds: the Hamming packers, ``sparse_stereo_gt`` and the entry's example
inputs bit-exact; SE3 and projection helpers to f32 rounding (atol 1e-6,
as tests/test_torch_geometry.py); ``gn_step`` at tests/test_torch_gn.py's
1e-5; one projective EKF update to f32 rounding (1e-5) and the port's
filter under tests/test_ekf.py's protocol within its bound (median error
< 0.3 m); the viewer's snapshot within 1e-5 after the same run; the
entry's tracker step within 5e-4 (tests/test_gn_pallas.py's GN bound).
"""
import json
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

import __graft_entry__ as jentry  # noqa: E402
from srrg2_proslam_tpu import viz as jviz  # noqa: E402
from srrg2_proslam_tpu.io import synthetic as jsyn  # noqa: E402
from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402
from srrg2_proslam_tpu.ops import ekf as jekf, gn as jgn, hamming as jham  # noqa: E402
from srrg2_proslam_tpu.ops import pinhole as jp, se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch import entry as tentry, viz as tviz  # noqa: E402
from srrg2_proslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import ekf as tekf, gn as tgn, hamming as tham  # noqa: E402
from srrg2_proslam_tpu_torch.ops import pinhole as tp, se3 as tse3  # noqa: E402
from srrg2_proslam_tpu_torch.utils import profiling as tprof  # noqa: E402
from tests.test_torch_slam import CAM, _config, _scenario  # noqa: E402

ATOL = 1e-6
EKF_CAM_T = tp.Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600,
                      baseline_px=250.0)
EKF_CAM_J = jp.Camera(*EKF_CAM_T)
EKF_CFG = dict(maximum_distance_geometry_m2=100.0, maximum_covariance_norm_squared=1e6)


def _twists(rng, n, rot=0.3):
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= rot
    return xi


def test_se3_helpers_match_jax(rng):
    T = np.array(jse3.exp(jnp.asarray(_twists(rng, 64))))
    U = np.array(jse3.exp(jnp.asarray(_twists(rng, 64))))
    Tt, Ut = torch.from_numpy(T), torch.from_numpy(U)
    np.testing.assert_array_equal(tse3.rotation(Tt).numpy(), np.asarray(jse3.rotation(T)))
    np.testing.assert_array_equal(tse3.translation(Tt).numpy(),
                                  np.asarray(jse3.translation(T)))
    np.testing.assert_allclose(tse3.compose(Tt, Ut).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(T), jnp.asarray(U))),
                               atol=ATOL, rtol=1e-5)
    # rotation blocks off SO(3) by up to 1e-2 per entry
    noisy = T.copy()
    noisy[:, :3, :3] += rng.normal(0, 1e-2, (64, 3, 3)).astype(np.float32)
    n_t = tse3.normalize(torch.from_numpy(noisy)).numpy()
    n_j = np.asarray(jse3.normalize(jnp.asarray(noisy)))
    np.testing.assert_allclose(n_t, n_j, atol=ATOL, rtol=1e-5)
    R = n_t[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_project_stereo_matches_jax(rng):
    pts = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-5, 400, 500)
    pts[:3, 2] = [0.0, 1e-10, -1e-10]      # z_safe branch
    uvu_t, in_t = tp.project_stereo(EKF_CAM_T, torch.from_numpy(pts))
    uvu_j, in_j = jp.project_stereo(EKF_CAM_J, jnp.asarray(pts))
    np.testing.assert_allclose(uvu_t.numpy(), np.asarray(uvu_j), rtol=1e-6)
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))


def test_hamming_helpers_match_jax(rng):
    bits = rng.randint(0, 2, (50, 256)).astype(np.uint8)
    words_t = tham.pack_bits(torch.from_numpy(bits))
    words_j = np.asarray(jham.pack_bits(jnp.asarray(bits)))
    assert words_t.dtype == torch.uint32
    np.testing.assert_array_equal(words_t.to(torch.int64).numpy(), words_j.astype(np.int64))
    np.testing.assert_array_equal(tham.unpack_bits(words_t).numpy(),
                                  np.asarray(jham.unpack_bits(jnp.asarray(words_j))))
    np.testing.assert_array_equal(tham.unpack_bits(words_t).numpy(), bits)
    signed_t = tham.bits_to_signed(torch.from_numpy(bits))
    np.testing.assert_array_equal(signed_t.numpy(),
                                  np.asarray(jham.bits_to_signed(jnp.asarray(bits))))
    np.testing.assert_array_equal(tham.signed_to_bits(signed_t).numpy(),
                                  np.asarray(jham.signed_to_bits(jnp.asarray(signed_t.numpy()))))
    other = rng.choice(np.array([-1, 1], np.int8), size=(50, 256))
    np.testing.assert_array_equal(
        tham.pairwise_distance(signed_t, torch.from_numpy(other)).numpy(),
        np.asarray(jham.pairwise_distance(jnp.asarray(signed_t.numpy()), jnp.asarray(other))))


def test_gn_step_matches_jax(rng):
    A = rng.normal(0, 1, (6, 6)).astype(np.float32)
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    X = np.asarray(jse3.exp(jnp.asarray(_twists(rng, 1)[0] * 0.1)))
    np.testing.assert_allclose(
        tgn.gn_step(*map(torch.from_numpy, (X, H, b))).numpy(),
        np.asarray(jgn.gn_step(*map(jnp.asarray, (X, H, b)))), atol=1e-5)


def _ekf_landmarks(rng, n):
    z = rng.uniform(4.0, 15.0, n)
    u = rng.uniform(100, 500, n)
    v = rng.uniform(80, 320, n)
    return np.stack([(u - 300.0) / 450.0 * z, (v - 200.0) / 450.0 * z, z], 1).astype(np.float32)


def test_projective_ekf_update_matches_jax(rng):
    p_true = _ekf_landmarks(rng, 60)
    p = (p_true + rng.normal(0, 0.5, p_true.shape)).astype(np.float32)
    P = np.broadcast_to(np.eye(3, dtype=np.float32) * 4.0, (60, 3, 3)).copy()
    T = np.asarray(jse3.exp(jnp.asarray(np.array([0.1, -0.05, 0.2, 0.01, 0.02, -0.01],
                                                 np.float32))))
    uv = np.asarray(jp.project(EKF_CAM_J, jse3.transform_points(jnp.asarray(T),
                                                                 jnp.asarray(p_true)))[0])
    valid = rng.uniform(size=60) < 0.9
    r_t = tekf.ekf_update_batch(*map(torch.from_numpy, (p, P, uv, valid, T)), EKF_CAM_T,
                                "projective", tekf.LandmarkEKFConfig(**EKF_CFG))
    r_j = jekf.ekf_update_batch(*map(jnp.asarray, (p, P, uv, valid, T)), EKF_CAM_J,
                                "projective", jekf.LandmarkEKFConfig(**EKF_CFG))
    np.testing.assert_array_equal(r_t.accepted.numpy(), np.asarray(r_j.accepted))
    np.testing.assert_allclose(r_t.position.numpy(), np.asarray(r_j.position),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(r_t.covariance.numpy(), np.asarray(r_j.covariance),
                               atol=1e-5, rtol=1e-4)


def test_projective_ekf_reduces_error(rng):
    """tests/test_ekf.py's bearing-only protocol through the port: static
    landmarks seen from 30 moving cameras shrink the 0.5 m error."""
    p_true = _ekf_landmarks(rng, 50)
    p = torch.from_numpy((p_true + rng.randn(50, 3) * 0.5).astype(np.float32))
    P = torch.eye(3).expand(50, 3, 3) * 4.0
    cfg = tekf.LandmarkEKFConfig(**EKF_CFG)
    for _ in range(30):
        xi = np.concatenate([rng.randn(3) * 0.1, rng.randn(3) * 0.02]).astype(np.float32)
        T_ws = tse3.exp(torch.from_numpy(xi))
        uv, _ = tp.project(EKF_CAM_T, tse3.transform_points(T_ws, torch.from_numpy(p_true)))
        res = tekf.ekf_update_batch(p, P, uv, torch.ones(50, dtype=torch.bool), T_ws,
                                    EKF_CAM_T, "projective", cfg)
        p, P = res.position, res.covariance
    err = np.linalg.norm(p.numpy() - p_true, axis=1)
    assert np.median(err) < 0.3, np.median(err)


def test_sparse_stereo_gt_matches_jax(rng):
    cam = tsyn.synthetic_camera(60, 80)
    depth = rng.uniform(0.5, 30.0, (60, 80)).astype(np.float32)
    depth[5, 7] = np.inf
    uv = rng.uniform(-3, 85, (200, 2)).astype(np.float32)
    uv[0] = (7.2, 4.8)
    got = tsyn.sparse_stereo_gt(cam, depth, uv)
    np.testing.assert_array_equal(got, jsyn.sparse_stereo_gt(jsyn.synthetic_camera(60, 80),
                                                             depth, uv))
    assert got[0] == 0.0


def test_device_trace_writes_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def closure_runs():
    """tests/test_torch_slam.py's closure walk through both packages."""
    frames, kw = _scenario("closure")
    j = js.GraphSLAM(CAM, _config(js, JLoopCfg, kw))
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, kw), device="cpu")
    for p, d, ok, stamp in frames:
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
    return j, t


def test_snapshot_matches_jax(closure_runs):
    j, t = closure_runs
    sj, st = jviz.snapshot(j), tviz.snapshot(t)
    for key in ("status", "frames", "maps", "closures", "relocalizations", "closure_edges"):
        assert st[key] == sj[key], key
    assert st["closures"] >= 1 and st["closure_edges"]
    np.testing.assert_allclose(st["trajectory"], sj["trajectory"], atol=1e-5)
    np.testing.assert_allclose(st["landmarks"], sj["landmarks"], atol=1e-5)


def test_live_viewer_serves_state(closure_runs):
    _, t = closure_runs
    viewer = tviz.LiveViewer(port=0, quiet=True)
    try:
        viewer.update(t)
        state = json.loads(urllib.request.urlopen(viewer.url + "state.json",
                                                  timeout=10).read())
        assert state == json.loads(json.dumps(tviz.snapshot(t)))
        assert state["frames"] == len(t.frames) and len(state["landmarks"]) > 50
        page = urllib.request.urlopen(viewer.url, timeout=10).read()
        assert b"canvas" in page and b"state.json" in page
    finally:
        viewer.close()


def test_entry_example_args_equal_jax():
    cam = tentry.kitti_camera()
    j_state, *j_meas = jentry._synthetic_frame(512, 2048, cam)
    fn, (state, *meas) = tentry.entry(device="cpu")
    for t_arr, j_arr in zip(meas, j_meas):
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    for name in ("pos", "cov", "desc", "num_updates", "valid"):
        np.testing.assert_array_equal(getattr(state.arena, name).numpy(),
                                      np.asarray(getattr(j_state.arena, name)), err_msg=name)
    np.testing.assert_array_equal(state.T_lm_robot.numpy(), np.asarray(j_state.T_lm_robot))
    np.testing.assert_array_equal(state.velocity.numpy(), np.asarray(j_state.velocity))


def test_entry_step_matches_jax():
    j_fn, j_args = jentry.entry()
    j_state, j_stats, _ = j_fn(*j_args)
    fn, args = tentry.entry(device="cpu")
    t_state, t_stats, _ = fn(*args)
    assert int(t_stats.num_inliers) == int(j_stats.num_inliers) > 100
    np.testing.assert_allclose(t_state.T_lm_robot.numpy(), np.asarray(j_state.T_lm_robot),
                               atol=5e-4)
