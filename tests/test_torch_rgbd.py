"""The port's RGB-D path == the JAX package, on the CPU.

Readers: ``load_gray`` and ``load_depth`` bit-exact with the JAX
package's on every bundled ICL and xtion file (RGB PNGs to gray as its
native decoder computes it, 16-bit big-endian PGMs, one with a comment
line); ``icl_camera`` (fy = -481), ``iter_bundled_icl`` and the
quaternion helpers equal.

The ICL frames at full size (480x640, 1152 keypoints): ``adapt_rgbd``
bit-exact (points, descriptors, valid) on frames 0 and 1; frames 0 -> 1
through ``GraphSLAM(model="rgbd")`` at the default config within 5e-3 m
per axis and 0.01 rad of the fixture's camera_01_in_00, with JAX's
measurement, inlier, merge and addition counts and its pose within 5e-4.

Factors: ``projective_depth_system`` (H, b within 1e-5 of their largest
entry, stats exact) and the "projective_depth" EKF (positions within 1e-4 m,
covariances within 5e-3 of each one's largest entry, acceptance equal) against JAX on random problems; ``gn_iterate(unroll=True)``, the
tracker's route for RGB-D and the motion prior, equal select for select
(bit for bit) to the early-exit loop, and within 5e-4 of JAX.

GraphSLAM with ``model="rgbd"`` on a random world seen through ICL's
intrinsics by an out-and-back walk (splits every 0.6 m, closures and a
relocalisation): the same per-frame status and map, counters and closure
events as JAX, the trajectory within 1e-3 m / 1e-3 rad.

The slow test runs the rendered closed loop of tests/test_rendered_e2e.py
as RGB-D (the left image and its depth in millimetres, 0 where no plane
is hit) through both packages: the same per-frame status and map and the
port within that test's gates.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import datasets as jds, quaternions as jq  # noqa: E402
from srrg2_proslam_tpu.models import frontend as jfe, slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402
from srrg2_proslam_tpu.ops import ekf as jekf, gn as jgn, se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets, quaternions  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import ekf as tekf, gn as tgn, se3 as tse3  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")
CAM = datasets.icl_camera()
JCAM = jds.icl_camera()
FILES = sorted(os.path.join(d, f) for d in ("icl", "xtion")
               for f in os.listdir(os.path.join(DATA, d)))


@pytest.mark.parametrize("name", FILES)
def test_readers_bit_exact(name):
    path = os.path.join(DATA, name)
    load = "load_depth" if "depth" in name else "load_gray"
    got, ref = getattr(datasets, load)(path), getattr(jds, load)(path)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    assert got.std() > 1.0


def test_icl_camera_frames_and_quaternions(rng):
    assert tuple(CAM) == tuple(JCAM) and CAM.fy < 0
    for a, b in zip(datasets.iter_bundled_icl(DATA), jds.iter_bundled_icl(DATA)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(a.depth, b.depth)
    for _ in range(20):
        q = rng.normal(size=4)
        R = jq.quaternion_to_rotation(q)
        np.testing.assert_array_equal(quaternions.quaternion_to_rotation(q), R)
        np.testing.assert_array_equal(quaternions.rotation_to_quaternion(R),
                                      jq.rotation_to_quaternion(R))


def _pose(t, q_wxyz):
    T = np.eye(4, dtype=np.float32)
    w, x, y, z = q_wxyz
    T[:3, :3] = quaternions.quaternion_to_rotation(np.array([x, y, z, w]))
    T[:3, 3] = t
    return T


# the fixture's camera-in-world poses (tests/test_rgbd_integration.py)
GT_C1_IN_C0 = np.linalg.inv(_pose([0.0, 0.0, -2.25], [1.0, 0.0, 0.0, 0.0])) @ _pose(
    [0.000466347, 0.00895357, -2.24935], [0.999999, -0.00101358, 0.00052453, -0.000231475])
COUNTS = ("num_measurements", "num_inliers", "num_merges", "num_additions", "num_matches")


@pytest.fixture(scope="module")
def icl_runs():
    """ICL frames 0 and 1 through adapt_rgbd -> GraphSLAM(model="rgbd") in
    both packages at the default configs."""
    frames = list(datasets.iter_bundled_icl(DATA))[:2]
    j = js.GraphSLAM(JCAM, js.GraphSLAMConfig(), model="rgbd")
    t = ts.GraphSLAM(CAM, ts.GraphSLAMConfig(), model="rgbd", device="cpu")
    out = {"j_meas": [], "t_meas": [], "j_counts": [], "t_counts": []}
    for i, fr in enumerate(frames):
        jm = jfe.adapt_rgbd(jnp.asarray(fr.intensity), jnp.asarray(fr.depth),
                            jfe.DepthAdaptorConfig())
        tm = frontend.adapt_rgbd(torch.from_numpy(fr.intensity), torch.from_numpy(fr.depth),
                                 frontend.DepthAdaptorConfig())
        js_ = j.process(jm.points, jm.desc, jm.valid, float(i))
        ts_ = t.process(tm.points, tm.desc, tm.valid, float(i))
        out["j_meas"].append([np.asarray(a) for a in jm])
        out["t_meas"].append([a.numpy() for a in tm])
        out["j_counts"].append({k: int(getattr(js_, k)) for k in COUNTS})
        out["t_counts"].append({k: int(getattr(ts_, k)) for k in COUNTS})
    out["j_pose"], out["t_pose"] = j.robot_in_world(), t.robot_in_world()
    out["status"] = (j.status, t.status)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_adapt_rgbd_bit_exact(icl_runs, i):
    for name, got, ref in zip(("points", "desc", "valid"), icl_runs["t_meas"][i],
                              icl_runs["j_meas"][i]):
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=f"frame {i} {name}")
    assert icl_runs["t_meas"][i][2].sum() > 300


def test_icl_frames_meet_the_fixture(icl_runs):
    assert icl_runs["t_counts"] == icl_runs["j_counts"]
    assert icl_runs["t_counts"][1]["num_inliers"] > 30
    assert icl_runs["status"] == (ts.TRACKING, ts.TRACKING)
    np.testing.assert_allclose(icl_runs["t_pose"], icl_runs["j_pose"], atol=5e-4)
    t_err, ang = tse3.error_t_and_angle(torch.from_numpy(icl_runs["t_pose"].astype(np.float32)),
                                        torch.from_numpy(GT_C1_IN_C0.astype(np.float32)))
    assert float(t_err.max()) < 5e-3 and float(ang) < 1e-2


def _depth_problem(rng, n=300):
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(1, 6, n)], 1).astype(np.float32)
    X_gt = np.asarray(jse3.exp(jnp.asarray(
        np.array([0.05, -0.02, 0.1, 0.01, -0.02, 0.015], np.float32))))
    p = pts @ X_gt[:3, :3].T + X_gt[:3, 3]
    meas = np.stack([CAM.fx * p[:, 0] / p[:, 2] + CAM.cx, CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
                     p[:, 2]], 1) + rng.normal(0, [0.5, 0.5, 0.01], (n, 3))
    meas[:20] += rng.uniform(20, 60, (20, 3))          # outliers
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return pts, meas.astype(np.float32), w, mask


def test_projective_depth_system_matches_jax(rng):
    pts, meas, w, mask = _depth_problem(rng)
    X = np.asarray(jse3.exp(jnp.asarray(np.array([0.03, 0.0, 0.05, 0.0, -0.01, 0.01],
                                                  np.float32))))
    H, b, st = tgn.projective_depth_system(
        torch.from_numpy(X.copy()), *map(torch.from_numpy, (pts, meas, w, mask)), CAM, 25.0)
    Hj, bj, stj = jgn.projective_depth_system(
        jnp.asarray(X), *map(jnp.asarray, (pts, meas, w, mask)), JCAM, 25.0)
    # f32 sums of ~300 terms: entries agree to 1e-5 of the largest one
    for got, ref in ((H, Hj), (b, bj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert int(st.num_inliers) == int(stj.num_inliers) and int(st.num_terms) == int(stj.num_terms)
    np.testing.assert_allclose(float(st.chi_total), float(stj.chi_total), rtol=1e-5)


def test_ekf_projective_depth_matches_jax(rng):
    n = 300
    pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(1, 8, n)], 1).astype(np.float32)
    cov = np.array(jekf.initial_covariance(jnp.asarray(pos[:, 2]), JCAM))
    T = np.array(jse3.exp(jnp.asarray(np.array([0.1, 0.0, -0.2, 0.0, 0.03, 0.0],
                                                 np.float32))))
    p = pos @ T[:3, :3].T + T[:3, 3]
    z = np.stack([CAM.fx * p[:, 0] / p[:, 2] + CAM.cx, CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
                  p[:, 2]], 1) + rng.normal(0, [0.7, 0.7, 0.05], (n, 3))
    z[:15] += 200.0                                     # refused by the gates
    valid = rng.uniform(size=n) > 0.2
    args = (pos, cov, z.astype(np.float32), valid, T)
    cfg = dict(maximum_distance_geometry_m2=1.0)
    got = tekf.ekf_update_batch(*map(torch.from_numpy, args), CAM, "projective_depth",
                                tekf.LandmarkEKFConfig(**cfg))
    ref = jekf.ekf_update_batch(*map(jnp.asarray, args), JCAM, "projective_depth",
                                jekf.LandmarkEKFConfig(**cfg))
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(ref.accepted))
    assert 0 < got.accepted.sum() < valid.sum()
    np.testing.assert_allclose(got.position.numpy(), np.asarray(ref.position), atol=1e-4)
    # the RGB-D prior variance of depth is d^4 (no baseline): the f32
    # posteriors agree to 5e-3 of each landmark's largest entry
    ref_cov = np.asarray(ref.covariance)
    scale = np.abs(ref_cov).max((1, 2), keepdims=True)
    assert (np.abs(got.covariance.numpy() - ref_cov) <= 5e-3 * scale).all()


@pytest.mark.parametrize("eps,n_valid,prior", [
    (0.0, None, False), (1e-5, None, False), (1e-2, None, False), (0.0, 4, False),
    (1e-5, None, True)], ids=["eps0", "eps1e-5", "eps1e-2", "below-min-inliers", "prior"])
def test_sticky_gn_is_the_early_exit_loop(rng, eps, n_valid, prior):
    """gn_iterate(unroll=True) == gn_iterate select for select, over the
    depth factor (with the tracker's motion-prior wrapper in one case)."""
    pts, meas, w, mask = _depth_problem(rng)
    if n_valid is not None:
        mask[:] = np.arange(mask.size) < n_valid
    tp = tuple(map(torch.from_numpy, (pts, meas, w, mask)))
    X_pred = tse3.exp(torch.tensor([0.01, 0.0, 0.02, 0.0, 0.0, 0.005]))
    prior_w = torch.tensor([1.0] * 3 + [4.0] * 3)

    def system(X):
        H, b, st = tgn.projective_depth_system(X, *tp, CAM, 25.0)
        if prior:
            return H + torch.diag(prior_w), b + prior_w * tse3.log(X @ tse3.inverse(X_pred)), st
        return H, b, st

    kw = dict(damping=1e-6, min_inliers=6, epsilon=eps)
    X_a, s_a = tgn.gn_iterate(system, tse3.identity("cpu"), 5, unroll=False, **kw)
    X_b, s_b = tgn.gn_iterate(system, tse3.identity("cpu"), 5, unroll=True, **kw)
    assert torch.equal(X_a, X_b)
    assert all(torch.equal(a, b) for a, b in zip(s_a, s_b))
    if not prior:
        jp = tuple(map(jnp.asarray, (pts, meas, w, mask)))
        X_j, s_j = jgn.gn_iterate(lambda X: jgn.projective_depth_system(X, *jp, JCAM, 25.0),
                                  jnp.eye(4), 5, **kw)
        np.testing.assert_allclose(X_b.numpy(), np.asarray(X_j), atol=5e-4)
        assert int(s_b.num_terms) == int(s_j.num_terms)
        assert abs(int(s_b.num_inliers) - int(s_j.num_inliers)) <= 1


def _rgbd_walk(rng):
    """A random world seen through ICL's intrinsics (fy < 0) from an
    out-and-back walk along z: (u, v, depth) rows per frame."""
    n = 500
    pts_w = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n),
                      rng.uniform(2, 18, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for i, z in enumerate(list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25))):
        p = pts_w + np.array([0.0, 0.0, -z], np.float32)
        zs = np.maximum(p[:, 2], 0.5)
        u = CAM.fx * p[:, 0] / zs + CAM.cx
        v = CAM.fy * p[:, 1] / zs + CAM.cy
        ok = (p[:, 2] > 0.5) & (u >= 0) & (u < CAM.cols) & (v >= 0) & (v < CAM.rows)
        frames.append((np.stack([u, v, p[:, 2]], 1).astype(np.float32), desc, ok, 0.1 * i))
    return frames


def test_graphslam_rgbd_matches_jax(rng):
    kw = dict(arena_capacity=1024, max_local_maps=32, max_edges=64, database_capacity=16384)
    j = js.GraphSLAM(JCAM, js.GraphSLAMConfig(
        splitting=js.SplittingConfig(maximum_translation_m=0.6),
        loop=JLoopCfg(minimum_age_difference=3, minimum_matches=25), **kw), model="rgbd")
    t = ts.GraphSLAM(CAM, ts.GraphSLAMConfig(
        splitting=ts.SplittingConfig(maximum_translation_m=0.6),
        loop=LoopDetectorConfig(minimum_age_difference=3, minimum_matches=25), **kw),
        model="rgbd", device="cpu")
    rows = []
    for p, d, ok, stamp in _rgbd_walk(rng):
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        rows.append(((j.status, j.current_map), (t.status, t.current_map)))
    assert [r[1] for r in rows] == [r[0] for r in rows]
    keys = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections")
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k) for k in keys}
    assert t.closure_events == j.closure_events
    assert t.num_closures >= 1 and t.num_relocalizations >= 1
    d_t, d_ang = tse3.error_t_and_angle(
        torch.from_numpy(np.stack(t.trajectory())),
        torch.from_numpy(np.stack(j.trajectory()).astype(np.float32)))
    assert float(d_t.max()) <= 1e-3 and float(d_ang.max()) <= 1e-3


@pytest.mark.slow
def test_rendered_loop_rgbd_port_matches_jax():
    """The 145-frame rendered loop (480x640) as RGB-D through both packages,
    with local BA on in both."""
    from srrg2_proslam_tpu.io import synthetic as jsyn
    from srrg2_proslam_tpu_torch.io import synthetic as tsyn
    from srrg2_proslam_tpu_torch.metrics import trajectory as ttm

    kw = dict(arena_capacity=4096, database_capacity=8192, max_db_descriptors_per_map=384)
    j = js.GraphSLAM(jsyn.synthetic_camera(), js.GraphSLAMConfig(
        splitting=js.SplittingConfig(maximum_translation_m=4.0, maximum_rotation_rad=0.35),
        loop=JLoopCfg(minimum_age_difference=3), local_ba=js.LocalBAConfig(enabled=True),
        **kw), model="rgbd")
    t = ts.GraphSLAM(tsyn.synthetic_camera(), ts.GraphSLAMConfig(
        splitting=ts.SplittingConfig(maximum_translation_m=4.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3),
        local_ba=ts.LocalBAConfig(enabled=True), **kw), model="rgbd", device="cpu")
    cam = jsyn.synthetic_camera()
    planes = jsyn.make_room(size_x=18.0, size_z=22.0)
    gt, rows = [], []
    for i, T_wc in enumerate(jsyn.loop_trajectory(10.0, 6.0, 0.4, 10)):
        left, _, depth = jsyn.render_stereo(cam, jnp.asarray(T_wc), planes)
        image = np.asarray(left)
        raw = tsyn.depth_to_raw_mm(torch.from_numpy(np.asarray(depth))).numpy()
        jm = jfe.adapt_rgbd(jnp.asarray(image), jnp.asarray(raw), jfe.DepthAdaptorConfig())
        j.process(jm.points, jm.desc, jm.valid, 0.1 * i)
        tm = frontend.adapt_rgbd(torch.from_numpy(image), torch.from_numpy(raw),
                                 frontend.DepthAdaptorConfig())
        t.process(tm.points, tm.desc, tm.valid, 0.1 * i)
        rows.append(((j.status, j.current_map), (t.status, t.current_map)))
        gt.append(np.linalg.inv(T_wc).astype(np.float32))
    assert [r[1] for r in rows] == [r[0] for r in rows]
    assert t.num_maps >= 10 and t.num_closures >= 1 and t.num_relocalizations >= 1
    err = ttm.evaluate(t.trajectory(), gt)
    assert np.all(err.mean_translation_rmse <= 0.30), err.mean_translation_rmse
    assert err.mean_rotation_deg <= 3.0 and err.ate_rmse <= 0.5
    d_t, d_ang = tse3.error_t_and_angle(torch.from_numpy(np.stack(t.trajectory())),
                                        torch.from_numpy(np.stack(j.trajectory())))
    assert float(d_t.max()) <= 1e-2 and float(d_ang.max()) <= 1e-3
