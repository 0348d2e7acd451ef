"""Port EKF merge and arena insertion == the JAX package after a script.

A scripted sequence — insert candidates, update matched landmarks from a
moving sensor pose, insert again into a nearly full arena — runs through
both packages from the same numpy inputs.  Insertion is exact (slots,
descriptors, flags); EKF states agree to f32 rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.io.datasets import kitti_camera as j_kitti_camera  # noqa: E402
from srrg2_proslam_tpu.models import landmarks as jlm  # noqa: E402
from srrg2_proslam_tpu.ops import ekf as jekf, se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch.io.datasets import kitti_camera  # noqa: E402
from srrg2_proslam_tpu_torch.models import landmarks as tlm  # noqa: E402
from srrg2_proslam_tpu_torch.ops import ekf as tekf  # noqa: E402

CAM = kitti_camera()
JCAM = j_kitti_camera()


def _arena_equal(t_arena, j_arena, atol=0.0):
    for name in ("desc", "num_updates", "valid"):
        np.testing.assert_array_equal(getattr(t_arena, name).numpy(),
                                      np.asarray(getattr(j_arena, name)), err_msg=name)
    for name in ("pos", "cov"):
        np.testing.assert_allclose(getattr(t_arena, name).numpy(),
                                   np.asarray(getattr(j_arena, name)), atol=atol,
                                   rtol=1e-5 if atol else 0, err_msg=name)


def _candidates(rng, n):
    pos = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 60, n)], 1).astype(np.float32)
    cov = np.array(jekf.initial_covariance(jnp.asarray(pos[:, 2]), JCAM))
    desc = np.where(rng.uniform(size=(n, 256)) < 0.5, 1, -1).astype(np.int8)
    return pos, cov, desc


def _stereo_meas(pos_sensor, rng, noise=0.7):
    x, y, z = pos_sensor.T
    u_l = CAM.fx * x / z + CAM.cx
    v = CAM.fy * y / z + CAM.cy
    u_r = u_l - CAM.baseline_px / z
    z4 = np.stack([u_l, v, u_r, v], 1)
    return (z4 + rng.normal(0, noise, z4.shape)).astype(np.float32)


def test_initial_covariance_matches_jax(rng):
    depth = rng.uniform(0.05, 80, 200).astype(np.float32)
    np.testing.assert_allclose(
        tekf.initial_covariance(torch.from_numpy(depth), CAM).numpy(),
        np.asarray(jekf.initial_covariance(jnp.asarray(depth), JCAM)), rtol=1e-6)


@pytest.mark.parametrize("max_insertions", [512, 30])
def test_scripted_insert_update_insert(rng, max_insertions):
    M = 96
    ta, ja = tlm.empty_arena(M, "cpu"), jlm.empty_arena(M)
    _arena_equal(ta, ja)
    # 1. first insertion: 70 candidates, ~60% wanted
    pos, cov, desc = _candidates(rng, 70)
    want = rng.uniform(size=70) < 0.6
    ta = tlm.insert(ta, *map(torch.from_numpy, (pos, cov, desc, want)), max_insertions)
    ja = jlm.insert(ja, *map(jnp.asarray, (pos, cov, desc, want)), max_insertions)
    _arena_equal(ta, ja)
    # 2. EKF update from a moved sensor: noisy observations of half the arena,
    # plus gross outliers and rows of landmarks that do not exist
    xi = np.array([0.05, -0.02, 0.8, 0.003, -0.01, 0.002], np.float32)
    T_ws = np.array(jse3.inverse(jse3.exp(jnp.asarray(xi))))
    p_s = np.asarray(jse3.transform_points(jnp.asarray(T_ws), jnp.asarray(np.asarray(ja.pos))))
    z = _stereo_meas(np.where(p_s[:, 2:] > 0.5, p_s, 1.0), rng)
    z[:5] += 300.0
    valid = (rng.uniform(size=M) < 0.5) & np.asarray(ja.valid)
    valid[-3:] = True   # empty slots observed: the update runs on zeros
    upd_t = tekf.ekf_update_batch(ta.pos, ta.cov, torch.from_numpy(z), torch.from_numpy(valid),
                                  torch.from_numpy(T_ws), CAM, "stereo", tekf.LandmarkEKFConfig())
    upd_j = jekf.ekf_update_batch(ja.pos, ja.cov, jnp.asarray(z), jnp.asarray(valid),
                                  jnp.asarray(T_ws), JCAM, "stereo", jekf.LandmarkEKFConfig())
    np.testing.assert_array_equal(upd_t.accepted.numpy(), np.asarray(upd_j.accepted))
    assert 5 < int(upd_t.accepted.sum()) < int(valid.sum())
    np.testing.assert_allclose(upd_t.position.numpy(), np.asarray(upd_j.position),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(upd_t.covariance.numpy(), np.asarray(upd_j.covariance),
                               rtol=1e-4, atol=1e-6)
    ta = ta._replace(pos=upd_t.position, cov=upd_t.covariance,
                     num_updates=ta.num_updates + upd_t.accepted.to(torch.int32))
    ja = ja._replace(pos=upd_j.position, cov=upd_j.covariance,
                     num_updates=ja.num_updates + upd_j.accepted.astype(jnp.int32))
    # 3. second insertion into the remaining free slots (more candidates
    # than free slots), after freeing a few slots
    free = np.zeros(M, bool)
    free[[0, 7, 8]] = True
    ta = ta._replace(valid=ta.valid & ~torch.from_numpy(free))
    ja = ja._replace(valid=ja.valid & ~jnp.asarray(free))
    pos, cov, desc = _candidates(rng, 80)
    want = rng.uniform(size=80) < 0.9
    ta = tlm.insert(ta, *map(torch.from_numpy, (pos, cov, desc, want)), max_insertions)
    ja = jlm.insert(ja, *map(jnp.asarray, (pos, cov, desc, want)), max_insertions)
    _arena_equal(ta, ja, atol=1e-5)
    assert int(ta.count) == int(ja.count)


def test_unknown_model_is_not_ported():
    a = tlm.empty_arena(4, "cpu")
    with pytest.raises(NotImplementedError):
        tekf.ekf_update_batch(a.pos, a.cov, torch.zeros(4, 2), a.valid, torch.eye(4),
                              CAM, "fisheye", tekf.LandmarkEKFConfig())
