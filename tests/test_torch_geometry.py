"""Port geometry (se3, pinhole, triangulation) == the JAX functions.

Inputs are made with numpy from a seed and fed to both packages; float32
results agree to f32 rounding (atol 1e-6 on unit-scale values), including
the small-angle branches of exp/log that keep VO poses stable.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.ops import pinhole as jp, se3 as js  # noqa: E402
from srrg2_proslam_tpu.ops.triangulation import triangulate_rectified as j_tri  # noqa: E402

from srrg2_proslam_tpu_torch.ops import pinhole as tp, se3 as ts  # noqa: E402
from srrg2_proslam_tpu_torch.ops.triangulation import triangulate_rectified as t_tri  # noqa: E402

ATOL = 1e-6  # f32 rounding on unit-scale values

CAM_T = tp.Camera(fx=718.856, fy=718.856, cx=607.193, cy=185.216, rows=376,
                  cols=1241, baseline_px=386.1448, range_min=0.1, range_max=300.0)
CAM_J = jp.Camera(*CAM_T)


def _twists(rng, n, rot_scale):
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, :3] *= 0.5
    xi[:, 3:] *= rot_scale
    return xi


def _close(t, j, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


# rotation scales span the Taylor branch (< 0.1 rad), tiny VO steps and
# the closed-form branch
@pytest.mark.parametrize("rot_scale", [1e-7, 1e-4, 1e-2, 0.3, 1.0])
def test_exp_log_match_jax(rng, rot_scale):
    xi = _twists(rng, 64, rot_scale)
    T_t, T_j = ts.exp(torch.from_numpy(xi)), js.exp(jnp.asarray(xi))
    _close(T_t, T_j)
    _close(ts.log(T_t), js.log(T_j), atol=2e-6)
    _close(ts.log_so3(T_t[:, :3, :3]), js.log_so3(T_j[:, :3, :3]), atol=2e-6)
    _close(ts.exp_so3(torch.from_numpy(xi[:, 3:])), js.exp_so3(jnp.asarray(xi[:, 3:])))


def test_small_angle_coefficients_match_jax():
    theta2 = np.concatenate([np.zeros(1), np.logspace(-16, 1, 60)]).astype(np.float32)
    for a, b in zip(ts._exp_coefficients(torch.from_numpy(theta2)),
                    js._exp_coefficients(jnp.asarray(theta2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)


def test_inverse_transform_skew_error_match_jax(rng):
    xi = _twists(rng, 16, 0.5)
    T_t, T_j = ts.exp(torch.from_numpy(xi)), js.exp(jnp.asarray(xi))
    _close(ts.inverse(T_t), js.inverse(T_j))
    pts = rng.uniform(-10, 10, (16, 40, 3)).astype(np.float32)
    _close(ts.transform_points(T_t, torch.from_numpy(pts)),
           js.transform_points(T_j, jnp.asarray(pts)), atol=1e-5)
    _close(ts.skew(torch.from_numpy(pts)), js.skew(jnp.asarray(pts)), atol=0)
    xi2 = _twists(rng, 16, 0.01)
    U_t, U_j = ts.exp(torch.from_numpy(xi2)), js.exp(jnp.asarray(xi2))
    for a, b in zip(ts.error_t_and_angle(T_t, U_t), js.error_t_and_angle(T_j, U_j)):
        _close(a, b, atol=3e-6)
    assert torch.equal(ts.identity(), torch.eye(4))


def test_project_unproject_match_jax(rng):
    pts = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-5, 400, 500)
    pts[:3, 2] = [0.0, 1e-10, -1e-10]      # z_safe branch
    uv_t, in_t = tp.project(CAM_T, torch.from_numpy(pts))
    uv_j, in_j = jp.project(CAM_J, jnp.asarray(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    uvd = rng.uniform(0, 100, (300, 3)).astype(np.float32)
    p_t, ok_t = tp.unproject(CAM_T, torch.from_numpy(uvd))
    p_j, ok_j = jp.unproject(CAM_J, jnp.asarray(uvd))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(CAM_T.K.numpy(), np.asarray(CAM_J.K))
    assert CAM_T.baseline_m == CAM_J.baseline_m


def test_triangulate_rectified_matches_jax(rng):
    n = 400
    u_l = rng.uniform(0, 1241, n).astype(np.float32)
    disp = rng.uniform(-2, 120, n).astype(np.float32)
    disp[:4] = [0.0, 1.0, 0.999, -0.0]
    v = rng.uniform(0, 376, n).astype(np.float32)
    pts4 = np.stack([u_l, v, u_l - disp, v + rng.uniform(-1, 1, n)], 1).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    p_t, ok_t = t_tri(CAM_T, torch.from_numpy(pts4), torch.from_numpy(valid), 1.0)
    p_j, ok_j = j_tri(CAM_J, jnp.asarray(pts4), jnp.asarray(valid), 1.0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
