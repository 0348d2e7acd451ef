"""Port GN burst (plain version of K2) == JAX gn_iterate and the Pallas burst.

The cases are those of tests/test_gn_pallas.py plus one with weights around
1e4, where the TPU kernel's f32 cofactor solve is at risk; bounds are that
file's: X within atol 5e-4, num_terms exact, inliers within 1.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from srrg2_proslam_tpu.ops import gn as jgn, se3 as jse3  # noqa: E402
from srrg2_proslam_tpu.ops.gn_pallas import gn_burst_stereo as j_burst  # noqa: E402
from srrg2_proslam_tpu.ops.pinhole import Camera as JCamera  # noqa: E402

from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.ops import gn as tgn, se3 as tse3  # noqa: E402
from srrg2_proslam_tpu_torch.ops.pinhole import Camera  # noqa: E402

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, rows=480, cols=640, baseline_px=45.0)
JCAM = JCamera(*CAM)
X_ATOL = 5e-4


def _problem(rng, n=300, outliers=0, n_valid=None, w_range=(0.5, 2.0)):
    """The test_gn_pallas.py problem, as numpy arrays."""
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    X_gt = jse3.exp(jnp.asarray(np.array([0.2, -0.1, 0.35, 0.02, -0.01, 0.03], np.float32)))
    p = np.asarray(jse3.transform_points(X_gt, jnp.asarray(pts)))
    meas = np.stack([
        CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
        CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
        CAM.fx * p[:, 0] / p[:, 2] + CAM.cx - CAM.baseline_px / p[:, 2],
    ], -1).astype(np.float32)
    if outliers:
        meas[:outliers] += rng.uniform(50, 200, (outliers, 3)).astype(np.float32)
    w = rng.uniform(*w_range, (n,)).astype(np.float32)
    mask = np.arange(n) < (n_valid if n_valid is not None else n)
    return pts, meas, w, mask


CASES = [
    pytest.param(0.0, 0, None, (0.5, 2.0), id="clean"),
    pytest.param(1e-5, 30, None, (0.5, 2.0), id="eps-outliers"),
    pytest.param(0.0, 0, 4, (0.5, 2.0), id="below-min-inliers"),
    pytest.param(0.0, 10, None, (5e3, 2e4), id="weights-1e4"),
]


@pytest.mark.parametrize("eps,outliers,n_valid,w_range", CASES)
def test_plain_burst_matches_jax(rng, eps, outliers, n_valid, w_range):
    pts, meas, w, mask = _problem(rng, outliers=outliers, n_valid=n_valid, w_range=w_range)
    kw = dict(damping=1e-6, min_inliers=6, epsilon=eps)
    X_t, s_t = gn_burst_stereo(tse3.identity(), *map(torch.from_numpy, (pts, meas, w, mask)),
                               CAM, iterations=5, chi_threshold=25.0, **kw)
    jp = tuple(map(jnp.asarray, (pts, meas, w, mask)))
    system = lambda X: jgn.stereo_projective_system(X, *jp, JCAM, 25.0)
    X_ref, s_ref = jgn.gn_iterate(system, jse3.identity(), 5, **kw)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_ref), atol=X_ATOL)
    assert int(s_t.num_terms) == int(s_ref.num_terms)
    assert abs(int(s_t.num_inliers) - int(s_ref.num_inliers)) <= 1
    np.testing.assert_allclose(float(s_t.chi_total), float(s_ref.chi_total),
                               rtol=1e-2, atol=1e-2)
    X_k, s_k = j_burst(jse3.identity(), *jp, JCAM, iterations=5, chi_threshold=25.0,
                       interpret=True, **kw)
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_k), atol=X_ATOL)
    assert int(s_t.num_terms) == int(s_k.num_terms)
    if n_valid is not None:  # too few terms: the estimate must not move
        np.testing.assert_array_equal(X_t.numpy(), np.eye(4, dtype=np.float32))


def test_system_and_step_match_jax(rng):
    pts, meas, w, mask = _problem(rng, outliers=20)
    X_np = np.array(jse3.exp(jnp.asarray(np.array([0.1, 0.0, 0.2, 0.01, 0.0, -0.02],
                                                    np.float32))))
    H_t, b_t, s_t = tgn.stereo_projective_system(
        torch.from_numpy(X_np), *map(torch.from_numpy, (pts, meas, w, mask)), CAM, 25.0)
    H_j, b_j, s_j = jgn.stereo_projective_system(
        jnp.asarray(X_np), *map(jnp.asarray, (pts, meas, w, mask)), JCAM, 25.0)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(H_j)).max()))
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(b_j)).max()))
    assert int(s_t.num_terms) == int(s_j.num_terms)
    assert int(s_t.num_inliers) == int(s_j.num_inliers)
    X2_t, dx_t = tgn.gn_step_dx(torch.from_numpy(X_np), H_t, b_t)
    X2_j, dx_j = jgn.gn_step_dx(jnp.asarray(X_np), H_j, b_j)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(X2_t.numpy(), np.asarray(X2_j), atol=1e-5)
    chi = rng.uniform(0, 100, 50).astype(np.float32)
    # XLA:CPU's division may round 1 ulp away from IEEE division
    np.testing.assert_allclose(tgn.robust_saturate(torch.from_numpy(chi), 25.0).numpy(),
                               np.asarray(jgn.robust_saturate(jnp.asarray(chi), 25.0)),
                               rtol=2e-7, atol=0)


def test_degenerate_solve_gives_zero_step():
    H = torch.full((6, 6), float("nan"))
    X, dx = tgn.gn_step_dx(tse3.identity(), H, torch.ones(6))
    assert torch.equal(dx, torch.zeros(6))
    assert torch.equal(X, torch.eye(4))


def test_burst_converges_and_checks_inputs(rng):
    pts, meas, w, mask = _problem(rng)
    args = tuple(map(torch.from_numpy, (pts, meas, w, mask)))
    X, s = gn_burst_stereo(tse3.identity(), *args, CAM, iterations=10)
    X_gt = jse3.exp(jnp.asarray(np.array([0.2, -0.1, 0.35, 0.02, -0.01, 0.03], np.float32)))
    t_err, ang = tse3.error_t_and_angle(X, torch.from_numpy(np.array(X_gt)))
    assert float(t_err.max()) < 1e-3 and float(ang) < 1e-4
    assert int(s.num_inliers) == pts.shape[0]
    with pytest.raises(ValueError):
        gn_burst_stereo(tse3.identity(), args[0][:, :2], *args[1:], CAM, iterations=1)
    with pytest.raises(ValueError):
        gn_burst_stereo(tse3.identity(), *args[:3], args[3].float(), CAM, iterations=1)
