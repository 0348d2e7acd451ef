"""Port PGO and the point-to-point GN == the JAX package, on the CPU.

The graphs are tests/test_pgo.py's ``_ring_graph`` cases (built once in
numpy and carried into both packages).  Bounds: dense and CG poses within
1e-4 of JAX's; ``edge_t_residuals`` and ``mean_edge_residual`` exact at
the same poses (within 1e-4 after optimizing); ``grow``/``add_pose``/
``add_edge`` and ``graph_from_numpy`` exact; ``point3_system`` H/b within rtol 1e-5 with equal stats; the batched
sync-free GN (``gn_iterate_batch``) equal to the per-estimate early-exit
loop to 1e-6 and to JAX's vmapped while_loop to 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.ops import gn as jgn, pgo as jpgo, se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch.ops import gn as tgn, pgo as tpgo, se3 as tse3  # noqa: E402

POSE_ATOL = 1e-4


def _exp(xi):
    return np.array(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _ring_graph(n=8, edge_capacity=16, noise=0.0, rng=None):
    """tests/test_pgo.py::_ring_graph as numpy fields: a ring of GT poses,
    odometry edges and one loop edge, guesses perturbed by rng."""
    gt = [np.eye(4, dtype=np.float32)]
    step = _exp([1.0, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n])
    for _ in range(n - 1):
        gt.append((gt[-1] @ step).astype(np.float32))
    g = {k: np.asarray(v) for k, v in jpgo.empty_graph(n, edge_capacity)._asdict().items()}
    g = {k: v.copy() for k, v in g.items()}
    edges = [(i, i + 1, np.linalg.inv(gt[i]) @ gt[i + 1]) for i in range(n - 1)]
    edges.append((0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1]))
    for slot, (i, j, Z) in enumerate(edges):
        if noise and rng is not None and slot < n - 1:
            Z = _exp(rng.normal(0, noise, 6)) @ Z
        g["edge_i"][slot], g["edge_j"][slot] = i, j
        g["edge_Z"][slot] = Z
        g["edge_weight"][slot], g["edge_valid"][slot] = 1.0, True
    for i in range(n):
        guess = gt[i].copy()
        if rng is not None and i > 0:
            guess = _exp(rng.normal(0, 0.05, 6)) @ guess
        g["poses"][i], g["pose_valid"][i] = guess, True
    return g, gt


def _both(g):
    return jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), \
        tpgo.graph_from_numpy(g, "cpu")


CASES = {
    "zero_noise": (dict(n=6), dict(iterations=5)),
    "perturbed": (dict(n=8, seed=1), dict(iterations=10)),
    "noisy_odometry": (dict(n=8, seed=4, noise=0.02), dict(iterations=10)),
    "cg": (dict(n=8, seed=5), dict(iterations=8, solver="cg", cg_iterations=200)),
    "cg_early_exit": (dict(n=12, seed=6, noise=0.01),
                      dict(iterations=6, solver="cg", cg_iterations=60, cg_tolerance=1e-3)),
}


@pytest.mark.parametrize("case", CASES)
def test_optimize_matches_jax(case):
    gkw, ckw = CASES[case]
    seed = gkw.pop("seed", None)
    g, gt = _ring_graph(**gkw, rng=None if seed is None else np.random.RandomState(seed))
    jg, tg = _both(g)
    j_out, j_chi = jpgo.optimize(jg, jpgo.PGOConfig(**ckw))
    before = {k: v.clone() for k, v in tg._asdict().items()}
    t_out, t_chi = tpgo.optimize(tg, tpgo.PGOConfig(**ckw))
    np.testing.assert_allclose(t_out.poses.numpy(), np.asarray(j_out.poses), atol=POSE_ATOL)
    np.testing.assert_allclose(float(t_chi), float(j_chi), rtol=1e-3, atol=1e-5)
    for k, v in before.items():      # the input graph is left as it was
        assert torch.equal(getattr(tg, k), v), k
    if case == "zero_noise":
        for T, ref in zip(t_out.poses[:6].numpy(), gt):
            np.testing.assert_allclose(T, ref, atol=1e-3)


def test_normal_equations_match_jax():
    """Repeated edge indices (a ring visits every pose twice) add up."""
    g, _ = _ring_graph(n=8, rng=np.random.RandomState(2))
    jg, tg = _both(g)
    jH, jb, jchi = jpgo.normal_equations(jg.poses, jg, 25.0, 1e6)
    tH, tb, tchi = tpgo.normal_equations(tg.poses, tg, 25.0, 1e6)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-5)


def test_edge_residuals_and_backstop_statistics_match_jax():
    """tests/test_pgo.py's chain with a false closure, then optimized."""
    N = 6
    step = _exp([0.0, 0, -1.0, 0, 0, 0])
    jg = jpgo.empty_graph(8, 16)
    tg = tpgo.empty_graph(8, 16, "cpu")
    T = np.eye(4, dtype=np.float32)
    for i in range(N):
        jg = jpgo.add_pose(jg, i, jnp.asarray(T))
        tg = tpgo.add_pose(tg, i, torch.from_numpy(T))
        T = (T @ step).astype(np.float32)
    for i in range(N - 1):
        jg = jpgo.add_edge(jg, i, i, i + 1, jnp.asarray(step))
        tg = tpgo.add_edge(tg, i, i, i + 1, torch.from_numpy(step))
    Z = (np.linalg.matrix_power(step, 5) @ _exp([8.0, 0, 0, 0, 0, 0])).astype(np.float32)
    jg = jpgo.add_edge(jg, N - 1, 0, N - 1, jnp.asarray(Z))
    tg = tpgo.add_edge(tg, N - 1, 0, N - 1, torch.from_numpy(Z))
    for name in tpgo.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), err_msg=name)
    held = np.arange(16) < N - 1
    for j_graph, t_graph, atol in [
            (jg, tg, 0.0),
            (jpgo.optimize(jg, jpgo.PGOConfig())[0], tpgo.optimize(tg, tpgo.PGOConfig())[0],
             POSE_ATOL)]:
        r_t = tpgo.edge_t_residuals(t_graph).numpy()
        chain_t = float(tpgo.mean_edge_residual(t_graph, torch.from_numpy(held)))
        np.testing.assert_allclose(r_t, np.asarray(jpgo.edge_t_residuals(j_graph)),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(
            chain_t, float(jpgo.mean_edge_residual(j_graph, jnp.asarray(held))),
            rtol=0, atol=atol)
    # the false closure keeps a large residual or bends the chain
    assert r_t[N - 1] > 0.5 or chain_t > 0.5


def test_grow_and_adds_match_jax_exactly():
    g, _ = _ring_graph(n=6, edge_capacity=8, rng=np.random.RandomState(3))
    jg, tg = _both(g)
    Z = _exp([0.1, 0.2, -0.3, 0.01, 0.02, 0.03])
    jg2 = jpgo.add_edge(jpgo.add_pose(jpgo.grow(jg, 12, 16), 7, jnp.asarray(Z)),
                        9, 3, 7, jnp.asarray(Z), weight=2.5)
    tg2 = tpgo.add_edge(tpgo.add_pose(tpgo.grow(tg, 12, 16), 7, torch.from_numpy(Z)),
                        9, 3, 7, torch.from_numpy(Z), weight=2.5)
    assert tg2.capacity == 12 and tg2.edge_capacity == 16
    for name in tpgo.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(tg2, name).numpy(),
                                      np.asarray(getattr(jg2, name)), err_msg=name)
    # grow/add return new tensors and keep the source graph
    assert tg.capacity == 6 and not bool(tg.edge_valid[7])
    np.testing.assert_array_equal(tg.poses.numpy(), g["poses"])
    assert tpgo.grow(tg, 4, 4) is tg
    # empty_graph's identity stacks are real tensors, not views of one eye
    e = tpgo.empty_graph(3, 2, "cpu")
    e.poses[0, 0, 3] = 5.0
    assert float(e.poses[1, 0, 3]) == 0.0


def test_adjoint_matches_jax(rng):
    T = _exp(rng.normal(0, 0.5, 6))
    np.testing.assert_allclose(tpgo.adjoint(torch.from_numpy(T)).numpy(),
                               np.asarray(jpgo.adjoint(jnp.asarray(T))), atol=1e-6)


def test_bad_solver_raises():
    g, _ = _ring_graph(n=4, edge_capacity=4)
    with pytest.raises(ValueError):
        tpgo.optimize(tpgo.graph_from_numpy(g, "cpu"), tpgo.PGOConfig(solver="qr"))


def _point3_problem(rng, K=4, Q=90):
    """K candidates of one query point set: true transforms, noise, outliers,
    and masks from dense to nearly empty."""
    pts = (rng.uniform(-5, 5, (Q, 3)) + [0, 0, 10]).astype(np.float32)
    fixed, masks, inits = [], [], []
    for k in range(K):
        T = _exp(rng.normal(0, 0.2, 6))
        f = pts @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.02, (Q, 3))
        f[: 10 * k] += rng.uniform(-3, 3, (10 * k, 3))      # outliers
        fixed.append(f.astype(np.float32))
        masks.append(rng.uniform(size=Q) < [0.95, 0.7, 0.4, 0.2][k % 4])
        inits.append(_exp(rng.normal(0, 0.05, 6)) @ T)
    return pts, np.stack(fixed), np.stack(masks), np.stack(inits).astype(np.float32)


def test_point3_system_matches_jax(rng):
    pts, fixed, masks, inits = _point3_problem(rng)
    w = rng.uniform(0.5, 2.0, pts.shape[0]).astype(np.float32)
    tH, tb, ts = tgn.point3_system(torch.from_numpy(inits), torch.from_numpy(pts),
                                   torch.from_numpy(fixed), torch.from_numpy(w),
                                   torch.from_numpy(masks), chi_threshold=3.0)
    for k in range(len(inits)):
        jH, jb, js = jgn.point3_system(jnp.asarray(inits[k]), jnp.asarray(pts),
                                       jnp.asarray(fixed[k]), jnp.asarray(w),
                                       jnp.asarray(masks[k]), chi_threshold=3.0)
        np.testing.assert_allclose(tH[k].numpy(), np.asarray(jH), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)
        assert int(ts.num_inliers[k]) == int(js.num_inliers)
        assert int(ts.num_terms[k]) == int(js.num_terms)
        np.testing.assert_allclose(float(ts.chi_total[k]), float(js.chi_total), rtol=1e-5)
    # the saturated kernel on the same system
    tH2, _, _ = tgn.point3_system(torch.from_numpy(inits[0]), torch.from_numpy(pts),
                                  torch.from_numpy(fixed[0]), torch.from_numpy(w),
                                  torch.from_numpy(masks[0]), 3.0, tgn.robust_saturate)
    jH2, _, _ = jgn.point3_system(jnp.asarray(inits[0]), jnp.asarray(pts),
                                  jnp.asarray(fixed[0]), jnp.asarray(w),
                                  jnp.asarray(masks[0]), 3.0, jgn.robust_saturate)
    np.testing.assert_allclose(tH2.numpy(), np.asarray(jH2), rtol=1e-5, atol=1e-4)
    chi = np.array([0.0, 2.9, 3.0, 3.1, 100.0], np.float32)
    np.testing.assert_array_equal(tgn.robust_clamp(torch.from_numpy(chi), 3.0).numpy(),
                                  np.asarray(jgn.robust_clamp(jnp.asarray(chi), 3.0)))


@pytest.mark.parametrize("epsilon,min_inliers", [(0.0, 25), (1e-3, 25), (0.0, 40)])
def test_gn_iterate_batch_matches_loop_and_jax(rng, epsilon, min_inliers):
    """The sticky-flag batch == one early-exit loop per estimate (the port's
    gn_iterate) == JAX's while_loop gn_iterate."""
    pts, fixed, masks, inits = _point3_problem(rng)
    w = np.ones(pts.shape[0], np.float32)
    kw = dict(damping=1.0, min_inliers=min_inliers, epsilon=epsilon)
    Xb, sb = tgn.gn_iterate_batch(
        lambda X: tgn.point3_system(X, torch.from_numpy(pts), torch.from_numpy(fixed),
                                    torch.from_numpy(w), torch.from_numpy(masks)),
        torch.from_numpy(inits), 30, **kw)
    for k in range(len(inits)):
        Xl, sl = tgn.gn_iterate(
            lambda X: tgn.point3_system(X, torch.from_numpy(pts), torch.from_numpy(fixed[k]),
                                        torch.from_numpy(w), torch.from_numpy(masks[k])),
            torch.from_numpy(inits[k]), 30, **kw)
        Xj, sj = jgn.gn_iterate(
            lambda X: jgn.point3_system(X, jnp.asarray(pts), jnp.asarray(fixed[k]),
                                        jnp.asarray(w), jnp.asarray(masks[k])),
            jnp.asarray(inits[k]), 30, **kw)
        np.testing.assert_allclose(Xb[k].numpy(), Xl.numpy(), atol=1e-6)
        np.testing.assert_allclose(Xb[k].numpy(), np.asarray(Xj), atol=1e-5)
        assert int(sb.num_terms[k]) == int(sl.num_terms) == int(sj.num_terms)
        assert int(sb.num_inliers[k]) == int(sl.num_inliers) == int(sj.num_inliers)
        np.testing.assert_allclose(float(sb.chi_total[k]), float(sl.chi_total), rtol=1e-5)
        np.testing.assert_allclose(float(sb.chi_total[k]), float(sj.chi_total),
                                   rtol=1e-4, atol=1e-4)
