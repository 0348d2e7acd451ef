"""Port Hamming distances and matchers == the JAX functions, bit for bit.

Descriptors are random ±1 made with numpy; some rows are planted
duplicates so that distance ties occur and the argmin must take the first
index, as JAX does.  Indices, distances and masks must be identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.ops import hamming as jh, matching as jm  # noqa: E402

from srrg2_proslam_tpu_torch.ops import hamming as th, matching as tm  # noqa: E402


def _desc(rng, n, dup_from=None, dups=0):
    d = np.where(rng.uniform(size=(n, 256)) < 0.5, 1, -1).astype(np.int8)
    if dup_from is not None and dups:
        d[:dups] = dup_from[:dups]          # exact duplicates -> distance 0 ties
        d[dups:2 * dups] = dup_from[:dups]  # ... twice, so argmin ties as well
    return d


def _same(tmatch, jmatch):
    np.testing.assert_array_equal(tmatch.idx.numpy(), np.asarray(jmatch.idx))
    np.testing.assert_array_equal(tmatch.distance.numpy(), np.asarray(jmatch.distance))
    np.testing.assert_array_equal(tmatch.mask.numpy(), np.asarray(jmatch.mask))


def test_distance_matrix_exact(rng):
    a = _desc(rng, 70)
    b = _desc(rng, 90, a, 10)
    a[5] = 0  # invalid all-zero row -> 128
    got = th.distance_matrix(torch.from_numpy(a), torch.from_numpy(b))
    ref = jh.distance_matrix(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[5] == 128).all()
    assert int(got.min()) == 0


def test_min2_ties_take_first_index(rng):
    cost = rng.randint(0, 6, (50, 40)).astype(np.float32)  # many ties
    cost[3] = 2.0
    d1, d2, idx = tm._min2(torch.from_numpy(cost.copy()))   # _min2 writes its input
    e1, e2, eidx = jm._min2(jnp.asarray(cost))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(eidx))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(e1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(e2))
    assert int(idx[3]) == 0


@pytest.mark.parametrize("max_d,lowe", [(50.0, 0.5), (100.0, 0.8), (128.0, 1.0)])
def test_match_cost_matrix_matches_jax(rng, max_d, lowe):
    a = _desc(rng, 60)
    b = _desc(rng, 80, a, 12)
    cost = np.asarray(jh.distance_matrix(jnp.asarray(a), jnp.asarray(b))).astype(np.float32)
    feasible = rng.uniform(size=cost.shape) < 0.7
    got = tm.match_cost_matrix(torch.from_numpy(cost), torch.from_numpy(feasible), max_d, lowe)
    _same(got, jm.match_cost_matrix(jnp.asarray(cost), jnp.asarray(feasible), max_d, lowe))
    assert int(got.count) > 0


def test_match_epipolar_matches_jax(rng):
    n = 120
    uv_l = np.stack([rng.uniform(0, 300, n), rng.randint(0, 40, n)], 1).astype(np.float32)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= rng.uniform(-5, 60, n)
    uv_r[:, 1] += rng.choice([0.0, 0.5, 1.0, 1.5], n)
    desc_l = _desc(rng, n)
    desc_r = desc_l.copy()
    flip = rng.uniform(size=desc_r.shape) < 0.1
    desc_r[flip] *= -1
    desc_r[40:50] = desc_r[30:40]  # duplicate right descriptors: ties
    vl = rng.uniform(size=n) < 0.95
    vr = rng.uniform(size=n) < 0.95
    args = (uv_l, desc_l, vl, uv_r, desc_r, vr)
    got = tm.match_epipolar(*map(torch.from_numpy, args), tm.EpipolarMatcherConfig())
    ref = jm.match_epipolar(*map(jnp.asarray, args), jm.EpipolarMatcherConfig())
    _same(got, ref)
    assert int(got.count) > 20


@pytest.mark.parametrize("norm", ["circle", "square", "rhombus"])
@pytest.mark.parametrize("force_stage", [-1, 0, 1, 2, 5])
def test_match_projective_matches_jax(rng, norm, force_stage):
    n, m = 150, 260
    proj_uv = rng.uniform(0, 200, (m, 2)).astype(np.float32)
    proj_desc = _desc(rng, m)
    pick = rng.choice(m, n, replace=False)
    meas_uv = (proj_uv[pick] + rng.normal(0, 12, (n, 2))).astype(np.float32)
    meas_desc = proj_desc[pick].copy()
    meas_desc[rng.uniform(size=meas_desc.shape) < 0.08] *= -1
    meas_desc[:8] = meas_desc[8:16]  # ties
    mv = rng.uniform(size=n) < 0.9
    pv = rng.uniform(size=m) < 0.9
    args = (meas_uv, meas_desc, mv, proj_uv, proj_desc, pv)
    cfg_t = tm.ProjectiveMatcherConfig(norm=norm)
    cfg_j = jm.ProjectiveMatcherConfig(norm=norm)
    got, s_t = tm.match_projective(*map(torch.from_numpy, args), cfg_t, force_stage)
    ref, s_j = jm.match_projective(*map(jnp.asarray, args), cfg_j, force_stage)
    _same(got, ref)
    assert int(s_t) == int(s_j)
    assert s_t.dtype == torch.int32


@pytest.mark.parametrize("valid_share", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("force_stage", [-1, 1])
@pytest.mark.parametrize("norm", ["circle", "rhombus"])
def test_host_projective_path_equals_whole_matrices(rng, valid_share, force_stage, norm):
    """The host path (valid rows and columns only) against the whole
    matrices, to the bit, on a sparse arena with tied descriptors, and
    against JAX."""
    n, m = 140, 600
    proj_uv = rng.uniform(0, 120, (m, 2)).astype(np.float32)
    proj_desc = _desc(rng, m)
    proj_desc[300:340] = proj_desc[200:240]  # tied columns
    pick = rng.choice(m, n, replace=False)
    meas_uv = (proj_uv[pick] + rng.normal(0, 8, (n, 2))).astype(np.float32)
    meas_desc = proj_desc[pick].copy()
    meas_desc[rng.uniform(size=meas_desc.shape) < 0.06] *= -1
    meas_desc[:10] = meas_desc[10:20]  # tied rows
    mv = rng.uniform(size=n) < max(valid_share, 0.5)
    pv = rng.uniform(size=m) < valid_share
    pv[pick[:5]] = valid_share > 0
    args = (meas_uv, meas_desc, mv, proj_uv, proj_desc, pv)
    cfg = tm.ProjectiveMatcherConfig(norm=norm)
    got, s_t = tm.match_projective(*map(torch.from_numpy, args), cfg, force_stage)
    whole, s_w = tm._match_projective(*map(torch.from_numpy, args), cfg, force_stage)
    for field in ("idx", "distance", "mask"):
        a, b = getattr(got, field), getattr(whole, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field
    assert s_t.dtype == s_w.dtype and int(s_t) == int(s_w)
    ref, s_j = jm.match_projective(*map(jnp.asarray, args),
                                   jm.ProjectiveMatcherConfig(norm=norm), force_stage)
    _same(got, ref)
    assert int(s_t) == int(s_j)
    if valid_share >= 0.3:
        assert int(got.count) > 5
