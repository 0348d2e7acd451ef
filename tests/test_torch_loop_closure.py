"""Port loop closure and closure merging == the JAX package, on the CPU.

Same numpy inputs, made from a seed, through both packages.  Bounds: the
database (ring writes and wrap-around, ``select_db_rows``) and the query
(candidate ids, votes, match rows/indices/masks/points, dense and tiled)
exact; ``validate_batch`` equal to a per-candidate early-exit loop to 1e-6
and to JAX's with T within 1e-4 and the same ``accepted``; the
``detect_and_validate`` packet's ids, acceptance and counts exact, its
floats within 1e-4; ``merge_closure`` (with several query rows matching one
ref row: the last one's descriptor wins) with integer fields exact and
positions within 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import landmarks as jlm, loop_closure as jlc  # noqa: E402
from srrg2_proslam_tpu.ops import se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch.models import landmarks as tlm, loop_closure as tlc  # noqa: E402
from srrg2_proslam_tpu_torch.ops import gn as tgn  # noqa: E402

T_ATOL = 1e-4


def _desc(rng, n):
    return rng.choice(np.array([-1, 1], np.int8), size=(n, 256))


def _flip(rng, desc, k):
    out = desc.copy()
    for i in range(desc.shape[0]):
        idx = rng.choice(256, size=k, replace=False)
        out[i, idx] = -out[i, idx]
    return out


def _exp(xi):
    return np.array(jse3.exp(jnp.asarray(np.asarray(xi, np.float32))))


def _db_numpy(db):
    return {k: np.asarray(v) for k, v in db._asdict().items()}


def _assert_db_equal(tdb, jdb):
    for k, v in _db_numpy(jdb).items():
        got = getattr(tdb, k).numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def _maps(rng, n_maps, base_desc):
    """n_maps local maps: each shares a block of ``base_desc`` (with a few
    flipped bits), holds some invalid rows and its own positions."""
    out = []
    for mid in range(n_maps):
        n = 60 + 13 * mid
        lo = (25 * mid) % (base_desc.shape[0] - n)
        desc = _flip(rng, base_desc[lo:lo + n], 2)
        pts = (rng.uniform(-5, 5, (n, 3)) + [0, 0, 8]).astype(np.float32)
        valid = rng.uniform(size=n) > 0.1
        rows = rng.permutation(400)[:n].astype(np.int32)
        out.append((desc, pts, valid, mid, rows))
    return out


@pytest.fixture(scope="module")
def databases():
    """A 5-slot ring (budget 64) after 7 inserts, in both packages."""
    rng = np.random.RandomState(11)
    base = _desc(rng, 300)
    jdb, tdb = jlc.empty_database(320, 64), tlc.empty_database(320, 64, "cpu")
    for desc, pts, valid, mid, rows in _maps(rng, 7, base):
        jdb = jlc.add_local_map(jdb, jnp.asarray(desc), jnp.asarray(pts),
                                jnp.asarray(valid), mid, jnp.asarray(rows))
        before = tdb
        tdb = tlc.add_local_map(tdb, torch.from_numpy(desc), torch.from_numpy(pts),
                                torch.from_numpy(valid), mid, torch.from_numpy(rows))
        assert before.next is not tdb.next and int(before.next) == mid
    return jdb, tdb, base


def test_ring_write_and_wrap_match_jax(databases):
    jdb, tdb, _ = databases
    assert tdb.num_slots == 5 and tdb.budget == 64
    _assert_db_equal(tdb, jdb)
    # slots 0 and 1 hold the maps that overwrote maps 0 and 1
    assert tdb.map_id.tolist() == [5, 6, 2, 3, 4] and int(tdb.next) == 7
    back = tlc.database_from_numpy(_db_numpy(jdb), "cpu")
    _assert_db_equal(back, jdb)
    # rows default to arange, and more valid rows than the budget truncate
    rng = np.random.RandomState(3)
    desc, pts = _desc(rng, 90), rng.normal(size=(90, 3)).astype(np.float32)
    j1 = jlc.add_local_map(jlc.empty_database(128, 64), jnp.asarray(desc), jnp.asarray(pts),
                           jnp.ones(90, bool), 4)
    t1 = tlc.add_local_map(tlc.empty_database(128, 64, "cpu"), torch.from_numpy(desc),
                           torch.from_numpy(pts), torch.ones(90, dtype=torch.bool), 4)
    _assert_db_equal(t1, j1)


def test_select_db_rows_matches_jax():
    rng = np.random.RandomState(5)
    M = 300
    desc, pos = _desc(rng, M), rng.normal(size=(M, 3)).astype(np.float32)
    valid = rng.uniform(size=M) > 0.3
    num_updates = rng.randint(0, 6, M).astype(np.int32)     # many ties
    for budget in (64, 250, 300):
        j = jlc.select_db_rows(*map(jnp.asarray, (desc, pos, valid, num_updates)),
                               budget=budget)
        t = tlc.select_db_rows(*map(torch.from_numpy, (desc, pos, valid, num_updates)),
                               budget=budget)
        for a, b in zip(t, j):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cfg", [
    dict(minimum_age_difference=1, minimum_matches=25),
    dict(minimum_age_difference=3, minimum_matches=10, max_candidates=3),
    dict(minimum_age_difference=1, minimum_matches=1, maximum_descriptor_distance=140.0,
         lowe_ratio=1.0),
    dict(minimum_age_difference=1, minimum_matches=25, query_tile=64),
    dict(minimum_age_difference=1, minimum_matches=1, maximum_descriptor_distance=140.0,
         lowe_ratio=1.0, query_tile=1),
])
def test_query_matches_jax(databases, cfg):
    jdb, tdb, base = databases
    rng = np.random.RandomState(12)
    q_desc = _flip(rng, base[:200], 3)
    q_valid = rng.uniform(size=200) > 0.1
    j = jlc.query(jnp.asarray(q_desc), jnp.asarray(q_valid), 8, jdb,
                  jlc.LoopDetectorConfig(**cfg), num_maps=8)
    t = tlc.query(torch.from_numpy(q_desc), torch.from_numpy(q_valid), 8, tdb,
                  tlc.LoopDetectorConfig(**cfg), num_maps=8)
    assert int((t.candidate_maps >= 0).sum()) >= 1
    for name in tlc.LoopQueryResult._fields:
        got, ref = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_tiled_terms_equal_dense_terms(databases):
    _, tdb, base = databases
    cfg = tlc.LoopDetectorConfig(minimum_age_difference=1, lowe_ratio=1.0,
                                 maximum_descriptor_distance=140.0)
    q = torch.from_numpy(base[:50])
    ok = torch.ones(50, dtype=torch.bool)
    dense = tlc.query_terms(q, ok, 9, tdb, cfg)
    tiled = tlc.query_terms_tiled(q, ok, 9, tdb, cfg, 1)
    for a, b in zip(dense, tiled):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tlc.query_terms_tiled(q, ok, 9, tdb, cfg, 2)


def _closure_problem(rng, K=4, Q=120):
    """A query map and K candidate correspondence sets: true transforms,
    noise, outliers, garbage and an empty candidate."""
    pts_q = (rng.uniform(-5, 5, (Q, 3)) + [0, 0, 10]).astype(np.float32)
    match_points, masks, inits = [], [], []
    for k in range(K):
        T = _exp(rng.normal(0, 0.2, 6))
        f = pts_q @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, (Q, 3))
        if k == 2:
            f = rng.uniform(-50, 50, (Q, 3))                  # garbage geometry
        f[: 15 * k] += rng.uniform(-2, 2, (15 * k, 3))
        match_points.append(f.astype(np.float32))
        masks.append(rng.uniform(size=Q) < (0.0 if k == 3 else 0.8))
        inits.append(_exp(rng.normal(0, 0.05, 6)) @ T)
    return pts_q, np.stack(match_points), np.stack(masks), np.stack(inits).astype(np.float32)


def test_validate_batch_matches_loop_and_jax():
    rng = np.random.RandomState(21)
    pts_q, mp, mm, T0 = _closure_problem(rng)
    K = mp.shape[0]
    cfg_t, cfg_j = tlc.LoopDetectorConfig(), jlc.LoopDetectorConfig()
    res_t = tlc.LoopQueryResult(None, None, None, None, torch.from_numpy(mm),
                                torch.from_numpy(mp))
    res_j = jlc.LoopQueryResult(None, None, None, None, jnp.asarray(mm), jnp.asarray(mp))
    t = tlc.validate_batch(torch.from_numpy(pts_q), res_t, torch.from_numpy(T0), cfg_t)
    j = jlc.validate_batch(jnp.asarray(pts_q), res_j, jnp.asarray(T0), cfg_j)
    assert t.accepted.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(t.accepted.numpy(), np.asarray(j.accepted))
    np.testing.assert_array_equal(t.num_inliers.numpy(), np.asarray(j.num_inliers))
    np.testing.assert_allclose(t.T_query_in_ref.numpy(), np.asarray(j.T_query_in_ref),
                               atol=T_ATOL)
    np.testing.assert_allclose(t.chi_per_inlier.numpy(), np.asarray(j.chi_per_inlier),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.inlier_ratio.numpy(), np.asarray(j.inlier_ratio), rtol=1e-6)
    for k in range(K):
        # the per-candidate loop: gn_iterate stops each candidate on its own
        X, stats = tgn.gn_iterate(
            lambda X: tgn.point3_system(X, torch.from_numpy(pts_q), torch.from_numpy(mp[k]),
                                        torch.ones(pts_q.shape[0]), torch.from_numpy(mm[k]),
                                        chi_threshold=cfg_t.chi_threshold),
            torch.from_numpy(T0[k]), cfg_t.aligner_iterations, damping=cfg_t.damping,
            min_inliers=cfg_t.relocalize_min_inliers)
        np.testing.assert_allclose(t.T_query_in_ref[k].numpy(), X.numpy(), atol=1e-6)
        assert int(t.num_inliers[k]) == int(stats.num_inliers)
        one = tlc.validate(torch.from_numpy(pts_q), torch.from_numpy(mp[k]),
                           torch.from_numpy(mm[k]), torch.from_numpy(T0[k]), cfg_t)
        assert bool(one.accepted) == bool(t.accepted[k])
        np.testing.assert_allclose(one.T_query_in_ref.numpy(), X.numpy(), atol=1e-6)


def test_detect_and_validate_packet_matches_jax(databases):
    """The split's fused query + validation, with a reference map whose
    landmarks the query map re-observes under a known transform."""
    jdb, tdb, base = databases
    rng = np.random.RandomState(31)
    pts_ref = (rng.uniform(-5, 5, (64, 3)) + [0, 0, 10]).astype(np.float32)
    desc_ref = base[100:164]
    jdb2 = jlc.add_local_map(jdb, jnp.asarray(desc_ref), jnp.asarray(pts_ref),
                             jnp.ones(64, bool), 9)
    tdb2 = tlc.add_local_map(tdb, torch.from_numpy(desc_ref), torch.from_numpy(pts_ref),
                             torch.ones(64, dtype=torch.bool), 9)
    T_q_in_ref = _exp([0.3, -0.1, 0.5, 0.02, -0.03, 0.04])
    inv = np.linalg.inv(T_q_in_ref)
    Q = 96
    q_pos = (rng.uniform(-5, 5, (Q, 3)) + [0, 0, 10]).astype(np.float32)
    q_pos[:64] = pts_ref @ inv[:3, :3].T + inv[:3, 3]
    q_desc = np.concatenate([_flip(rng, desc_ref, 2), _desc(rng, Q - 64)])
    q_valid = rng.uniform(size=Q) > 0.05
    poses = np.stack([_exp(rng.normal(0, 0.3, 6)) for _ in range(16)])
    poses[14] = poses[9] @ T_q_in_ref @ _exp([0.05, 0.0, -0.05, 0.0, 0.01, 0.0])
    cfg = dict(minimum_age_difference=3, minimum_matches=20)
    jr, jc, jp = jlc.detect_and_validate(
        jnp.asarray(q_desc), jnp.asarray(q_valid), jnp.asarray(q_pos), 14, jdb2,
        jnp.asarray(poses), jlc.LoopDetectorConfig(**cfg), 16)
    tr, tc, tp = tlc.detect_and_validate(
        torch.from_numpy(q_desc), torch.from_numpy(q_valid), torch.from_numpy(q_pos), 14,
        tdb2, torch.from_numpy(poses), tlc.LoopDetectorConfig(**cfg), 16)
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.shape == (4, tlc.PACKET_WIDTH) and tp.dtype == np.float32
    assert tp[0, 0] == 9 and tp[0, 1] == 1.0
    np.testing.assert_array_equal(tp[:, [0, 1, 2, 5]], jp[:, [0, 1, 2, 5]])
    np.testing.assert_allclose(tp[:, 6:], jp[:, 6:], atol=T_ATOL)
    np.testing.assert_allclose(tp[:, 3:5], jp[:, 3:5], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp[0, 6:].reshape(4, 4), T_q_in_ref, atol=1e-3)
    np.testing.assert_array_equal(tr.match_row.numpy(), np.asarray(jr.match_row))


def test_compact_arena_matches_jax():
    rng = np.random.RandomState(51)
    a = _arena_numpy(rng, 200, 150)
    j = jlc.compact_arena(jlm.LandmarkArena(**{k: jnp.asarray(v) for k, v in a.items()}), 64)
    t = tlc.compact_arena(tlm.LandmarkArena(**{k: torch.from_numpy(v) for k, v in a.items()}),
                          64)
    for name, got, ref in zip(("arena", "rows", "n"), t, j):
        for g, r in zip(got if name == "arena" else [got], ref if name == "arena" else [ref]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def _arena_numpy(rng, M, n, num_updates_max=5):
    a = {k: np.array(v) for k, v in jlm.empty_arena(M)._asdict().items()}
    a["pos"][:n] = rng.uniform(-5, 5, (n, 3)) + [0, 0, 10]
    a["cov"][:n] = np.eye(3) * rng.uniform(0.01, 0.1, (n, 1, 1))
    a["desc"][:n] = _desc(rng, n)
    a["num_updates"][:n] = rng.randint(1, num_updates_max + 1, n)
    a["valid"][:n] = rng.uniform(size=n) > 0.1
    return a


@pytest.mark.parametrize("duplicates,max_insertions", [(False, 512), (True, 512),
                                                       (True, 7), (False, 0)])
def test_merge_closure_matches_jax(duplicates, max_insertions):
    rng = np.random.RandomState(41 + duplicates)
    ref = _arena_numpy(rng, 160, 100)
    query = _arena_numpy(rng, 120, 90)
    match_row = np.where(rng.uniform(size=120) < 0.6, rng.permutation(160)[:120], -1)
    if duplicates:
        # query rows 0..9 and 10..19 all match ref rows 3..12 (pairs), and
        # rows 20..24 all match ref row 40
        match_row[:20] = np.tile(np.arange(3, 13), 2)
        match_row[20:25] = 40
        query["valid"][:25] = True
    match_row = match_row.astype(np.int32)
    match_mask = (match_row >= 0) & (rng.uniform(size=120) < 0.9)
    T = _exp([0.2, -0.1, 0.3, 0.05, 0.02, -0.04])
    j = jlm.merge_closure(jlm.LandmarkArena(**{k: jnp.asarray(v) for k, v in ref.items()}),
                          jlm.LandmarkArena(**{k: jnp.asarray(v) for k, v in query.items()}),
                          jnp.asarray(T), jnp.asarray(match_row), jnp.asarray(match_mask),
                          max_insertions)
    t_ref = tlm.LandmarkArena(**{k: torch.from_numpy(v) for k, v in ref.items()})
    t = tlm.merge_closure(t_ref, tlm.LandmarkArena(**{k: torch.from_numpy(v)
                                                      for k, v in query.items()}),
                          torch.from_numpy(T), torch.from_numpy(match_row),
                          torch.from_numpy(match_mask), max_insertions)
    for name in ("desc", "num_updates", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t_ref.pos.numpy(), ref["pos"])     # input unchanged
    if duplicates:
        ok = match_mask & query["valid"]
        for r in [3, 40]:
            rows = np.nonzero(ok & (match_row == r))[0]
            if ref["valid"][r] and len(rows) > 1:
                np.testing.assert_array_equal(t.desc[r].numpy(), query["desc"][rows[-1]])


def test_transform_matches_jax(rng):
    a = _arena_numpy(rng, 32, 20)
    T = _exp([0.5, 0.1, -0.2, 0.1, -0.2, 0.3])
    j = jlm.transform(jlm.LandmarkArena(**{k: jnp.asarray(v) for k, v in a.items()}),
                      jnp.asarray(T))
    t = tlm.transform(tlm.LandmarkArena(**{k: torch.from_numpy(v) for k, v in a.items()}),
                      torch.from_numpy(T))
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=1e-5)
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), atol=1e-7)
