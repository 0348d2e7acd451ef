"""Pose-graph growth, ring eviction and checkpoints of a meshed GraphSLAM
(2 gloo CPU ranks) against the port's unmeshed run and the JAX package's
meshed run.

* growth: tests/test_torch_slam.py's relocalise walk from
  ``max_local_maps=2, max_edges=2`` (11 maps, 12 closures, 4
  relocalisations): the graph doubles to 16 poses and 32 edges, each
  growth regathering and resharding the factors;
* eviction: its closure walk with a two-slot ring (``database_capacity``
  1024 at 512 rows per map): 2 evictions, each a slot rewritten stripe by
  stripe.

Both per frame and through the chunk program (chunks of 4), on the same
two ranks.  Bounds: against the unmeshed run, per-frame status and map,
the counters, closure events, rollbacks and replays equal and every pose
within 1e-4 m (3e-7 seen: the factors' partial normal equations sum in
another order); against the JAX package's meshed run per frame, the
counters equal and the trajectory within 1e-4.  ``checkpoint.save`` of
the meshed growth session (gathered, written by rank 0) equals the
unmeshed session's save: every integer and boolean array and the session
metadata equal, every float array within 1e-5; it loads back into a
meshed GraphSLAM with the same graph, ring and tracker state.  Each rank's
report is a case of its own.
"""
import json
import threading
from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from srrg2_proslam_tpu import parallel as jpar  # noqa: E402
from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402

from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.parallel import checks, launch, spmd  # noqa: E402
from tests.test_torch_slam import CAM, _config, _scenario  # noqa: E402

CASES = {"growth": ("relocalize", dict(max_local_maps=2, max_edges=2)),
         "eviction": ("closure", dict(database_capacity=1024, max_db_descriptors_per_map=512))}
RUNS = [(case, chunk) for case in CASES for chunk in (0, 4)]
POSE_TOL = 1e-4


def _kw(case, chunk=0):
    name, extra = CASES[case]
    frames, kw = _scenario(name)
    return frames, dict(kw, **extra, chunk_size=chunk)


def _spec(case, chunk, checkpoint=None):
    frames, kw = _kw(case, chunk)
    stacks = tuple(np.stack([f[k] for f in frames]) for k in range(3))
    return dict(cam=CAM, config=_config(ts, LoopDetectorConfig, kw),
                mode="sequence" if chunk else "frame", checkpoint=checkpoint,
                frames=("meas",) + stacks + ([f[3] for f in frames],))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


def _saves(case, chunk, path) -> str | None:
    """The per-frame growth run saves a checkpoint to ``path``."""
    return str(path) if (case, chunk) == ("growth", 0) else None


@pytest.fixture(scope="module")
def meshed(ckpt_dir):
    """{(case, chunk): both ranks' reports}; the per-frame growth runs save
    a checkpoint.  The reference runs the tests read (``_jax_meshed`` and
    ``_unmeshed``, cached) go on in two threads of this process meanwhile:
    the ranks are processes of their own.  A failed reference run raises
    again in the test that reads it."""
    specs = [_spec(case, chunk, _saves(case, chunk, ckpt_dir / "meshed.npz"))
             for case, chunk in RUNS]
    references = [threading.Thread(target=lambda: [_jax_meshed(case) for case in CASES]),
                  threading.Thread(target=lambda: [
                      _unmeshed(*run, _saves(*run, ckpt_dir / "plain.npz")) for run in RUNS])]
    for thread in references:
        thread.start()
    try:
        reports = launch.run(checks.slam_runs, 2, specs, device="cpu")
    finally:
        for thread in references:
            thread.join()
    return {run: [rank[i] for rank in reports] for i, run in enumerate(RUNS)}


@lru_cache(maxsize=None)
def _unmeshed(case, chunk, checkpoint=None):
    """The port's unmeshed run; saving a checkpoint after it leaves its
    report as it is and adds ``resumed_equal``."""
    one = spmd.Mesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    return checks.slam_run(one, dict(_spec(case, chunk, checkpoint), meshed=False))


@lru_cache(maxsize=None)
def _jax_meshed(case):
    frames, kw = _kw(case)
    slam = js.GraphSLAM(CAM, _config(js, JLoopCfg, kw), mesh=jpar.make_mesh(jax.devices()[:2]))
    for p, d, ok, stamp in frames:
        slam.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
    slam.flush()
    return dict(counters={k: getattr(slam, k) for k in checks.COUNTERS},
                capacities=(slam.graph.capacity, slam.graph.edge_capacity),
                trajectory=np.stack(slam.trajectory()))


RANK_RUNS = [(case, chunk, rank) for case, chunk in RUNS for rank in range(2)]


@pytest.mark.parametrize("case,chunk,rank", RANK_RUNS,
                         ids=[f"{c}-chunk{k}-rank{r}" for c, k, r in RANK_RUNS])
def test_meshed_growth_and_eviction_equal_unmeshed(meshed, ckpt_dir, case, chunk, rank):
    ref = _unmeshed(case, chunk, _saves(case, chunk, ckpt_dir / "plain.npz"))
    if case == "growth":
        assert ref["counters"]["num_maps"] > 2 and ref["counters"]["num_relocalizations"] >= 1
    else:
        assert ref["counters"]["num_db_evictions"] >= 1
    got = meshed[(case, chunk)][rank]
    assert got["rank"] == rank
    diff = checks.compare_slam(got, ref, POSE_TOL, replays=True)
    print(f"{case} chunk {chunk} rank {rank}: largest pose difference {diff:.3e} m")


@pytest.mark.parametrize("case,rank", [(c, r) for c in CASES for r in range(2)],
                         ids=[f"{c}-rank{r}" for c in CASES for r in range(2)])
def test_meshed_growth_and_eviction_agree_with_jax_mesh(meshed, case, rank):
    ref = _jax_meshed(case)
    got = meshed[(case, 0)][rank]
    assert got["counters"] == ref["counters"]
    diff = float(np.abs(got["trajectory"] - ref["trajectory"]).max())
    print(f"{case} rank {rank}: port meshed vs JAX meshed trajectory max |diff| {diff:.3e}, "
          f"JAX graph capacities {ref['capacities']}")
    assert diff <= POSE_TOL


def test_meshed_checkpoint_equals_unmeshed_save(meshed, ckpt_dir):
    assert all(rank["resumed_equal"] for rank in meshed[("growth", 0)])
    plain = _unmeshed("growth", 0, _saves("growth", 0, ckpt_dir / "plain.npz"))
    assert plain["resumed_equal"]
    got, ref = np.load(ckpt_dir / "meshed.npz"), np.load(ckpt_dir / "plain.npz")
    assert sorted(got.files) == sorted(ref.files)
    meta_g, meta_r = (json.loads(bytes(f["_meta_json"]).decode()) for f in (got, ref))
    frames_g, frames_r = meta_g.pop("frames"), meta_r.pop("frames")
    assert meta_g == meta_r and meta_g["graph_capacity"] == [16, 32]
    np.testing.assert_allclose([f["T_lm_robot"] for f in frames_g],
                               [f["T_lm_robot"] for f in frames_r], atol=1e-5)
    for key in set(ref.files) - {"_meta_json"}:
        a, b = got[key], ref[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
