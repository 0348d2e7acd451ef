"""``GraphSLAM(mesh=...)`` of the port == its unmeshed run, and agrees with
the JAX package's meshed run, on the CPU: the port of
tests/test_mesh_orchestrator.py.

The out-and-back walk of tests/test_speculation.py (splits, closures,
relocalisations) at tests/test_mesh_orchestrator.py's config runs per
frame (``process`` + ``flush``, chunk 0) and through the chunk program
(``process_meas_sequence``, chunk 4) on 2 gloo CPU ranks here and on 4 in
tests/test_torch_mesh_slam4.py (the same cases; two files, so that each
stays well under a minute and the two can run side by side), through
parallel/launch.py: each rank a spawned process, both chunk modes on the
same ranks.  Every rank is held to:

* the port's unmeshed run of the same frames (one run, shared by the two
  files): per-frame status and local
  map, map, edge, closure, relocalisation, loss and eviction counts,
  closure events, relocalisation rollbacks and replays equal, every pose
  within 1e-4 m (equal bit for bit in the runs seen);
* the JAX package's meshed run on as many of the conftest's virtual CPU
  devices: maps, closures, relocalisations, rollbacks and replays equal,
  the trajectory within 1e-4 (tests/test_mesh_orchestrator.py:73; the
  largest difference seen is printed).

Each rank's report is a case of its own (the ranks run once per world
size, cached).

A ring budget or an edge capacity that the mesh size does not divide
raises the JAX package's ValueError.
"""
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
from tests.test_slam import CAM as JCAM  # noqa: E402
from tests.test_speculation import _frames_out_and_back  # noqa: E402

from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.parallel import checks, launch, spmd  # noqa: E402
from tests.test_torch_slam import CAM, _config  # noqa: E402
from tests.torch_shared import digest, shared  # noqa: E402

# tests/test_mesh_orchestrator.py::_config
KW = dict(splitting=dict(maximum_translation_m=1.2), loop=dict(minimum_age_difference=1),
          arena_capacity=512, database_capacity=2048, max_db_descriptors_per_map=256,
          max_local_maps=64, max_edges=256, enable_loop_closing=True)
CHUNKS = (0, 4)
POSE_TOL = 1e-4


@lru_cache(maxsize=None)
def _frames():
    """The walk as numpy stacks (points, desc, valid) and timestamps."""
    frames = _frames_out_and_back(np.random.RandomState(0))
    stacks = tuple(np.stack([np.asarray(f[k]) for f in frames]) for k in range(3))
    return stacks, [0.1 * i for i in range(len(frames))]


def _spec(chunk):
    stacks, stamps = _frames()
    return dict(cam=CAM, config=_config(ts, LoopDetectorConfig, dict(KW, chunk_size=chunk)),
                mode="sequence" if chunk else "frame", frames=("meas",) + stacks + (stamps,))


@lru_cache(maxsize=None)
def _meshed(world):
    """Every rank's report, for each chunk size.  The reference runs the
    tests read (``_jax_meshed`` at this world size and ``_unmeshed``,
    cached) go on in two threads of this process meanwhile: the ranks are
    processes of their own.  A failed reference run raises again in the
    test that reads it."""
    references = [threading.Thread(target=lambda: [_jax_meshed(world, c) for c in CHUNKS]),
                  threading.Thread(target=lambda: [_unmeshed(c) for c in CHUNKS])]
    for thread in references:
        thread.start()
    try:
        reports = launch.run(checks.slam_runs, world, [_spec(c) for c in CHUNKS],
                             device="cpu")
    finally:
        for thread in references:
            thread.join()
    return {c: [rank[i] for rank in reports] for i, c in enumerate(CHUNKS)}


@lru_cache(maxsize=None)
def _unmeshed(chunk):
    """The port's unmeshed run, shared with tests/test_torch_mesh_slam4.py
    (tests/torch_shared.py)."""
    def run():
        one = spmd.Mesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
        return checks.slam_run(one, dict(_spec(chunk), meshed=False))
    return shared(digest("mesh_slam_unmeshed", chunk, repr(KW)), run)


@lru_cache(maxsize=None)
def _jax_meshed(world, chunk):
    (points, desc, valid), stamps = _frames()
    mesh = jpar.make_mesh(jax.devices()[:world])
    slam = js.GraphSLAM(JCAM, _config(js, JLoopCfg, dict(KW, chunk_size=chunk)), mesh=mesh)
    if chunk:
        slam.process_meas_sequence(jnp.asarray(points), jnp.asarray(desc), jnp.asarray(valid),
                                   stamps)
    else:
        for i in range(len(stamps)):
            slam.process(jnp.asarray(points[i]), jnp.asarray(desc[i]), jnp.asarray(valid[i]),
                         timestamp=stamps[i])
        slam.flush()
    return dict(counts=(slam.num_maps, slam.num_closures, slam.num_relocalizations,
                        slam.num_reloc_rollbacks, slam.num_reloc_replays),
                trajectory=np.stack(slam.trajectory()))


def rank_cases(worlds):
    """(world, chunk, rank) for every rank: each rank's report is a case."""
    return [(w, c, r) for w in worlds for c in CHUNKS for r in range(w)]


def ids(cases):
    return [f"world{w}-chunk{c}-rank{r}" for w, c, r in cases]


def check_unmeshed(world, chunk, rank):
    ref = _unmeshed(chunk)
    assert ref["counters"]["num_closures"] >= 1 and ref["counters"]["num_relocalizations"] >= 1
    got = _meshed(world)[chunk][rank]
    assert got["rank"] == rank
    diff = checks.compare_slam(got, ref, POSE_TOL, replays=True)
    print(f"world {world} chunk {chunk} rank {rank}: largest pose difference "
          f"to the unmeshed run {diff:.3e} m")
    assert got["size"] == world and got["collectives"]["ring"][0] > 0
    assert got["collectives"]["pgo"][0] > 0


def check_jax_mesh(world, chunk, rank):
    ref = _jax_meshed(world, chunk)
    got = _meshed(world)[chunk][rank]
    c = got["counters"]
    assert (c["num_maps"], c["num_closures"], c["num_relocalizations"]) + got["recovery"] \
        == ref["counts"]
    diff = float(np.abs(got["trajectory"] - ref["trajectory"]).max())
    print(f"world {world} chunk {chunk} rank {rank}: port meshed vs JAX meshed trajectory max "
          f"|diff| {diff:.3e}")
    assert diff <= POSE_TOL


CASES = rank_cases((2,))


@pytest.mark.parametrize("world,chunk,rank", CASES, ids=ids(CASES))
def test_meshed_slam_equals_unmeshed(world, chunk, rank):
    check_unmeshed(world, chunk, rank)


@pytest.mark.parametrize("world,chunk,rank", CASES, ids=ids(CASES))
def test_meshed_slam_agrees_with_jax_mesh(world, chunk, rank):
    check_jax_mesh(world, chunk, rank)


@pytest.mark.parametrize("field,value", [("max_db_descriptors_per_map", 67),
                                         ("max_edges", 67)])
def test_mesh_divisibility_is_validated(field, value):
    """The JAX package's messages, at world size 2 (the check runs before
    any collective, so a mesh without a process group does)."""
    mesh = spmd.Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    cfg = _config(ts, LoopDetectorConfig, dict(KW, **{field: value}))
    with pytest.raises(ValueError, match=rf"{field} \({value}\) must be divisible by the "
                                         r"mesh size \(2\)"):
        ts.GraphSLAM(CAM, cfg, mesh=mesh)
