"""The multi-GPU slice on the card (skipped without one): the dry runs and
one chunk of the rendered loop at world size 2 against world size 1.

* ``entry.dryrun_multichip(1)`` (one rank over NCCL) and
  ``dryrun_multichip(2)`` (two ranks sharing the card over gloo): every
  sharded stage equal to its single-rank call on the card
  (parallel/checks.py::check_stages: keys, matches and counts bit for bit,
  floats within FLOAT_TOL) and the short meshed chunk-program run equal to
  the unmeshed one;
* the rendered loop's first 16 frames (one chunk, chunk_size 16) through
  ``GraphSLAM(mesh=...).process_sequence`` at world size 2 equal to the
  unmeshed run on the card: per-frame status and map, counters, every pose
  within 1e-4 m, and each rank's K3 / K1 / K2 launches those of one
  adapted chunk and one captured chunk graph (its warm-up and a replay).

Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh_cuda.py`` (the conftest imports JAX, which the card
machine need not have).
"""
import pytest
import torch

from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig
from srrg2_proslam_tpu_torch.models.slam import GraphSLAMConfig, SplittingConfig
from srrg2_proslam_tpu_torch.parallel import checks, launch

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("n,backend", [(1, "nccl"), (2, "gloo")])
def test_dryrun_multichip_on_the_card(n, backend):
    from srrg2_proslam_tpu_torch.entry import dryrun_multichip

    reports = dryrun_multichip(n)
    assert [r["backend"] for r in reports] == [backend] * n
    assert all(r["device"].startswith("cuda") for r in reports)
    for r in reports:
        checks.check_stages(r)


def test_one_chunk_of_the_loop_at_world_size_2_equals_world_size_1():
    config = GraphSLAMConfig(
        splitting=SplittingConfig(maximum_translation_m=4.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=3), arena_capacity=4096,
        database_capacity=8192, max_db_descriptors_per_map=384, chunk_size=16)
    spec = dict(config=config, mode="sequence",
                frames=("loop", dict(count=16, side_a=10.0, side_b=6.0, step_m=0.4,
                                     turn_frames=10)))
    one = launch.run(checks.slam_run, 1, spec)[0]
    two = launch.run(checks.slam_run, 2, spec)
    for rank in [one] + two:
        checks.compare_slam(rank, one, checks.SLAM_POSE_TOL, replays=True)
        st = rank["chunk_stats"]
        assert st["graph_replays"] == 1 and rank["warm_frames"] == 16
        assert rank["launches"] == {"fast": 1, "brief": 1,
                                    "gn_burst": 3 * (st["tracker_steps"] + 16)}
