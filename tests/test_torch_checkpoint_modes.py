"""The port's checkpoints on the RGB-D stream with the smoother and local
BA, and at speculation depth 8 saved with frames in the queue: the resumed
run equals the uninterrupted one bit for bit and agrees with JAX's within
1e-5.  Streams, runs and bounds are tests/test_torch_checkpoint.py's.
"""
import pytest

from tests.test_torch_checkpoint import check_jax, check_resumed, checkpoint_runs

SCENARIOS = ("rgbd_smoother_ba", "speculation")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return checkpoint_runs(SCENARIOS, tmp_path_factory)


@pytest.mark.parametrize("name", SCENARIOS)
def test_resumed_run_equals_uninterrupted(runs, name):
    check_resumed(runs[name], name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_resumed_run_agrees_with_jax(runs, name):
    check_jax(runs[name])
