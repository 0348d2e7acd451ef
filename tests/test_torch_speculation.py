"""The port's speculative per-frame queue at depth 8 and its chunk program
(``process_meas_sequence`` in chunks of 4) == its synchronous per-frame
loop, and agree with the JAX package's, on the streams with a Lost frame
and with a relocalisation (tests/test_torch_slam.py).

The bounds and the runs are those of tests/test_torch_sequence.py, which
takes the closure and ring-eviction streams: exact equality between the
port's runs, and against JAX the per-frame status and local map,
counters and closure events equal, every pose within 1e-5.
"""
import pytest

from tests.test_torch_sequence import check_jax, check_sequence, scenario_runs

SCENARIOS = ("lost", "relocalize")


@pytest.fixture(scope="module")
def runs():
    return scenario_runs(SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_sequence_equals_synchronous_loop(runs, name):
    check_sequence(runs[name], name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_sequence_agrees_with_jax_per_frame(runs, name):
    check_jax(runs[name], name)


def test_flush_is_idempotent(runs):
    slam = runs["relocalize"]["speculative_slam"]
    n, maps = len(slam.frames), slam.num_maps
    for _ in range(2):
        slam.flush()
    assert len(slam.frames) == n and slam.num_maps == maps and not slam._queue
