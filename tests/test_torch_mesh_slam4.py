"""tests/test_torch_mesh_slam.py's cases on 4 gloo CPU ranks: the meshed
port equals its unmeshed run and agrees with the JAX package's meshed run
on 4 virtual CPU devices, per frame and in chunks of 4 (bounds there)."""
import pytest

from tests.test_torch_mesh_slam import CHUNKS, check_jax_mesh, check_unmeshed

CASES = [(4, c) for c in CHUNKS]
IDS = [f"world{w}-chunk{c}" for w, c in CASES]


@pytest.mark.parametrize("world,chunk", CASES, ids=IDS)
def test_meshed_slam_equals_unmeshed(world, chunk):
    check_unmeshed(world, chunk)


@pytest.mark.parametrize("world,chunk", CASES, ids=IDS)
def test_meshed_slam_agrees_with_jax_mesh(world, chunk):
    check_jax_mesh(world, chunk)
