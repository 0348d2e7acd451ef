"""tests/test_torch_mesh_slam.py's cases on 4 gloo CPU ranks: the meshed
port equals its unmeshed run and agrees with the JAX package's meshed run
on 4 virtual CPU devices, per frame and in chunks of 4, each rank a case
(bounds there)."""
import pytest

from tests.test_torch_mesh_slam import check_jax_mesh, check_unmeshed, ids, rank_cases

CASES = rank_cases((4,))


@pytest.mark.parametrize("world,chunk,rank", CASES, ids=ids(CASES))
def test_meshed_slam_equals_unmeshed(world, chunk, rank):
    check_unmeshed(world, chunk, rank)


@pytest.mark.parametrize("world,chunk,rank", CASES, ids=ids(CASES))
def test_meshed_slam_agrees_with_jax_mesh(world, chunk, rank):
    check_jax_mesh(world, chunk, rank)
