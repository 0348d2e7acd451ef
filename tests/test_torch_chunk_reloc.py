"""The port's chunk program on the ``relocalize`` stream (relocalisations
into maps whose arenas were moved off the device), in chunks of 4 and 8,
== its synchronous per-frame loop, and agrees with the JAX package's
per-frame loop, on the CPU.  The ``rollback`` stream is in
tests/test_torch_chunk_rollback.py; the rest of the chunk program's
streams, the bounds and the unit cases in tests/test_torch_chunk.py (one
file per stream, so that each stays under a minute alone).
"""
import pytest

from tests.test_torch_chunk import check_exact, check_jax, ids

CASES = [("relocalize", 4, 1), ("relocalize", 8, 1)]


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_equals_synchronous_loop(name, size, group):
    check_exact(name, size, group)


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_agrees_with_jax_per_frame(name, size, group):
    check_jax(name, size, group)
